"""GPT-Neo stack and its block / token decoders (port of
``block_transformer_tpu/models/gpt_neo.py``).

HF ``GPTNeoForCausalLM`` numerics: learned absolute positions, pre-LN
blocks with serial residuals, bias-free Q/K/V (the output projection and
the MLP have biases), **unscaled** float32 attention scores, tanh GELU
("gelu_new"), a tied LM head, and global and local attention layers (a
local layer sees the band ``(q - window, q]`` of the mask's indices, so
block indices in the block decoder).

``gpt_neo_stack_cached`` writes each layer's K/V into a bf16 / float32
``neox.KVCache`` in place at ``cache.length``, as the NeoX cached stack
does, and attends to the layer's whole cache under the mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import masks as masks_lib


@dataclass(frozen=True)
class GPTNeoConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 2048
    window_size: int = 256
    attention_layers: Tuple[str, ...] = ()   # per layer "global" / "local";
    # empty: alternate, starting with global (HF attention_types)
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    bos_token_id: int = 50256
    eos_token_id: int = 50256
    pad_token_id: int = 50256

    def layer_types(self):
        if self.attention_layers:
            return self.attention_layers
        return tuple("global" if i % 2 == 0 else "local"
                     for i in range(self.num_layers))


def init_gpt_neo_params(gen: torch.Generator, cfg: GPTNeoConfig, *,
                        with_embed: bool = True, with_lm_head: bool = True,
                        dtype=torch.float32, device="cuda"):
    """Weights N(0, initializer_range) drawn from ``gen``; biases zero, norm
    scales one. The head is tied to ``wte``, so ``with_lm_head`` adds
    nothing."""
    del with_lm_head
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    std = cfg.initializer_range

    def normal(*shape):
        return (std * torch.randn(shape, generator=gen, dtype=torch.float32,
                                  device=device)).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def dense(k, n, bias=True):
        p = {"kernel": normal(L, k, n)}
        if bias:
            p["bias"] = zeros(L, n)
        return p

    def ln(*lead):
        return {"scale": torch.ones((*lead, h), dtype=dtype, device=device),
                "bias": zeros(*lead, h)}

    params = {
        "layers": {
            "ln1": ln(L), "ln2": ln(L),
            "attn": {"q": dense(h, h, bias=False),
                     "k": dense(h, h, bias=False),
                     "v": dense(h, h, bias=False), "out": dense(h, h)},
            "mlp": {"up": dense(h, m), "down": dense(m, h)},
        },
        "final_ln": ln(),
    }
    if with_embed:
        params["wte"] = {"weight": normal(cfg.vocab_size, h)}
        params["wpe"] = {"weight": normal(cfg.max_position_embeddings, h)}
    return params


def _biases(mask: masks_lib.AttnMask, window: int):
    """(global, local) float32 biases [B or 1, 1, Q, K]: 0 where the mask
    allows a key (and, for local layers, the key lies in (q - window, q]),
    -1e30 elsewhere."""
    ok = mask.allowed()
    q_idx = mask.q_idx if mask.q_idx.dim() == 2 else mask.q_idx[None]
    diff = q_idx[:, :, None] - mask.kv_idx[None, None, :]
    local = ok & (diff >= 0) & (diff < window)
    return tuple(torch.where(a, 0.0, masks_lib.NEG_INF).to(torch.float32)[
        :, None] for a in (ok, local))


def _layer(p, h, cfg: GPTNeoConfig, bias, cache=None, layer: int = 0):
    """One block. With a cache, the new K/V go into layer ``layer`` at
    ``cache.length`` and the block attends to that layer's whole cache;
    without one, to its own K/V."""
    B, S, _ = h.shape
    H = cfg.num_heads
    D = cfg.hidden_size // H
    dense = linear_ops.apply_linear
    a_in = neox.layer_norm(h, p["ln1"], cfg.layer_norm_eps)

    def proj(name):
        return dense(a_in, p["attn"][name]).reshape(B, S, H, D).transpose(1, 2)

    q, k, v = proj("q"), proj("k"), proj("v")
    if cache is not None:
        neox._write_layer(cache, layer, cache.length, k, v)
        k, v = cache.k[layer], cache.v[layer]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))  # unscaled
    probs = torch.softmax(scores + bias, dim=-1).to(h.dtype)
    ctx = torch.matmul(probs.float(), v.to(h.dtype).float()).to(h.dtype)
    h = h + dense(ctx.transpose(1, 2).reshape(B, S, H * D), p["attn"]["out"])
    m_in = neox.layer_norm(h, p["ln2"], cfg.layer_norm_eps)
    mlp = dense(F.gelu(dense(m_in, p["mlp"]["up"]), approximate="tanh"),
                p["mlp"]["down"])
    return h + mlp


def gpt_neo_stack(params, cfg: GPTNeoConfig, x: torch.Tensor,
                  mask: masks_lib.AttnMask, positions) -> torch.Tensor:
    """x [B, S, h] (positions already added by the caller) -> final-normed
    hidden [B, S, h]."""
    del positions
    bias_global, bias_local = _biases(mask, cfg.window_size)
    h = x
    for i, kind in enumerate(cfg.layer_types()):
        h = _layer(neox.layer_view(params["layers"], i), h, cfg,
                   bias_local if kind == "local" else bias_global)
    return neox.layer_norm(h, params["final_ln"], cfg.layer_norm_eps)


def gpt_neo_forward(params, cfg: GPTNeoConfig, input_ids,
                    attention_mask=None) -> torch.Tensor:
    """The plain GPT-Neo LM: ids [B, S] -> float32 logits [B, S, V] (tied
    head)."""
    S = input_ids.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=input_ids.device)
    x = params["wte"]["weight"][input_ids] + params["wpe"]["weight"][pos][None]
    mask = masks_lib.causal_mask(pos, pos, kv_valid=attention_mask)
    h = gpt_neo_stack(params, cfg, x, mask, pos)
    return torch.matmul(h.float(), params["wte"]["weight"].float().t())


def gpt_neo_stack_cached(params, cfg: GPTNeoConfig, x: torch.Tensor,
                         mask: masks_lib.AttnMask, positions,
                         cache: neox.KVCache):
    """The stack over x [B, S, h] (learned positions already added) with a
    bf16 / float32 cache: each layer writes its K/V at ``cache.length`` in
    place and attends to its whole cache; the mask's index vectors span
    the capacity. Returns (final-normed hidden, cache with length + S)."""
    del positions
    if not isinstance(cache, neox.KVCache):
        raise TypeError(f"gpt_neo_stack_cached: a bf16 / float32 KVCache, "
                        f"not {type(cache).__name__}")
    S = x.shape[1]
    neox._check_room(cache, S, cache.length)
    bias_global, bias_local = _biases(mask, cfg.window_size)
    h = x
    for i, kind in enumerate(cfg.layer_types()):
        h = _layer(neox.layer_view(params["layers"], i), h, cfg,
                   bias_local if kind == "local" else bias_global, cache, i)
    h = neox.layer_norm(h, params["final_ln"], cfg.layer_norm_eps)
    return h, cache._replace(length=cache.length + S)


# ---------------------------------------------------------------------------
# Block / token decoder variants
# ---------------------------------------------------------------------------

def gpt_neo_block_decoder_forward(params, cfg: GPTNeoConfig, inputs_embeds,
                                  block_attention_mask,
                                  n_embedding_tokens: int) -> torch.Tensor:
    """The block decoder: block embeddings plus learned positions under the
    block-causal mask (local layers: a band of ``window_size`` blocks)."""
    S = inputs_embeds.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=inputs_embeds.device)
    x = inputs_embeds + params["wpe"]["weight"][pos][None].to(
        inputs_embeds.dtype)
    mask = masks_lib.block_decoder_train_mask(block_attention_mask,
                                              n_embedding_tokens)
    return gpt_neo_stack(params, cfg, x, mask, pos)


def gpt_neo_token_decoder_forward(params, cfg: GPTNeoConfig, inputs_embeds,
                                  mask: masks_lib.AttnMask) -> torch.Tensor:
    """The token decoder's stack: adapted input embeddings plus learned
    positions -> hidden."""
    S = inputs_embeds.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=inputs_embeds.device)
    x = inputs_embeds + params["wpe"]["weight"][pos][None].to(
        inputs_embeds.dtype)
    return gpt_neo_stack(params, cfg, x, mask, pos)
