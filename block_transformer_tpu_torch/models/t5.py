"""T5 encoder and decoder stacks (port of
``block_transformer_tpu/models/t5.py``).

HF ``T5Stack`` numerics: float32 RMSNorm (pre-LN, no bias), bias-free
linears, a relative-position-bucket attention bias computed once and shared
down the stack, no ``1/sqrt(d)`` score scaling, ReLU MLP (t5-base v1.0).
Serves the ``t5`` embedder (the encoder over the block's tokens, then the
projection) and the ``t5`` token decoder, whose cross-attention attends to
the expanded block embeddings (the ``cross_attention`` strategy) and whose
tied head rescales by ``d_model^-0.5``.

The biases are float32 sums of ``-1e30`` terms (padding, causal), as in the
JAX package, and the bucket table is computed on the CPU whatever the
device, so that the card and the CPU index the same buckets.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from block_transformer_tpu_torch.models.neox import layer_view
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops.masks import NEG_INF


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    bos_token_id: int = 0  # decoder_start_token_id


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def relative_position_bucket(rel_pos: torch.Tensor, bidirectional: bool,
                             num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF T5 ``_relative_position_bucket``: exact buckets for distances
    below half the buckets, log-spaced ones up to ``max_distance``, in the
    JAX package's float32 arithmetic."""
    n = -rel_pos
    ret = torch.zeros_like(rel_pos)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel_pos.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    log_ratio = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32))
    large = max_exact + (torch.log(n.float() / max_exact + 1e-9) / log_ratio
                         * (num_buckets - max_exact)).to(rel_pos.dtype)
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


def init_t5_stack_params(gen: torch.Generator, cfg: T5Config, *,
                         is_decoder: bool, with_embed: bool = True,
                         dtype=torch.float32, device="cuda"):
    """Kernels N(0, fan_in^-0.5) (the relative-bias table d_model^-0.5, the
    embedding N(0, 1)) drawn from ``gen``; norm scales one."""
    d, inner, L = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.num_layers

    def normal(std, *shape):
        return (std * torch.randn(shape, generator=gen, dtype=torch.float32,
                                  device=device)).to(dtype)

    def dense(k, n):
        return {"kernel": normal(k ** -0.5, L, k, n)}

    def attn():
        return {"q": dense(d, inner), "k": dense(d, inner),
                "v": dense(d, inner), "o": dense(inner, d)}

    def norm(*lead):
        return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}

    layers = {"self_attn": attn(), "self_ln": norm(L),
              "mlp": {"wi": dense(d, cfg.d_ff), "wo": dense(cfg.d_ff, d)},
              "mlp_ln": norm(L)}
    if is_decoder:
        layers["cross_attn"] = attn()
        layers["cross_ln"] = norm(L)
    params = {"layers": layers,
              "rel_bias": {"weight": normal(
                  d ** -0.5, cfg.relative_attention_num_buckets,
                  cfg.num_heads)},
              "final_ln": norm()}
    if with_embed:
        params["embed"] = {"weight": normal(1.0, cfg.vocab_size, d)}
    return params


def _mha(x_q, x_kv, p, cfg: T5Config, bias) -> torch.Tensor:
    """T5 attention: no score scaling, no biases. bias: [B or 1, H, Q, K]
    float32."""
    B, Q, _ = x_q.shape
    H, D = cfg.num_heads, cfg.d_kv

    def proj(x, w):
        y = linear_ops.apply_linear(x, w)
        return y.reshape(x.shape[0], -1, H, D).transpose(1, 2)

    q, k, v = proj(x_q, p["q"]), proj(x_kv, p["k"]), proj(x_kv, p["v"])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores + bias, dim=-1).to(x_q.dtype)
    ctx = torch.matmul(probs.float(), v.float()).to(x_q.dtype)
    return linear_ops.apply_linear(ctx.transpose(1, 2).reshape(B, Q, H * D),
                                   p["o"])


def _pad_bias(valid: torch.Tensor) -> torch.Tensor:
    """[B, K] -> float32 [B, 1, 1, K]: 0 where valid, -1e30 elsewhere."""
    return torch.where(valid[:, None, None, :] != 0, 0.0,
                       NEG_INF).to(torch.float32)


def t5_stack(params, cfg: T5Config, *, input_ids=None, inputs_embeds=None,
             attention_mask=None, is_decoder: bool,
             encoder_hidden_states=None,
             encoder_attention_mask=None) -> torch.Tensor:
    """A T5 encoder or decoder stack over ids [B, S] (or ``inputs_embeds``
    [B, S, d]); the decoder is causal and, given ``encoder_hidden_states``,
    cross-attends to them. Returns the final-normed hidden [B, S, d]."""
    x = (params["embed"]["weight"][input_ids] if inputs_embeds is None
         else inputs_embeds)
    B, S, _ = x.shape
    dev = x.device
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    pos = torch.arange(S)
    buckets = relative_position_bucket(
        pos[None, :] - pos[:, None], bidirectional=not is_decoder,
        num_buckets=cfg.relative_attention_num_buckets,
        max_distance=cfg.relative_attention_max_distance).to(dev)
    pos_bias = params["rel_bias"]["weight"][buckets].permute(2, 0, 1)[None]
    self_bias = pos_bias.float() + _pad_bias(attention_mask)   # [B, H, S, S]
    if is_decoder:
        causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
        self_bias = self_bias + torch.where(causal, 0.0, NEG_INF).to(
            torch.float32)[None, None]
    cross = is_decoder and encoder_hidden_states is not None
    if cross:
        if encoder_attention_mask is None:
            encoder_attention_mask = torch.ones(
                encoder_hidden_states.shape[:2], dtype=torch.int32,
                device=dev)
        cross_bias = _pad_bias(encoder_attention_mask)
    eps = cfg.layer_norm_eps
    dense = linear_ops.apply_linear
    h = x
    for i in range(cfg.num_layers):
        p = layer_view(params["layers"], i)
        normed = rms_norm(h, p["self_ln"]["scale"], eps)
        h = h + _mha(normed, normed, p["self_attn"], cfg, self_bias)
        if cross:
            h = h + _mha(rms_norm(h, p["cross_ln"]["scale"], eps),
                         encoder_hidden_states, p["cross_attn"], cfg,
                         cross_bias)
        m = rms_norm(h, p["mlp_ln"]["scale"], eps)
        h = h + dense(torch.relu(dense(m, p["mlp"]["wi"])), p["mlp"]["wo"])
    return rms_norm(h, params["final_ln"]["scale"], eps)


def t5_lm_logits(params, cfg: T5Config, hidden) -> torch.Tensor:
    """Float32 logits: the tied head with the ``d_model^-0.5`` rescale, or
    an untied ``lm_head``."""
    if cfg.tie_word_embeddings:
        hidden = hidden * (cfg.d_model ** -0.5)
        return torch.matmul(hidden.float(),
                            params["embed"]["weight"].float().t())
    return linear_ops.apply_linear(hidden, params["lm_head"]).float()
