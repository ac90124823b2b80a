"""RoBERTa encoder stack and the RoBERTa embedders (port of
``block_transformer_tpu/models/roberta.py``).

Post-LN encoder blocks, learned absolute positions with RoBERTa's
``padding_idx + 1`` offset, exact (erf) GELU, bidirectional attention over
the block's tokens with padding masked. Serves the ablation embedders:

- ``roberta``: the encoder over the block's tokens, then the projection
  (concat or strided conv);
- ``roberta_cls``: ``n_cls_tokens`` learned CLS rows are prepended and only
  their hidden states become the block embedding.

Parameters keep the JAX tree's layout: ``[in, out]`` kernels, layers
stacked on a leading ``[L, ...]`` axis (``neox.layer_view`` hands each
linear to ``apply_linear`` as a ``StackedLinear``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from block_transformer_tpu_torch.config import EmbedderConfig
from block_transformer_tpu_torch.models.neox import layer_norm, layer_view
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops.masks import NEG_INF


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    pad_token_id: int = 1


def init_roberta_params(gen: torch.Generator, cfg: RobertaConfig,
                        dtype=torch.float32, device="cuda"):
    """Dense weights and embedding tables N(0, initializer_range) drawn from
    ``gen``; biases zero, layer-norm scales one."""
    std, h, m, L = (cfg.initializer_range, cfg.hidden_size,
                    cfg.intermediate_size, cfg.num_layers)

    def normal(*shape):
        return (std * torch.randn(shape, generator=gen, dtype=torch.float32,
                                  device=device)).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def dense(k, n):
        return {"kernel": normal(L, k, n), "bias": zeros(L, n)}

    def ln(*lead):
        return {"scale": torch.ones((*lead, h), dtype=dtype, device=device),
                "bias": zeros(*lead, h)}

    return {
        "word_embeddings": {"weight": normal(cfg.vocab_size, h)},
        "position_embeddings": {"weight": normal(cfg.max_position_embeddings,
                                                 h)},
        "token_type_embeddings": {"weight": normal(cfg.type_vocab_size, h)},
        "embed_ln": ln(),
        "layers": {
            "attn": {"q": dense(h, h), "k": dense(h, h), "v": dense(h, h),
                     "out": dense(h, h)},
            "attn_ln": ln(L),
            "mlp": {"up": dense(h, m), "down": dense(m, h)},
            "mlp_ln": ln(L),
        },
    }


def roberta_encode(params, cfg: RobertaConfig, input_ids, attention_mask=None,
                   inputs_embeds=None) -> torch.Tensor:
    """[B, S] ids (or ``inputs_embeds`` [B, S, h]) -> hidden [B, S, h].
    Position ids count the non-pad ids (or, without ids, the attended
    positions) after ``pad_token_id``, as HF's
    ``create_position_ids_from_input_ids``."""
    if inputs_embeds is None:
        x = params["word_embeddings"]["weight"][input_ids]
    else:
        x = inputs_embeds
    B, S = x.shape[:2]
    if attention_mask is None:
        attention_mask = torch.ones((B, S), dtype=torch.int32,
                                    device=x.device)
    pos_mask = (input_ids != cfg.pad_token_id if input_ids is not None
                else attention_mask != 0).to(torch.int64)
    pos_ids = torch.cumsum(pos_mask, dim=1) * pos_mask + cfg.pad_token_id
    token_type = torch.zeros((B, S), dtype=torch.int64, device=x.device)
    x = (x + params["position_embeddings"]["weight"][pos_ids]
         + params["token_type_embeddings"]["weight"][token_type])
    x = layer_norm(x, params["embed_ln"], cfg.layer_norm_eps)

    bias = torch.where(attention_mask[:, None, None, :] != 0, 0.0,
                       NEG_INF).to(torch.float32)
    H = cfg.num_heads
    D = cfg.hidden_size // H
    scale = 1.0 / torch.tensor(float(D), device=x.device).sqrt()
    dense = linear_ops.apply_linear
    h = x
    for i in range(cfg.num_layers):
        p = layer_view(params["layers"], i)

        def proj(name):
            return dense(h, p["attn"][name]).reshape(B, S, H, D).transpose(
                1, 2)

        q, k, v = proj("q"), proj("k"), proj("v")
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        probs = torch.softmax(scores + bias, dim=-1).to(h.dtype)
        ctx = torch.matmul(probs.float(), v.float()).to(h.dtype)
        ctx = ctx.transpose(1, 2).reshape(B, S, H * D)
        h = layer_norm(h + dense(ctx, p["attn"]["out"]), p["attn_ln"],
                       cfg.layer_norm_eps)
        mlp = dense(F.gelu(dense(h, p["mlp"]["up"]), approximate="none"),
                    p["mlp"]["down"])
        h = layer_norm(h + mlp, p["mlp_ln"], cfg.layer_norm_eps)
    return h


# ---------------------------------------------------------------------------
# Embedder variants
# ---------------------------------------------------------------------------

def init_roberta_embedder_params(gen: torch.Generator, rcfg: RobertaConfig,
                                 ecfg: EmbedderConfig, block_length: int,
                                 n_cls_tokens: int = 0, dtype=torch.float32,
                                 device="cuda"):
    params = {"roberta": init_roberta_params(gen, rcfg, dtype, device)}
    if n_cls_tokens:
        params["cls_embeddings"] = {"weight": (
            rcfg.initializer_range * torch.randn(
                (n_cls_tokens, rcfg.hidden_size), generator=gen,
                dtype=torch.float32, device=device)).to(dtype)}
    if ecfg.projection_method == "projection_layer":
        from block_transformer_tpu_torch.models import embedder as emb
        params["projection"] = emb.init_projection(
            gen, ecfg, n_cls_tokens or block_length, rcfg.hidden_size,
            block_length, dtype, device)
    return params


def roberta_embed_blocks(params, rcfg: RobertaConfig, ecfg: EmbedderConfig,
                         block_length: int, input_ids, attention_mask=None,
                         n_cls_tokens: int = 0) -> torch.Tensor:
    """[..., L] -> [..., n_embedding_tokens, projection_hidden_size]. With
    ``n_cls_tokens``: the CLS rows go first, attended and positioned by the
    attention mask, and only their hidden states are kept; else every
    token's."""
    from block_transformer_tpu_torch.models import embedder as emb
    lead = input_ids.shape[:-1]
    L = input_ids.shape[-1]
    ids = input_ids.reshape(-1, L)
    B = ids.shape[0]
    att = (attention_mask.reshape(-1, L) if attention_mask is not None
           else torch.ones((B, L), dtype=torch.int32, device=ids.device))
    if n_cls_tokens:
        tok = params["roberta"]["word_embeddings"]["weight"][ids]
        cls = params["cls_embeddings"]["weight"][None].expand(
            B, n_cls_tokens, tok.shape[-1]).to(tok.dtype)
        att_full = torch.cat([torch.ones((B, n_cls_tokens), dtype=att.dtype,
                                         device=att.device), att], dim=1)
        hidden = roberta_encode(params["roberta"], rcfg, None, att_full,
                                inputs_embeds=torch.cat([cls, tok], dim=1))
        hidden = hidden[:, :n_cls_tokens, :]           # CLS states only
    else:
        hidden = roberta_encode(params["roberta"], rcfg, ids, att)
    out = emb.project(params, ecfg, hidden)
    return out.reshape(*lead, *out.shape[1:])
