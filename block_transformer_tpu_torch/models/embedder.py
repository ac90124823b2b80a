"""Lookup embedder with concat projection (port of
``block_transformer_tpu/models/embedder.py``, its lookup + concat path).

Each token of a block is looked up (the pad row is zero and pad tokens are
masked to zero, ``padding_idx`` semantics) and the block's embeddings are
concatenated into ``[n_embedding_tokens, projection_hidden_size]``. The
other embedder classes and the projection layer are not ported yet.
"""

from __future__ import annotations

import torch

from block_transformer_tpu_torch.config import EmbedderConfig


def _check(cfg: EmbedderConfig) -> None:
    if cfg.cls != "lookup" or cfg.projection_method != "concat":
        raise NotImplementedError(
            f"embedder {cfg.cls!r} / {cfg.projection_method!r}: the port has "
            "the lookup embedder with concat projection only")


def init_embedder_params(gen: torch.Generator, cfg: EmbedderConfig,
                         block_length: int, dtype=torch.float32,
                         device="cuda"):
    _check(cfg)
    emb = cfg.initializer_range * torch.randn(
        (cfg.vocab_size, cfg.hidden_size), generator=gen, dtype=torch.float32,
        device=device)
    emb[cfg.pad_token_id] = 0.0                       # padding_idx row
    return {"embeddings": {"weight": emb.to(dtype)}}


def embed_blocks(params, cfg: EmbedderConfig, block_length: int,
                 input_ids: torch.Tensor, attention_mask=None) -> torch.Tensor:
    """input_ids [..., block_length] -> [..., n_embedding_tokens,
    projection_hidden_size]."""
    _check(cfg)
    lead = input_ids.shape[:-1]
    if input_ids.shape[-1] != block_length:
        raise ValueError(f"block of {input_ids.shape[-1]} tokens, "
                         f"expected {block_length}")
    h = params["embeddings"]["weight"][input_ids]      # [..., L, hidden]
    h = h.masked_fill((input_ids == cfg.pad_token_id)[..., None], 0.0)
    return h.reshape(*lead, cfg.n_embedding_tokens, cfg.projection_hidden_size)
