"""Embedders: token block -> block embedding(s) (port of
``block_transformer_tpu/models/embedder.py``).

- ``lookup``: each token of a block is looked up (the pad row is zero and
  pad tokens are masked to zero, ``padding_idx`` semantics);
- ``roberta`` / ``roberta_cls``: a RoBERTa encoder over the block's tokens,
  or over learned CLS rows put before them (``models/roberta.py``);
- ``t5``: a T5 encoder over the block's tokens (``models/t5.py``).

The hidden states of a block (its tokens', or its CLS rows') then become
``[n_embedding_tokens, projection_hidden_size]`` by **concat** (a reshape)
or by **projection_layer**: a strided Conv1d, computed as a dense layer
over each group of ``L // n`` hidden states, init std
``(hidden * block_length)^-0.5``.
"""

from __future__ import annotations

import torch

from block_transformer_tpu_torch.config import EmbedderConfig
from block_transformer_tpu_torch.models import roberta as rb
from block_transformer_tpu_torch.models import t5 as t5m


def _heads_for(hidden: int, heads) -> int:
    if heads:
        return heads
    for hd in (64, 32, 16, 8):
        if hidden % hd == 0 and hidden // hd >= 1:
            return max(1, hidden // hd)
    return 1


def _roberta_cfg(cfg: EmbedderConfig) -> rb.RobertaConfig:
    # position ids reach pad_token_id + block_length + n_cls_tokens; 512
    # rows cover any block and pad id in use
    return rb.RobertaConfig(vocab_size=cfg.vocab_size,
                            hidden_size=cfg.hidden_size,
                            num_layers=cfg.encoder_layers,
                            num_heads=_heads_for(cfg.hidden_size,
                                                 cfg.encoder_heads),
                            intermediate_size=cfg.hidden_size * 4,
                            max_position_embeddings=512,
                            pad_token_id=cfg.pad_token_id)


def _t5_cfg(cfg: EmbedderConfig) -> t5m.T5Config:
    heads = _heads_for(cfg.hidden_size, cfg.encoder_heads)
    return t5m.T5Config(vocab_size=cfg.vocab_size, d_model=cfg.hidden_size,
                        d_kv=cfg.hidden_size // heads,
                        d_ff=cfg.hidden_size * 4,
                        num_layers=cfg.encoder_layers, num_heads=heads,
                        pad_token_id=cfg.pad_token_id)


def _n_cls(cfg: EmbedderConfig) -> int:
    return cfg.n_cls_tokens if cfg.cls == "roberta_cls" else 0


def init_projection(gen: torch.Generator, cfg: EmbedderConfig, n_src: int,
                    width: int, block_length: int, dtype=torch.float32,
                    device="cuda"):
    """The projection layer over ``n_src`` hidden states of ``width``: a
    kernel ``[n_src // n, width, projection_hidden]`` of std ``(width *
    block_length)^-0.5`` and a zero bias."""
    ksz = n_src // cfg.n_embedding_tokens
    std = (width * block_length) ** -0.5
    w = torch.randn((ksz, width, cfg.projection_hidden_size), generator=gen,
                    dtype=torch.float32, device=device)
    return {"kernel": (std * w).to(dtype),
            "bias": torch.zeros(cfg.projection_hidden_size, dtype=dtype,
                                device=device)}


def project(params, cfg: EmbedderConfig, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, n_src, width] -> [B, n_embedding_tokens, projection
    hidden]: concat, or the projection layer over groups of n_src // n."""
    B, n_src, width = hidden.shape
    n = cfg.n_embedding_tokens
    grouped = hidden.reshape(B, n, (n_src // n) * width)
    if cfg.projection_method == "concat":
        return grouped
    kernel = params["projection"]["kernel"].reshape(grouped.shape[-1], -1)
    out = torch.matmul(grouped, kernel)
    return out + params["projection"]["bias"].to(out.dtype)


def init_embedder_params(gen: torch.Generator, cfg: EmbedderConfig,
                         block_length: int, dtype=torch.float32,
                         device="cuda"):
    if cfg.cls in ("roberta", "roberta_cls"):
        return rb.init_roberta_embedder_params(
            gen, _roberta_cfg(cfg), cfg, block_length,
            n_cls_tokens=_n_cls(cfg), dtype=dtype, device=device)
    if cfg.cls == "t5":
        params = {"t5": t5m.init_t5_stack_params(
            gen, _t5_cfg(cfg), is_decoder=False, dtype=dtype, device=device)}
    else:
        emb = cfg.initializer_range * torch.randn(
            (cfg.vocab_size, cfg.hidden_size), generator=gen,
            dtype=torch.float32, device=device)
        emb[cfg.pad_token_id] = 0.0                   # padding_idx row
        params = {"embeddings": {"weight": emb.to(dtype)}}
    if cfg.projection_method == "projection_layer":
        params["projection"] = init_projection(
            gen, cfg, block_length, cfg.hidden_size, block_length, dtype,
            device)
    return params


def embed_blocks(params, cfg: EmbedderConfig, block_length: int,
                 input_ids: torch.Tensor, attention_mask=None) -> torch.Tensor:
    """input_ids [..., block_length] -> [..., n_embedding_tokens,
    projection_hidden_size]; ``attention_mask`` [..., block_length] masks
    the encoders' attention (the lookup ignores it)."""
    lead = input_ids.shape[:-1]
    if input_ids.shape[-1] != block_length:
        raise ValueError(f"block of {input_ids.shape[-1]} tokens, "
                         f"expected {block_length}")
    if cfg.cls in ("roberta", "roberta_cls"):
        return rb.roberta_embed_blocks(params, _roberta_cfg(cfg), cfg,
                                       block_length, input_ids,
                                       attention_mask,
                                       n_cls_tokens=_n_cls(cfg))
    ids = input_ids.reshape(-1, block_length)
    if cfg.cls == "t5":
        att = (attention_mask.reshape(ids.shape) if attention_mask is not None
               else torch.ones_like(ids))
        hidden = t5m.t5_stack(params["t5"], _t5_cfg(cfg), input_ids=ids,
                              attention_mask=att, is_decoder=False)
    else:
        hidden = params["embeddings"]["weight"][ids]      # [B, L, hidden]
        hidden = hidden.masked_fill((ids == cfg.pad_token_id)[..., None], 0.0)
    out = project(params, cfg, hidden)
    return out.reshape(*lead, *out.shape[1:])
