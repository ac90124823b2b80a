"""Token decoder, prefix strategy (port of
``block_transformer_tpu/models/token_decoder.py``, GPT-NeoX family).

The block embedding is expanded by a dense layer into ``n_expanded_emb``
prefix embeddings that take the place of the BOS token; the token decoder
then decodes the block's tokens after that prefix.
"""

from __future__ import annotations

import torch

from block_transformer_tpu_torch.config import TokenDecoderConfig
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import masks


def _check(cfg: TokenDecoderConfig) -> None:
    if (cfg.cls != "gpt-neo-x" or cfg.decoding_strategy != "prefix"
            or cfg.expansion_method != "expansion_layer"):
        raise NotImplementedError(
            f"token decoder {cfg.cls!r} / {cfg.decoding_strategy!r} / "
            f"{cfg.expansion_method!r}: the port has the GPT-NeoX prefix "
            "decoder with an expansion layer only")


def init_token_decoder_params(gen: torch.Generator, cfg: TokenDecoderConfig,
                              projection_hidden_size: int, dtype=torch.float32,
                              device="cuda"):
    _check(cfg)
    params = neox.init_neox_params(gen, cfg.neox, with_embed_in=True,
                                   with_lm_head=True, dtype=dtype,
                                   device=device)
    h = cfg.neox.hidden_size
    std = projection_hidden_size ** -0.5
    w = torch.randn((projection_hidden_size, h * cfg.expansion_ratio),
                    generator=gen, dtype=torch.float32, device=device)
    params["expansion"] = {
        "kernel": (std * w).to(dtype),
        "bias": torch.zeros(h * cfg.expansion_ratio, dtype=dtype,
                            device=device),
    }
    return params


def expand_block_embeddings(params, cfg: TokenDecoderConfig, block_embeddings,
                            expansion_ratio: int):
    """[..., n_emb, projection_hidden] -> [..., n_emb * ratio, hidden]."""
    lead = block_embeddings.shape[:-2]
    n_emb = block_embeddings.shape[-2]
    out = linear_ops.apply_linear(block_embeddings, params["expansion"])
    return out.reshape(*lead, n_emb * expansion_ratio, cfg.neox.hidden_size)


def token_decoder_train_forward(params, cfg: TokenDecoderConfig, input_ids,
                                attention_mask, block_embeddings,
                                expansion_ratio: int, block_length: int,
                                remat: bool = False):
    """Teacher-forced forward over one block per row. input_ids [Bb, L+1] =
    [BOS, x1..xL]; attention_mask [Bb, L+1]; block_embeddings [Bb, n_emb,
    projection_hidden]. Returns float32 logits [Bb, L, vocab] for x1..xL;
    ``remat`` checkpoints each layer of the stack."""
    _check(cfg)
    L = input_ids.shape[1] - 1
    if L != block_length:
        raise ValueError(f"{L} tokens per block, expected {block_length}")
    n_exp = block_embeddings.shape[-2] * expansion_ratio
    expanded = expand_block_embeddings(params, cfg, block_embeddings,
                                       expansion_ratio)
    # drop the last input token, then replace BOS by the expanded prefix
    tok_embeds = neox.embed_tokens(params, input_ids[:, 1:-1])
    x = torch.cat([expanded.to(tok_embeds.dtype), tok_embeds], dim=1)
    mask = masks.token_decoder_train_mask(attention_mask[:, 1:-1],
                                          n_prefix=n_exp)
    positions = torch.arange(n_exp + L - 1, dtype=torch.int32, device=x.device)
    hidden, _ = neox.neox_stack(params, x, cfg=cfg.neox, mask=mask,
                                positions=positions, remat=remat)
    hidden = hidden[:, n_exp - 1:, :]                  # [Bb, L, h]
    return neox.lm_logits(params, hidden)


def token_decoder_prefix_step(params, cfg: TokenDecoderConfig, expanded,
                              cache: neox.KVCache):
    """The expanded prefix's mini-prefill: expanded [B, n_exp, h] into the
    fresh local cache. Returns (logits of the block's first token [B, V],
    cache)."""
    n_exp = expanded.shape[1]
    mask = masks.decode_mask(cache.length, cache.k.shape[3], n_exp,
                             device=expanded.device)
    positions = cache.length + torch.arange(n_exp, dtype=torch.int32,
                                            device=expanded.device)
    hidden, cache = neox.neox_stack(params, expanded, cfg=cfg.neox, mask=mask,
                                    positions=positions, cache=cache)
    return neox.lm_logits(params, hidden[:, -1, :]), cache


def token_decoder_token_step(params, cfg: TokenDecoderConfig, token_ids,
                             cache: neox.KVCache):
    """One within-block step: token_ids [B] -> (logits [B, V], cache)."""
    x = neox.embed_tokens(params, token_ids[:, None])          # [B, 1, h]
    mask = masks.decode_mask(cache.length, cache.k.shape[3], 1,
                             device=x.device)
    positions = cache.length + torch.arange(1, dtype=torch.int32,
                                            device=x.device)
    hidden, cache = neox.neox_stack(params, x, cfg=cfg.neox, mask=mask,
                                    positions=positions, cache=cache)
    return neox.lm_logits(params, hidden[:, -1, :]), cache
