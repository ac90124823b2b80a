"""Token decoder: within-block decoding conditioned on a block embedding
(port of ``block_transformer_tpu/models/token_decoder.py``).

The block embedding is expanded to ``n_expanded_emb`` vectors of the token
decoder's width, by a dense layer (``expansion_layer``) or by repeating
each embedding ``expansion_ratio`` times (``expansion_method=None``). Three
decoding strategies use them:

- **prefix** (the main family): the expanded vectors take the place of the
  BOS token as a prefix, and the token decoder decodes the block after it;
- **summation**: BOS stays, and the expanded vectors (one per block
  position; ``n_expanded_emb`` must equal ``block_length``) are added to
  the token embeddings positionwise;
- **cross_attention** (T5 only): BOS stays, and a T5 decoder cross-attends
  to the expanded vectors.

The stack is GPT-NeoX (``gpt-neo-x``), GPT-Neo (``gpt-neo``, tied head) or
T5 (``t5``, tied head rescaled). The training forward drops the last input
token, so ``block_length`` logit positions come out per block.
"""

from __future__ import annotations

import torch

from block_transformer_tpu_torch.config import TokenDecoderConfig
from block_transformer_tpu_torch.models import gpt_neo as gn
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.models import t5 as t5m
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import masks


def _t5_cfg(cfg: TokenDecoderConfig) -> t5m.T5Config:
    n = cfg.neox
    return t5m.T5Config(vocab_size=n.vocab_size, d_model=n.hidden_size,
                        d_kv=n.head_dim, d_ff=n.intermediate_size,
                        num_layers=n.num_layers, num_heads=n.num_heads,
                        pad_token_id=n.pad_token_id,
                        eos_token_id=n.eos_token_id)


def _gpt_neo_cfg(cfg: TokenDecoderConfig) -> gn.GPTNeoConfig:
    n = cfg.neox
    return gn.GPTNeoConfig(vocab_size=n.vocab_size, hidden_size=n.hidden_size,
                           num_layers=n.num_layers, num_heads=n.num_heads,
                           intermediate_size=n.intermediate_size,
                           max_position_embeddings=n.max_position_embeddings,
                           pad_token_id=n.pad_token_id,
                           eos_token_id=n.eos_token_id)


def init_token_decoder_params(gen: torch.Generator, cfg: TokenDecoderConfig,
                              projection_hidden_size: int, dtype=torch.float32,
                              device="cuda"):
    if cfg.cls == "t5":
        params = {"t5": t5m.init_t5_stack_params(
            gen, _t5_cfg(cfg), is_decoder=True, dtype=dtype, device=device)}
    elif cfg.cls == "gpt-neo":
        params = {"gpt_neo": gn.init_gpt_neo_params(
            gen, _gpt_neo_cfg(cfg), with_embed=True, dtype=dtype,
            device=device)}
    else:
        params = neox.init_neox_params(gen, cfg.neox, with_embed_in=True,
                                       with_lm_head=True, dtype=dtype,
                                       device=device)
    if cfg.expansion_method == "expansion_layer":
        width = cfg.neox.hidden_size * cfg.expansion_ratio
        w = torch.randn((projection_hidden_size, width), generator=gen,
                        dtype=torch.float32, device=device)
        params["expansion"] = {
            "kernel": (projection_hidden_size ** -0.5 * w).to(dtype),
            "bias": torch.zeros(width, dtype=dtype, device=device),
        }
    return params


def expand_block_embeddings(params, cfg: TokenDecoderConfig, block_embeddings,
                            expansion_ratio: int):
    """[..., n_emb, projection_hidden] -> [..., n_emb * ratio, hidden]."""
    if cfg.expansion_method != "expansion_layer":
        return block_embeddings.repeat_interleave(expansion_ratio, dim=-2)
    lead = block_embeddings.shape[:-2]
    n_emb = block_embeddings.shape[-2]
    out = linear_ops.apply_linear(block_embeddings, params["expansion"])
    return out.reshape(*lead, n_emb * expansion_ratio, cfg.neox.hidden_size)


def token_decoder_train_forward(params, cfg: TokenDecoderConfig, input_ids,
                                attention_mask, block_embeddings,
                                expansion_ratio: int, block_length: int,
                                remat: bool = False, stack_fn=None):
    """Teacher-forced forward over one block per row. input_ids [Bb, L+1] =
    [BOS, x1..xL]; attention_mask [Bb, L+1]; block_embeddings [Bb, n_emb,
    projection_hidden]. Returns float32 logits [Bb, L, vocab] for x1..xL;
    ``remat`` checkpoints each layer of a GPT-NeoX stack. ``stack_fn(params,
    x, mask, positions)`` replaces the GPT-NeoX stack (final-normed hidden
    states out): the mesh training programs and the pipeline
    (``parallel/pipeline.py``) plug theirs in there."""
    L = input_ids.shape[1] - 1
    if L != block_length:
        raise ValueError(f"{L} tokens per block, expected {block_length}")
    expanded = expand_block_embeddings(params, cfg, block_embeddings,
                                       expansion_ratio)     # [Bb, n_exp, h]
    if cfg.decoding_strategy == "cross_attention":
        # BOS stays: prefix length 1, so no redundant output positions
        t5cfg = _t5_cfg(cfg)
        att = torch.cat([torch.ones_like(attention_mask[:, :1]),
                         attention_mask[:, 1:-1]], dim=1)
        hidden = t5m.t5_stack(params["t5"], t5cfg, input_ids=input_ids[:, :-1],
                              attention_mask=att, is_decoder=True,
                              encoder_hidden_states=expanded)
        return t5m.t5_lm_logits(params["t5"], t5cfg, hidden)

    gpt_neo = cfg.cls == "gpt-neo"
    def embed(ids):
        if gpt_neo:
            return params["gpt_neo"]["wte"]["weight"][ids]
        return neox.embed_tokens(params, ids)

    def stack(x, mask):
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        if stack_fn is not None:
            if gpt_neo:
                raise NotImplementedError("a substituted token-decoder "
                                          "stack runs the GPT-NeoX family")
            return stack_fn(params, x, mask, positions)
        if gpt_neo:
            return gn.gpt_neo_token_decoder_forward(
                params["gpt_neo"], _gpt_neo_cfg(cfg), x, mask)
        hidden, _ = neox.neox_stack(params, x, cfg=cfg.neox, mask=mask,
                                    positions=positions, remat=remat)
        return hidden

    if cfg.decoding_strategy == "prefix":
        # drop the last input token, then replace BOS by the expanded prefix;
        # the first n_exp - 1 outputs predict nothing
        n_exp = expanded.shape[1]
        tok_embeds = embed(input_ids[:, 1:-1])
        x = torch.cat([expanded.to(tok_embeds.dtype), tok_embeds], dim=1)
        mask = masks.token_decoder_train_mask(attention_mask[:, 1:-1],
                                              n_prefix=n_exp)
        hidden = stack(x, mask)[:, n_exp - 1:, :]          # [Bb, L, h]
    elif cfg.decoding_strategy == "summation":
        # BOS stays; the expanded vectors add to the block's positions
        tok_embeds = embed(input_ids[:, :-1])              # [BOS, x1..x_{L-1}]
        x = tok_embeds + expanded[:, :L, :].to(tok_embeds.dtype)
        mask = masks.token_decoder_train_mask(attention_mask[:, 1:-1],
                                              n_prefix=1)
        hidden = stack(x, mask)
    else:
        raise NotImplementedError(cfg.decoding_strategy)
    if gpt_neo:          # the head is tied to wte
        return torch.matmul(hidden.float(),
                            params["gpt_neo"]["wte"]["weight"].float().t())
    return neox.lm_logits(params, hidden)


def token_decoder_prefix_step(params, cfg: TokenDecoderConfig, expanded,
                              cache: neox.KVCache):
    """The GPT-NeoX prefix decoder's mini-prefill: expanded [B, n_exp, h]
    into the fresh local cache. Returns (logits of the block's first token
    [B, V], cache)."""
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
    """One within-block step of the GPT-NeoX prefix decoder: token_ids [B]
    -> (logits [B, V], cache)."""
    x = neox.embed_tokens(params, token_ids[:, None])          # [B, 1, h]
    mask = masks.decode_mask(cache.length, cache.k.shape[3], 1,
                             device=x.device)
    positions = cache.length + torch.arange(1, dtype=torch.int32,
                                            device=x.device)
    hidden, cache = neox.neox_stack(params, x, cfg=cfg.neox, mask=mask,
                                    positions=positions, cache=cache)
    return neox.lm_logits(params, hidden[:, -1, :]), cache
