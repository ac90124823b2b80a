"""Two-level autoregressive generation (port of
``block_transformer_tpu/inference/generate.py``).

- The prompt's block embeddings go through the block decoder and fill the
  global KV cache (bf16, INT8 or INT4: ``kv_cache``): in one fresh pass by
  default, or streamed in chunks through the cache (``fresh_prefill=False``,
  the JAX package's ``BT_FRESH_PREFILL=0``, and always for the GPT-Neo
  block decoder, which takes the bf16 cache only, as in the JAX package).
- The outer loop runs once per block: the token decoder decodes up to
  ``block_length`` tokens, the new block is embedded, and the block decoder
  appends it to the global cache. The GPT-NeoX prefix decoder decodes
  against a small local cache made fresh for each block; every other token
  decoder (summation, T5 cross-attention, GPT-Neo) re-runs its teacher-
  forced forward over the block once per token
  (``decode_block_tokens_rerun``).

The JAX package compiles both loops into one program; here they are host
loops, and the outer loop reads one flag back from the device per block to
stop once every row has finished. The loops run on a ``Decoders``: one
device's here, a rank's over a mesh in ``parallel/tp_decode.py``, which runs
these same loops (and the serving engine's) on its shards. EOS semantics are
the JAX package's: a row finishes when a generated block holds EOS; the EOS
and everything after it in the block come out as pad; finished rows emit pad
blocks and zero block embeddings.

The entry points run under ``torch.no_grad()``: the kernels they launch
have no backward (their wrappers refuse inputs that require grad), and
a caller's parameters may require grad.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from block_transformer_tpu_torch.config import (BlockTransformerConfig,
                                                NeoXConfig)
from block_transformer_tpu_torch.models import block_decoder as bd
from block_transformer_tpu_torch.models import embedder as emb
from block_transformer_tpu_torch.models import gpt_neo as gn
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.models import token_decoder as td
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import masks


class GenerationResult(NamedTuple):
    tokens: torch.Tensor     # [B, max_blocks, block_length] (prompt + generated)
    n_blocks: int            # valid blocks in ``tokens``
    unfinished: torch.Tensor  # [B] int32


class Decoders(NamedTuple):
    """What the generation loops and the serving engine run on: the block
    decoder's stacks and the config its cache is made from, the token
    decoder's inner loop, the stop test and the rows this process holds.
    ``single_device(cfg)`` gives one device's; ``parallel/tp_decode``
    builds a rank's over a ``(data, model)`` mesh (its heads, one
    all-reduce a layer, the pick over the vocab-sharded head)."""
    block_cfg: NeoXConfig       # the block decoder's, as its cache holds it
    block_stack: Callable       # neox_stack's signature
    block_prefill: Callable     # neox_prefill_fresh's signature
    decode_tokens: Callable     # decode_block_tokens' signature
    any_live: Callable          # bool tensor -> set in any row of any shard
    data_shards: int            # the batch splits into this many row blocks
    data_index: int             # the block of rows this process holds
    gather_rows: Callable       # its rows [B / data_shards, ..] -> [B, ..]
    rng: Callable               # (generator, greedy) -> a call's generator
    program: Callable           # () -> the context a call runs in
    streams: int                # token-decoder streams a block (1 or 2)


def single_device(cfg: BlockTransformerConfig) -> Decoders:
    """One device's: the stacks as they are, every row, ``any()``."""
    return Decoders(
        cfg.block_decoder, neox.neox_stack, neox.neox_prefill_fresh,
        decode_block_tokens, lambda flag: bool(flag.any()), 1, 0,
        lambda local: local, lambda generator, greedy: generator,
        contextlib.nullcontext, 1)


def local_rows(dec: Decoders, B: int) -> slice:
    """The rows of a batch of ``B`` that this process holds."""
    if B % dec.data_shards:
        raise ValueError(f"batch {B} does not split over {dec.data_shards} "
                         "data shards")
    b = B // dec.data_shards
    return slice(dec.data_index * b, (dec.data_index + 1) * b)


def stream_rows(dec: Decoders, B: int) -> list:
    """The token decoder's streams over ``B`` local rows: every row, or,
    with two streams, each half."""
    if dec.streams == 1:
        return [slice(None)]
    if B % 2:
        raise ValueError(f"overlap_streams=2 needs an even batch on each "
                         f"data shard, not {B}")
    return [slice(0, B // 2), slice(B // 2, B)]


def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Temperature, then top-k and nucleus (top-p) filtering: filtered-out
    entries become -inf. The top-1 token always survives top-p."""
    logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = ((cum - probs) < top_p).sum(dim=-1) - 1
        cutoff = sorted_logits.gather(-1, cutoff_idx[..., None])
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def _sample(logits: torch.Tensor, greedy: bool, temperature: float,
            generator: Optional[torch.Generator], top_k: int = 0,
            top_p: float = 1.0) -> torch.Tensor:
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(
        torch.int32)


@torch.no_grad()
def decode_block_tokens_rerun(params, cfg: BlockTransformerConfig,
                              block_embeddings, *, greedy: bool = True,
                              temperature: float = 1.0,
                              generator: Optional[torch.Generator] = None,
                              top_k: int = 0, top_p: float = 1.0):
    """The inner loop of every token decoder: step i re-runs the teacher-
    forced forward over the fixed ``[B, L+1]`` input, BOS then the tokens
    so far, later slots fed pad, and samples position i. Causal masking
    makes position i's logits depend only on the tokens before it, so this
    equals cached stepping at about L times its compute; the GPT-NeoX
    prefix decoder takes the cached loop of ``decode_block_tokens``."""
    tcfg = cfg.token_decoder
    L = cfg.block_length
    B = block_embeddings.shape[0]
    eos, pad = cfg.eos_token_id, cfg.pad_token_id
    dev = block_embeddings.device
    ids = torch.full((B, L + 1), pad, dtype=torch.int32, device=dev)
    ids[:, 0] = cfg.bos_token_id
    att = torch.ones((B, L + 1), dtype=torch.int32, device=dev)
    tokens = torch.zeros((B, L), dtype=torch.int32, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    for i in range(L):
        logits = td.token_decoder_train_forward(
            params["token_decoder"], tcfg, ids, att, block_embeddings,
            cfg.expansion_ratio, L)                         # [B, L, V]
        nxt = _sample(logits[:, i], greedy, temperature, generator, top_k,
                      top_p)
        tokens[:, i] = torch.where(alive & (nxt != eos), nxt, pad)
        ids[:, i + 1] = tokens[:, i]
        alive = alive & (nxt != eos)
    return tokens, alive


@torch.no_grad()
def decode_block_tokens(params, cfg: BlockTransformerConfig, block_embeddings,
                        *, greedy: bool = True, temperature: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        n_tokens: Optional[int] = None,
                        top_k: int = 0, top_p: float = 1.0):
    """Inner loop: block_embeddings [B, n_emb, projection_hidden] -> (tokens
    [B, L] with pad after EOS, alive [B] bool), L = ``n_tokens`` if given,
    else the block length. The GPT-NeoX prefix decoder decodes against a
    local KV cache of n_exp + L slots made here and dropped on return; every
    other token decoder goes to ``decode_block_tokens_rerun``, which decodes
    whole blocks only (``n_tokens`` must be None there)."""
    tcfg = cfg.token_decoder
    if tcfg.cls != "gpt-neo-x" or tcfg.decoding_strategy != "prefix":
        if n_tokens is not None:
            raise ValueError("n_tokens is only taken by the GPT-NeoX prefix "
                             f"token decoder, not {tcfg.cls!r} / "
                             f"{tcfg.decoding_strategy!r}")
        return decode_block_tokens_rerun(
            params, cfg, block_embeddings, greedy=greedy,
            temperature=temperature, generator=generator, top_k=top_k,
            top_p=top_p)
    return _prefix_decode(params, cfg, block_embeddings,
                          token_cfg=tcfg.neox, stack=neox.neox_stack,
                          pick=_pick, greedy=greedy, temperature=temperature,
                          generator=generator, n_tokens=n_tokens, top_k=top_k,
                          top_p=top_p)


def _pick(tparams, hidden, greedy, temperature, generator, top_k=0,
          top_p=1.0):
    """One device's token pick: ``_sample`` over the LM head's logits."""
    return _sample(neox.lm_logits(tparams, hidden), greedy, temperature,
                   generator, top_k, top_p)


def _prefix_decode(params, cfg: BlockTransformerConfig, block_embeddings, *,
                   token_cfg: NeoXConfig, stack, pick, greedy: bool,
                   temperature: float, generator, n_tokens=None,
                   top_k: int = 0, top_p: float = 1.0):
    """The GPT-NeoX prefix decoder's cached loop with its stack (``stack``,
    neox_stack's signature, run with ``token_cfg``, the config the local
    cache is made from) and its token pick (``pick``, ``_pick``'s
    signature) given: one device's in ``decode_block_tokens``, a rank's
    heads and vocab shard over a mesh."""
    L = cfg.block_length if n_tokens is None else n_tokens
    B = block_embeddings.shape[0]
    eos, pad = cfg.eos_token_id, cfg.pad_token_id
    tparams = params["token_decoder"]
    expanded = td.expand_block_embeddings(tparams, cfg.token_decoder,
                                          block_embeddings, cfg.expansion_ratio)
    dev = expanded.device
    cache = neox.KVCache.create(token_cfg, B, cfg.n_expanded_emb + L,
                                dtype=expanded.dtype, device=dev)
    capacity = cache.k.shape[3]

    def step(x, cache):
        """x [B, S, h] through the stack into the local cache; the token
        picked at its last position."""
        S = x.shape[1]
        mask = masks.decode_mask(cache.length, capacity, S, device=dev)
        positions = cache.length + torch.arange(S, dtype=torch.int32,
                                                device=dev)
        hidden, cache = stack(tparams, x, cfg=token_cfg, mask=mask,
                              positions=positions, cache=cache)
        return pick(tparams, hidden[:, -1, :], greedy, temperature,
                    generator, top_k, top_p), cache

    first, cache = step(expanded, cache)
    alive = first != eos
    tokens = torch.zeros((B, L), dtype=torch.int32, device=dev)
    tokens[:, 0] = torch.where(alive, first, pad)
    for i in range(1, L):
        # dead rows are fed pad; their outputs are ignored
        prev = torch.where(alive, tokens[:, i - 1], pad)
        nxt, cache = step(neox.embed_tokens(tparams, prev[:, None]), cache)
        tokens[:, i] = torch.where(alive & (nxt != eos), nxt, pad)
        alive = alive & (nxt != eos)
    return tokens, alive


def _block_decoder_step(params, cfg: BlockTransformerConfig, inputs_embeds,
                        cache, kv_valid, new_valid,
                        dec: Optional[Decoders] = None):
    """Append S = inputs_embeds.shape[1] positions to the global cache and run
    the block decoder (``dec``'s stack, one device's by default). ``kv_valid``
    [B, capacity] is updated in place, before the mask is built. Returns
    (hidden [B, S, ph], cache, kv_valid)."""
    S = inputs_embeds.shape[1]
    start = cache.length
    kv_valid[:, start:start + S] = new_valid.to(kv_valid.dtype)
    mask = masks.block_decode_mask(start, cache.k.shape[3], S, kv_valid,
                                   cfg.n_embedding_tokens)
    positions = start + torch.arange(S, dtype=torch.int32,
                                     device=inputs_embeds.device)
    if cfg.block_decoder_cls == "gpt-neo":
        bp = params["block_decoder"]
        wpe = bp["wpe"]["weight"]
        # JAX's gather clamps a position past the table to its last row
        x = inputs_embeds + wpe[positions.clamp(max=wpe.shape[0] - 1)][
            None].to(inputs_embeds.dtype)
        hidden, cache = gn.gpt_neo_stack_cached(
            bp, bd._gpt_neo_cfg(cfg.block_decoder, cfg.block_decoder_window),
            x, mask, positions, cache)
        return hidden, cache, kv_valid
    dec = dec or single_device(cfg)
    hidden, cache = dec.block_stack(params["block_decoder"], inputs_embeds,
                                    cfg=dec.block_cfg, mask=mask,
                                    positions=positions, cache=cache)
    return hidden, cache, kv_valid


@torch.no_grad()
def prefill_blocks(params, cfg: BlockTransformerConfig, input_ids,
                   attention_mask, block_attention_mask, *, capacity: int,
                   kv_cache: str = "bf16", prefill_chunk_blocks: int = 128,
                   fresh_prefill: bool = True):
    """Embed the prompt blocks and run them through the block decoder.
    Returns (next_embeds [B, n, ph] at the last prompt block, cache,
    kv_valid [B, capacity]).

    ``fresh_prefill`` (the default): one fresh pass (``neox_prefill_fresh``),
    attention tiled by ``prefill_chunk_blocks`` blocks of queries, reading
    the K/V just computed while the cache is only written. Otherwise the
    streaming prefill: the prompt goes through ``_block_decoder_step`` in
    chunks of ``prefill_chunk_blocks`` blocks, each attending to the cache
    (dequantized for INT8 / INT4); a longer prompt is padded to a whole
    number of chunks (the padded tail is invalid, and the cache's length is
    rewound to the prompt's, so decode overwrites it). The GPT-Neo block
    decoder always streams."""
    return _prefill_blocks(params, cfg, input_ids, attention_mask,
                           block_attention_mask, single_device(cfg),
                           capacity=capacity, kv_cache=kv_cache,
                           prefill_chunk_blocks=prefill_chunk_blocks,
                           fresh_prefill=fresh_prefill)


def _prefill_blocks(params, cfg: BlockTransformerConfig, input_ids,
                    attention_mask, block_attention_mask, dec: Decoders, *,
                    capacity: int, kv_cache: str, prefill_chunk_blocks: int,
                    fresh_prefill: bool):
    """``prefill_blocks`` on ``dec``'s stacks."""
    B, N, L = input_ids.shape
    n = cfg.n_embedding_tokens
    ph = cfg.embedder.projection_hidden_size
    device = input_ids.device
    block_embeds = emb.embed_blocks(params["embedder"], cfg.embedder,
                                    cfg.block_length, input_ids,
                                    attention_mask=attention_mask)
    inputs_embeds = block_embeds.reshape(B, N * n, ph)
    cache = neox.make_kv_cache(dec.block_cfg, B, capacity, kv_cache,
                               dtype=inputs_embeds.dtype, device=device)
    kv_valid = torch.zeros((B, capacity), dtype=torch.int32, device=device)
    prompt_valid = block_attention_mask.to(torch.int32).repeat_interleave(
        n, dim=1)
    S = N * n
    if fresh_prefill and cfg.block_decoder_cls != "gpt-neo":
        mask = masks.block_decode_mask(0, S, S, prompt_valid, n)
        positions = torch.arange(S, dtype=torch.int32, device=device)
        hidden, cache = dec.block_prefill(
            params["block_decoder"], inputs_embeds, cfg=dec.block_cfg,
            mask=mask, positions=positions, cache=cache,
            q_tile=max(1, prefill_chunk_blocks) * n)
        kv_valid[:, :S] = prompt_valid
        return hidden[:, -n:, :], cache, kv_valid
    chunk = max(1, prefill_chunk_blocks) * n
    if S <= chunk:
        hidden, cache, kv_valid = _block_decoder_step(
            params, cfg, inputs_embeds, cache, kv_valid, prompt_valid, dec)
        return hidden[:, -n:, :], cache, kv_valid
    n_chunks = -(-S // chunk)
    pad_to = n_chunks * chunk
    if capacity < pad_to:
        raise ValueError(
            f"max_blocks capacity {capacity} < padded prefill {pad_to}; "
            f"raise max_blocks or lower prefill_chunk_blocks")
    x_pad = torch.nn.functional.pad(inputs_embeds, (0, 0, 0, pad_to - S))
    v_pad = torch.nn.functional.pad(prompt_valid, (0, pad_to - S))
    last = (S - n) // chunk            # the chunk holding the last block
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        hidden, cache, kv_valid = _block_decoder_step(
            params, cfg, x_pad[:, sl], cache, kv_valid, v_pad[:, sl], dec)
        if c == last:
            off = S - n - c * chunk
            next_embeds = hidden[:, off:off + n, :]
    # rewind the write frontier to the prompt: the first generated block
    # overwrites the padded slots
    kv_valid[:, S:] = 0
    return next_embeds, cache._replace(length=S), kv_valid


@torch.no_grad()
def generate_blocks(params, cfg: BlockTransformerConfig, input_ids,
                    attention_mask, block_attention_mask, *, max_blocks: int,
                    greedy: bool = True, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    prefill_chunk_blocks: int = 128, kv_cache: str = "bf16",
                    fresh_prefill: bool = True,
                    device="cuda") -> GenerationResult:
    """Block-format generation: input_ids / attention_mask [B, N, L] and
    block_attention_mask [B, N] (tensors or arrays, moved to ``device``);
    generates until ``max_blocks`` blocks in all or every row finished.
    ``kv_cache`` is declared as the KV mode of the W8A8 decisions
    (``ops.linear.kv_mode``), as in the JAX package. The GPT-Neo block
    decoder takes the bf16 cache only."""
    if cfg.block_decoder_cls == "gpt-neo" and kv_cache != "bf16":
        raise NotImplementedError(
            "a quantized global KV cache with the gpt-neo block decoder is "
            "not wired (as in the JAX package): use kv_cache='bf16'")
    return _generate(params, cfg, input_ids, attention_mask,
                     block_attention_mask, single_device(cfg),
                     max_blocks=max_blocks, greedy=greedy,
                     temperature=temperature, top_k=top_k, top_p=top_p,
                     generator=generator,
                     prefill_chunk_blocks=prefill_chunk_blocks,
                     kv_cache=kv_cache, fresh_prefill=fresh_prefill,
                     device=device)


class _Stream(NamedTuple):
    """One token-decoder stream's rows of the generation state."""
    tokens: torch.Tensor        # [b, max_blocks, L]
    next_embeds: torch.Tensor   # [b, n, ph]
    cache: object
    kv_valid: torch.Tensor      # [b, capacity]
    unfinished: torch.Tensor    # [b] int32


@torch.no_grad()
def _generate(params, cfg: BlockTransformerConfig, input_ids, attention_mask,
              block_attention_mask, dec: Decoders, *, max_blocks: int,
              greedy: bool = True, temperature: float = 1.0, top_k: int = 0,
              top_p: float = 1.0, generator=None,
              prefill_chunk_blocks: int = 128, kv_cache: str = "bf16",
              fresh_prefill: bool = True, device="cuda") -> GenerationResult:
    """``generate_blocks`` on ``dec``: this process generates its rows of
    the batch and every row comes back (``dec.gather_rows``). With two
    streams a block runs ``TD(A); TD(B); BD(A); BD(B)`` (token decoders,
    then block decoders, over the two halves of the rows)."""
    with linear_ops.kv_mode(kv_cache), dec.program():
        input_ids = torch.as_tensor(input_ids, device=device).to(torch.int32)
        attention_mask = torch.as_tensor(attention_mask, device=device)
        block_attention_mask = torch.as_tensor(block_attention_mask,
                                               device=device)
        B, N, L = input_ids.shape
        rows = local_rows(dec, B)
        input_ids, attention_mask, block_attention_mask = (
            input_ids[rows], attention_mask[rows], block_attention_mask[rows])
        n = cfg.n_embedding_tokens
        ph = cfg.embedder.projection_hidden_size
        generator = dec.rng(generator, greedy)
        # capacity rounded up to a multiple of 128 (extra slots stay invalid)
        capacity = max_blocks * n
        if capacity >= 128:
            capacity = -(-capacity // 128) * 128

        streams = []
        for s in stream_rows(dec, input_ids.shape[0]):
            ids = input_ids[s]
            next_embeds, cache, kv_valid = _prefill_blocks(
                params, cfg, ids, attention_mask[s], block_attention_mask[s],
                dec, capacity=capacity, kv_cache=kv_cache,
                prefill_chunk_blocks=prefill_chunk_blocks,
                fresh_prefill=fresh_prefill)
            tokens = torch.zeros((ids.shape[0], max_blocks, L),
                                 dtype=torch.int32, device=device)
            tokens[:, :N] = ids
            streams.append(_Stream(tokens, next_embeds, cache, kv_valid,
                                   torch.ones(ids.shape[0], dtype=torch.int32,
                                              device=device)))

        def unfinished():
            return torch.cat([st.unfinished for st in streams])

        n_blocks = N
        while n_blocks < max_blocks and dec.any_live(unfinished() > 0):
            # every stream's token decoder first, then every block-decoder
            # step: the chains TD(s) -> BD(s) share no data
            new = [dec.decode_tokens(
                params, cfg, st.next_embeds.reshape(-1, n, ph), greedy=greedy,
                temperature=temperature, generator=generator, top_k=top_k,
                top_p=top_p) for st in streams]
            streams = [_block_done(params, cfg, dec, st, t, a, n_blocks)
                       for st, (t, a) in zip(streams, new)]
            n_blocks += 1
        tokens = torch.cat([st.tokens for st in streams])
        return GenerationResult(dec.gather_rows(tokens), n_blocks,
                                dec.gather_rows(unfinished()))


def _block_done(params, cfg: BlockTransformerConfig, dec: Decoders,
                st: _Stream, new_tokens, inner_alive, n_blocks: int):
    """A stream's generated block into its tokens, embedded, then through
    the block decoder. Rows that finished emit pad blocks and embed zeros;
    a row finishes when its block holds EOS."""
    b, n = new_tokens.shape[0], cfg.n_embedding_tokens
    alive = st.unfinished.bool()
    new_tokens = torch.where(alive[:, None], new_tokens, cfg.pad_token_id)
    unfinished = st.unfinished * inner_alive.to(torch.int32)
    st.tokens[:, n_blocks] = new_tokens
    new_block_emb = emb.embed_blocks(params["embedder"], cfg.embedder,
                                     cfg.block_length, new_tokens)
    new_block_emb = new_block_emb.masked_fill(~alive[:, None, None], 0.0)
    hidden, cache, kv_valid = _block_decoder_step(
        params, cfg, new_block_emb.reshape(b, n, -1).to(st.next_embeds.dtype),
        st.cache, st.kv_valid, unfinished[:, None].expand(b, n), dec)
    return _Stream(st.tokens, hidden[:, -n:, :], cache, kv_valid, unfinished)


# ---------------------------------------------------------------------------
# Flat-token convenience wrapper
# ---------------------------------------------------------------------------

def preprocess_inputs(cfg: BlockTransformerConfig, input_ids,
                      attention_mask=None):
    """Flat [B, T] -> block format with LEFT pad to a block boundary.
    Returns a dict of numpy arrays and the pad length added."""
    ids = np.asarray(input_ids)
    if ids.ndim == 1:
        ids = ids[None]
    if attention_mask is None:
        att = (ids != cfg.pad_token_id).astype(np.int32)
    else:
        att = np.asarray(attention_mask).astype(np.int32).reshape(ids.shape)
    B, T = ids.shape
    L = cfg.block_length
    pad_len = (-T) % L
    if pad_len:
        ids = np.pad(ids, ((0, 0), (pad_len, 0)),
                     constant_values=cfg.pad_token_id)
        att = np.pad(att, ((0, 0), (pad_len, 0)), constant_values=0)
    N = ids.shape[1] // L
    ids = ids.reshape(B, N, L)
    att = att.reshape(B, N, L)
    bam = att.any(axis=-1).astype(np.int32)
    return {"input_ids": ids, "attention_mask": att,
            "block_attention_mask": bam, "initial_block_padding": pad_len}


@torch.no_grad()
def generate(params, cfg: BlockTransformerConfig, input_ids,
             attention_mask=None, max_length: int = 100, greedy: bool = True,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None,
             fresh_prefill: bool = True, device="cuda") -> np.ndarray:
    """Flat token ids in, flat token ids out (prompt + generated, cut at
    ``max_length``)."""
    d = preprocess_inputs(cfg, input_ids, attention_mask)
    B, N, L = d["input_ids"].shape
    pad_len = d["initial_block_padding"]
    max_blocks = N + max(0, -(-(max_length + pad_len - N * L) // L))
    res = generate_blocks(params, cfg, d["input_ids"], d["attention_mask"],
                          d["block_attention_mask"], max_blocks=max_blocks,
                          greedy=greedy, temperature=temperature, top_k=top_k,
                          top_p=top_p, generator=generator,
                          fresh_prefill=fresh_prefill, device=device)
    toks = res.tokens[:, :res.n_blocks].reshape(B, -1).cpu().numpy()
    return toks[:, pad_len:][:, :max_length]
