"""Static device-memory accounting for batch-size selection (port of
``block_transformer_tpu/utils/hbm.py``: the same arithmetic).

A replacement for the reference's try/except-OOM linear VRAM model
(measure_generation_time.py:252-372): predict bytes from the model config
and decode regime, pick the largest power-of-2 batch under the device
limit. The block transformer's footprint is dominated by weights + the
*tiny* block-level global cache; the vanilla baseline's by its token-level
KV cache — which is why their max batches differ by ~an order of magnitude
at long context (the mechanism behind the paper's throughput edge).
"""

from __future__ import annotations

from typing import Optional


def hbm_bytes_limit(default: Optional[int] = None) -> int:
    """The card's memory in bytes: ``torch.cuda.get_device_properties(
    0).total_memory``, the whole of it (the JAX package reads XLA's
    ``bytes_limit``, the share its allocator may take; ``auto_batch``'s
    margin stands for what the rest leaves free). Without a card, a CPU
    caller gets the ``default`` it passes; with none given it raises."""
    import torch
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    if default is None:
        raise RuntimeError("hbm_bytes_limit reads the CUDA card's memory; "
                           "no card is available and no default was given")
    return int(default)


def weight_bytes(quantize: str, dtype_bytes: int = 2,
                 group_size: int = 32) -> float:
    """Average stored bytes per matmul weight under a quantize mode.

    int8: int8 value + fp32 per-output-channel scale (amortized ~0).
    int4: packed nibble + fp32 scale per K-group of `group_size`.
    """
    if not quantize or quantize == "none":
        return float(dtype_bytes)
    if quantize == "int8":
        return 1.0
    if quantize == "int4":
        return 0.5 + 4.0 / group_size
    raise ValueError(quantize)


def block_model_bytes(cfg, batch: int, prefill: int, decode: int,
                      dtype_bytes: int = 2, kv_cache: str = "bf16",
                      quantize: str = None) -> int:
    """Estimated peak HBM for generate_blocks at a given batch.

    `quantize` mirrors bench.py --quantize (none/int8/int4/mixed48):
    matmul weights and the LM head are stored at the quantized width;
    embedding tables stay at dtype_bytes (gathers are not quantized).
    """
    L = cfg.block_length
    n = cfg.n_embedding_tokens
    blocks = (prefill + decode + L - 1) // L
    bd = cfg.block_decoder
    td = cfg.token_decoder.neox
    if quantize == "mixed48":
        bd_wb, td_wb = weight_bytes("int8"), weight_bytes("int4")
        head_wb = weight_bytes("int8")
    else:
        bd_wb = td_wb = head_wb = weight_bytes(quantize, dtype_bytes)
    embed_params = (cfg.embedder.vocab_size * cfg.embedder.hidden_size
                    + td.vocab_size * td.hidden_size)
    mat_bytes = (bd_wb * bd.num_layers * 12 * bd.hidden_size ** 2
                 + td_wb * td.num_layers * 12 * td.hidden_size ** 2
                 + head_wb * td.vocab_size * td.hidden_size
                 + td_wb * cfg.embedder.projection_hidden_size
                 * td.hidden_size * (cfg.expansion_ratio + 1))
    params = embed_params + mat_bytes / dtype_bytes
    kv_bytes = {"int8": 1 + 4 / bd.head_dim,
                "int4": 0.5 + 4 / bd.head_dim}.get(kv_cache, dtype_bytes)
    global_kv = int(2 * bd.num_layers * batch * bd.num_heads * blocks * n
                    * bd.head_dim * kv_bytes / dtype_bytes)
    local_kv = (2 * td.num_layers * batch * td.num_heads
                * (cfg.n_expanded_emb + L) * td.head_dim)
    logits = batch * td.vocab_size * 4 * 2
    # prefill runs in chunks of <=128 block positions (generate_blocks
    # prefill_chunk_blocks), so transient attention temps scale with the
    # chunk; ~48 bytes per (batch, chunk-position, hidden) element
    chunk = min(max(prefill // L, 1), 128)
    prefill_act = batch * chunk * bd.hidden_size * 48
    tokens_buf = batch * blocks * L * 4 * 2
    return (dtype_bytes * (params + global_kv + local_kv)
            + logits + prefill_act + tokens_buf)


def vanilla_model_bytes(cfg, batch: int, prefill: int, decode: int,
                        dtype_bytes: int = 2, kv_cache: str = "bf16",
                        quantize: str = None) -> int:
    """`kv_cache`/`quantize` mirror bench.py --vanilla_kv/--vanilla_quantize:
    the precision-matched baseline (VERDICT r4 item 1) stores matmul weights
    and the token-level KV cache at the same widths the block model gets."""
    S = prefill + decode
    wb = weight_bytes(quantize, dtype_bytes)
    mat_bytes = wb * (cfg.num_layers * 12 * cfg.hidden_size ** 2
                      + cfg.vocab_size * cfg.hidden_size)
    params = cfg.vocab_size * cfg.hidden_size + mat_bytes / dtype_bytes
    kv_width = {"int8": 1 + 4 / cfg.head_dim,
                "int4": 0.5 + 4 / cfg.head_dim}.get(kv_cache, dtype_bytes)
    kv = (2 * cfg.num_layers * batch * cfg.num_heads * S * cfg.head_dim
          * kv_width / dtype_bytes)
    logits = batch * cfg.vocab_size * 4 * 2
    prefill_act = batch * prefill * cfg.hidden_size * 12
    return int(dtype_bytes * (params + kv) + logits + prefill_act)


def auto_batch(estimate_fn, limit: int = None, margin: float = 0.8,
               max_batch: int = 4096) -> int:
    """Largest batch of the form 2^k, 3*2^k or 5*2^k whose estimate fits
    within margin*limit (all families keep the leading dim a multiple of
    the 8/128 tile sizes past batch 128; the 5*2^k family fills the wide
    256->384->512 gaps — e.g. 320 — where a KV-width change can
    otherwise cost a full candidate step)."""
    if limit is None:
        limit = hbm_bytes_limit()
    candidates = sorted(
        {b for k in range(max_batch.bit_length())
         for b in (2 ** k, 3 * 2 ** k, 5 * 2 ** k) if b <= max_batch})
    best = 1
    for b in candidates:
        if estimate_fn(b) < limit * margin:
            best = b
    return best
