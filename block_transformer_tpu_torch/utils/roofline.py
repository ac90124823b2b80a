"""Analytic FLOP / device-byte models and peak-ratio (MFU, roofline)
reporting (port of ``block_transformer_tpu/utils/roofline.py``: the same
FLOP and byte models).

The reference claims "speed-of-light dequant+matmul per chip"
(BASELINE.json north star) — a claim that needs a denominator. This module
gives stage timings one: per-stage achieved FLOP/s and memory bytes/s
against the card's peaks, per the weights-FLOP accounting the memory model
(utils/hbm.py) already uses.

Peaks are NVIDIA H100 SXM data-sheet numbers (dense, at the 700 W power
limit): 989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s HBM. A card set to a
lower power limit runs below them. The JAX package also reports against an
"effective" bandwidth it measured on its own platform; no such figure
exists for this card, so the ``*_effective`` keys are not reported.
"""

from __future__ import annotations

# NVIDIA H100 SXM data-sheet peaks (dense)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_GBPS = 3.35e12       # bytes/s


def _wbytes(quantize: str | None, which: str) -> float:
    from block_transformer_tpu_torch.utils import hbm
    if quantize == "mixed48":
        return hbm.weight_bytes(
            {"bd": "int8", "td": "int4", "head": "int8"}[which])
    return hbm.weight_bytes(quantize)


def decode_stage_model(cfg, batch: int, prefill: int, decode: int,
                       kv_cache: str = "bf16",
                       quantize: str | None = None) -> dict:
    """FLOPs and HBM bytes per BLOCK STEP (one block of ``block_length``
    tokens for every batch row) for the two decode stages, evaluated at
    the mid-decode cache length.

    Weight FLOPs: 2 * params per processed position. Attention FLOPs:
    4 * hidden * kv_len per position per layer (QK^T + AV). Bytes: one
    weight-stack read per forward call at the stored (quantized) width,
    plus the K/V cache stream for the block decoder (the token decoder's
    ephemeral cache is negligible).
    """
    L = cfg.block_length
    n = cfg.n_embedding_tokens
    bd = cfg.block_decoder
    td = cfg.token_decoder.neox
    n_exp = cfg.n_expanded_emb
    V = td.vocab_size

    # mid-decode block-level cache length (positions)
    s_kv = (prefill + decode / 2) / L * n

    bd_mat_params = bd.num_layers * 12 * bd.hidden_size ** 2
    td_mat_params = td.num_layers * 12 * td.hidden_size ** 2
    head_params = td.hidden_size * V

    # --- block decoder: n positions per block step -----------------------
    bd_flops = batch * n * (2 * bd_mat_params
                            + 4 * bd.num_layers * bd.hidden_size * s_kv)
    kv_b = {"int8": 1 + 4 / bd.head_dim, "int4": 0.5 + 4 / bd.head_dim}.get(
        kv_cache, 2.0)
    bd_bytes = (_wbytes(quantize, "bd") * bd_mat_params
                + 2 * bd.num_layers * batch * bd.num_heads * s_kv
                * bd.head_dim * kv_b)

    # --- token decoder: 1 prefix call (n_exp positions) + L-1 token calls,
    # logits on the last position of each of the L calls ------------------
    positions = n_exp + (L - 1)
    avg_ctx = (n_exp + L) / 2
    td_flops = batch * (2 * td_mat_params * positions
                        + 4 * td.num_layers * td.hidden_size * avg_ctx
                        * positions
                        + 2 * head_params * L)
    td_calls = L  # prefix step + (L-1) cached token steps
    td_bytes = td_calls * (_wbytes(quantize, "td") * td_mat_params
                           + _wbytes(quantize, "head") * head_params)

    return {"bd_flops": bd_flops, "td_flops": td_flops,
            "bd_bytes": bd_bytes, "td_bytes": td_bytes,
            "flops_per_token": (bd_flops + td_flops) / (batch * L),
            "bytes_per_token": (bd_bytes + td_bytes) / (batch * L)}


def prefill_model(cfg, batch: int, prefill: int) -> dict:
    """FLOPs for the generation prefill: embedder (lookup+concat: no
    matmul for the main family) + block decoder over the prompt's block
    positions with causal attention."""
    n = cfg.n_embedding_tokens
    bd = cfg.block_decoder
    S = prefill // cfg.block_length * n
    bd_mat_params = bd.num_layers * 12 * bd.hidden_size ** 2
    flops = batch * (2 * bd_mat_params * S
                     + 2 * bd.num_layers * bd.hidden_size * S * S)
    return {"prefill_flops": flops, "prefill_positions": S}


def vanilla_decode_model(cfg, batch: int, prefill: int, decode: int) -> dict:
    """Per-token FLOPs for the vanilla baseline's decode step."""
    s_kv = prefill + decode / 2
    mat = cfg.num_layers * 12 * cfg.hidden_size ** 2
    head = cfg.hidden_size * cfg.vocab_size
    flops = batch * (2 * (mat + head)
                     + 4 * cfg.num_layers * cfg.hidden_size * s_kv)
    byts = (2 * mat + 2 * head
            + 2 * cfg.num_layers * batch * cfg.num_heads * s_kv
            * cfg.head_dim * 2)
    return {"flops_per_step": flops, "bytes_per_step": byts}


def mfu_summary(cfg, *, batch: int, prefill: int, decode: int,
                kv_cache: str, quantize: str | None,
                bd_ms: float, td_ms: float,
                prefill_ms: float | None = None,
                headline_tok_per_s: float | None = None,
                headline_batch: int | None = None) -> dict:
    """Peak-ratio summary from measured stage timings (at the stage batch).

    MFU is reported against the bf16 peak (conservative: W8A8 stages run
    s8xs8 at up to 2x that rate, so their int8-peak MFU is half the
    reported number), memory utilization against the data-sheet bandwidth.
    """
    m = decode_stage_model(cfg, batch, prefill, decode, kv_cache, quantize)
    out = {}
    if bd_ms and bd_ms > 0:
        out["mfu_block_decoder_decode"] = (
            m["bd_flops"] / (bd_ms / 1e3)) / PEAK_BF16_FLOPS
        out["hbm_util_block_decoder_decode"] = (
            m["bd_bytes"] / (bd_ms / 1e3)) / PEAK_HBM_GBPS
    if td_ms and td_ms > 0:
        out["mfu_token_decoder_decode"] = (
            m["td_flops"] / (td_ms / 1e3)) / PEAK_BF16_FLOPS
        out["hbm_util_token_decoder_decode"] = (
            m["td_bytes"] / (td_ms / 1e3)) / PEAK_HBM_GBPS
    if bd_ms and td_ms:
        out["mfu_decode"] = ((m["bd_flops"] + m["td_flops"])
                             / ((bd_ms + td_ms) / 1e3)) / PEAK_BF16_FLOPS
        out["hbm_util_decode"] = ((m["bd_bytes"] + m["td_bytes"])
                                  / ((bd_ms + td_ms) / 1e3)) / PEAK_HBM_GBPS
    if prefill_ms:
        p = prefill_model(cfg, batch, prefill)
        out["mfu_prefill"] = (
            p["prefill_flops"] / (prefill_ms / 1e3)) / PEAK_BF16_FLOPS
    if headline_tok_per_s and headline_batch:
        hm = decode_stage_model(cfg, headline_batch, prefill, decode,
                                kv_cache, quantize)
        out["mfu_decode_headline"] = (
            headline_tok_per_s * hm["flops_per_token"]) / PEAK_BF16_FLOPS
    return out
