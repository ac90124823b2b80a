"""Per-kernel microbenchmark at the decode shapes (port of
``scripts/kernel_microbench.py``): each hand kernel beside its plain
PyTorch version and one PyTorch library call computing the same function
(the yardsticks of PERF.md's kernel table), on the 1.2B operating point:

- K1 and K4 (INT8 / INT4 weights, ``kernels/dequant_matmul.py``) at the
  1.2B decode shapes at batch M = 256: qkv, attn out, mlp up and down, 12
  layers a stack, and the LM head (unless ``--quick``); the library call is
  ``torch.matmul`` on the dequantized layer;
- K2 INT8 (``decode_attention_int8_stacked``) at B = 256 and 64, H = 16,
  cap = 640 (the last 64 slots invalid), one query row, 12 layers; the
  library call SDPA on the dequantized layer;
- K3 (``flash_attention``) causal at B = 8, H = 16, Q = 2048, D = 128; the
  library call SDPA with ``is_causal``.

Each measurement chains ``--iters`` calls with a data dependence (``x *=
1 + 1e-12 * sum(out)``), cycling through the layers, issued from Python
(the JAX script loops inside one ``jit``); the best of three runs, by CUDA
events behind a spin of the card (``us``, the host's launch cost left out)
and by the host clock (``wall_us``). Each row keeps the JAX script's keys
(``op``, ``variant``, ``us``, ``GB/s`` or ``TFLOP/s``) and adds the bound
(``bound_us``, ``bound_by``: each input this run's data needs read and
each output written once against 3.35 TB/s, K2's cache rows only where the
mask lets a query see them, and the operations that data needs against 989
TFLOP/s bf16; ``GB/s`` keeps the JAX script's byte count, K2's whole
cache). ``platform`` is the card's name and power limit (``nvidia-smi``).

Inputs: the JAX script's distributions (numpy's ``default_rng(0/1/2/3)``
there) drawn on the run's device from a ``torch.Generator`` of the same
seed (numpy takes ~13 ns an element: ~110 s for K2's B = 256 caches
alone). ``--cpu_interpret`` keeps its JAX meaning: tiny matmul shapes on
the CPU, here through the plain versions.

Writes ``--out`` (MICROBENCH.json) and prints a table. The JAX script's
TPU figures are not carried over.

    python -m block_transformer_tpu_torch.scripts.kernel_microbench
    python -m block_transformer_tpu_torch.scripts.kernel_microbench \\
        --iters 16 --quick
"""

from __future__ import annotations

import argparse
import json

import torch

from block_transformer_tpu_torch.kernels import decode_attention as k2
from block_transformer_tpu_torch.kernels import dequant_matmul as dm
from block_transformer_tpu_torch.kernels import flash_attention as fa
from block_transformer_tpu_torch.ops import masks, quant
from block_transformer_tpu_torch.utils import profiling, roofline


def _normal(g, shape, dtype):
    return torch.randn(shape, generator=g, device=g.device).to(dtype)


def _int8(g, lo: int, hi: int, shape):
    """int8 in [lo, hi)."""
    return torch.randint(lo, hi, shape, generator=g, device=g.device,
                         dtype=torch.int8)


def _uniform(g, lo: float, hi: float, shape):
    """float32 in [lo, hi)."""
    return torch.empty(shape, device=g.device).uniform_(lo, hi, generator=g)


def _bound_us(nbytes: float, ops: float):
    t_bytes = nbytes / roofline.PEAK_HBM_GBPS
    t_ops = ops / roofline.PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timed_loop(fn, carry, iters, device="cuda"):
    """Best of 3 of (time for ``iters`` chained applications of fn) /
    iters, as (device s or None off the card, wall s)."""
    dev, wall = profiling.event_timed(lambda: fn(carry), device, reps=3)
    return (None if dev is None else dev / iters), wall / iters


def _chain(call, iters: int, L: int):
    def run(x):
        for i in range(iters):
            out = call(x, i % L)
            x = x * (1.0 + 1e-12 * torch.sum(out).to(x.dtype))
        return x
    return run


def _rows(results, op, variants, x, iters, L, nbytes, flops, need):
    """Time each variant's chain; one row a variant, with GB/s of
    ``nbytes`` and TFLOP/s of ``flops`` (the JAX script's counts) where
    given, and the bound of ``need`` (bytes moved, operations)."""
    bound_us, bound_by = _bound_us(*need)
    for name, call in variants.items():
        dev, wall = timed_loop(_chain(call, iters, L), x, iters, x.device)
        t = wall if dev is None else dev
        row = {"op": op, "variant": name, "us": 1e6 * t,
               "wall_us": 1e6 * wall, "bound_us": bound_us,
               "bound_by": bound_by}
        if nbytes is not None:
            row["GB/s"] = nbytes / t / 1e9
        if flops is not None:
            row["TFLOP/s"] = flops / t / 1e12
        results.append(row)


def int8_matmul_inputs(L, M, K, N, dtype, device):
    """(x [M, K], w int8 [L, K, N], s f32 [L, N]) of seed 0."""
    g = torch.Generator(device).manual_seed(0)
    return (_normal(g, (M, K), dtype), _int8(g, -127, 127, (L, K, N)),
            _uniform(g, 0.01, 0.02, (L, N)))


def int8_matmul_variants(x, w, s):
    """{variant: call(x, layer)}: K1, its plain version, ``torch.matmul``
    on the dequantized layer."""
    w_deq = quant.dequantize_int8(w, s, x.dtype)
    return {"kernel": lambda x, i: dm.int8_matmul_stacked(x, w, s, i),
            "plain": lambda x, i: dm.int8_matmul_stacked_plain(x, w, s, i),
            "library": lambda x, i: torch.matmul(x, w_deq[i])}


def bench_int8_matmul(results, L, M, K, N, iters, dtype, device="cuda"):
    x, w, s = int8_matmul_inputs(L, M, K, N, dtype, device)
    size = x.element_size()
    bytes_per = M * K * size + K * N + N * 4 + M * N * size
    _rows(results, f"int8_matmul M{M} K{K} N{N}",
          int8_matmul_variants(x, w, s), x, iters, w.shape[0], bytes_per,
          2 * M * K * N, (bytes_per, 2 * M * K * N))


def int4_matmul_inputs(L, M, K, N, dtype, device):
    """(x [M, K], w split-half packed int8 [L, K/2, N], s f32 [L, N]) of
    seed 1."""
    g = torch.Generator(device).manual_seed(1)
    return (_normal(g, (M, K), dtype), _int8(g, -120, 120, (L, K // 2, N)),
            _uniform(g, 0.01, 0.02, (L, N)))


def int4_matmul_variants(x, w, s):
    """{variant: call(x, layer)}: K4, its plain version, ``torch.matmul``
    on the dequantized layer."""
    w_deq = torch.stack([quant.dequantize_int4(w[i], s[i], x.dtype)
                         for i in range(w.shape[0])])
    return {"kernel": lambda x, i: dm.int4_matmul_stacked(x, w, s, i),
            "plain": lambda x, i: dm.int4_matmul_stacked_plain(x, w, s, i),
            "library": lambda x, i: torch.matmul(x, w_deq[i])}


def bench_int4_matmul(results, L, M, K, N, iters, dtype, device="cuda"):
    x, w, s = int4_matmul_inputs(L, M, K, N, dtype, device)
    size = x.element_size()
    bytes_per = M * K * size + K * N // 2 + N * 4 + M * N * size
    _rows(results, f"int4_matmul M{M} K{K} N{N}",
          int4_matmul_variants(x, w, s), x, iters, w.shape[0], bytes_per,
          2 * M * K * N, (bytes_per, 2 * M * K * N))


def decode_attention_inputs(L, B, H, cap, D, S, dtype, device):
    """(q0 [B, H, S, D], kq, ks, vq, vs: an INT8 cache [L, B, H, cap, D]
    with scales, mask: S queries at the end of ``cap - 64`` valid slots) of
    seed 2."""
    g = torch.Generator(device).manual_seed(2)
    q0 = _normal(g, (B, H, S, D), dtype)
    kq = _int8(g, -127, 127, (L, B, H, cap, D))
    vq = _int8(g, -127, 127, (L, B, H, cap, D))
    ks = _uniform(g, 0.005, 0.02, (L, B, H, cap))
    vs = _uniform(g, 0.005, 0.02, (L, B, H, cap))
    valid_len = cap - 64
    kv_valid = (torch.arange(cap, device=device)[None] < valid_len).to(
        torch.int32).repeat(B, 1)
    mask = masks.decode_mask(valid_len - S, cap, S, kv_valid, device=device)
    return q0, kq, ks, vq, vs, mask


def decode_attention_variants(kq, ks, vq, vs, mask, dtype):
    """{variant: call(q, layer)}: K2 INT8, its plain version, SDPA on the
    dequantized layer (dequantized once, beforehand)."""
    kd = torch.stack([quant.dequantize_kv(kq[i], ks[i], dtype)
                      for i in range(kq.shape[0])])
    vd = torch.stack([quant.dequantize_kv(vq[i], vs[i], dtype)
                      for i in range(vq.shape[0])])
    allowed = mask.allowed()[:, None]            # [B, 1, S, cap]
    return {
        "kernel": lambda q, i: k2.decode_attention_int8_stacked(
            q, kq, ks, vq, vs, i, mask),
        "plain": lambda q, i: k2.decode_attention_int8_stacked_plain(
            q, kq, ks, vq, vs, i, mask),
        "library": lambda q, i: torch.nn.functional.
        scaled_dot_product_attention(q, kd[i], vd[i], attn_mask=allowed)}


def bench_decode_attention(results, L, B, H, cap, D, S, iters, dtype,
                           device="cuda"):
    q0, kq, ks, vq, vs, mask = decode_attention_inputs(L, B, H, cap, D, S,
                                                       dtype, device)
    variants = decode_attention_variants(kq, ks, vq, vs, mask, dtype)
    bytes_per = B * H * cap * (2 * D + 8)    # int8 K+V once + scales
    allowed = mask.allowed().expand(B, -1, -1)         # [B, S, cap]
    rows = H * int(allowed.any(1).sum())     # K (and V) rows a query sees
    need = (2 * rows * (D + 4) + 2 * q0.numel() * q0.element_size(),
            4 * H * D * int(allowed.sum()))
    _rows(results, f"decode_attn_int8 B{B} H{H} cap{cap} S{S}", variants,
          q0, iters, kq.shape[0], bytes_per, None, need)
    del variants


def flash_prefill_inputs(B, H, Q, D, dtype, device):
    """(q0, k, v [B, H, Q, D], the causal mask) of seed 3."""
    g = torch.Generator(device).manual_seed(3)
    q0, k, v = (_normal(g, (B, H, Q, D), dtype) for _ in range(3))
    pos = torch.arange(Q, dtype=torch.int32, device=device)
    return q0, k, v, masks.causal_mask(pos, pos)


def flash_prefill_variants(k, v, mask):
    """{variant: call(q, layer)}: K3, its plain version, SDPA causal."""
    return {
        "kernel": lambda q, i: fa.flash_attention(q, k, v, mask),
        "plain": lambda q, i: fa.flash_attention_plain(q, k, v, mask),
        "library": lambda q, i: torch.nn.functional.
        scaled_dot_product_attention(q, k, v, is_causal=True)}


def bench_flash_prefill(results, B, H, Q, D, iters, dtype, device="cuda"):
    q0, k, v, mask = flash_prefill_inputs(B, H, Q, D, dtype, device)
    flops = 4 * B * H * Q * Q * D
    nbytes = 4 * B * H * Q * D * q0.element_size()     # q, k, v, out
    need = 4 * B * H * (Q * (Q + 1) // 2) * D            # causal pairs
    _rows(results, f"flash_prefill B{B} H{H} Q{Q}",
          flash_prefill_variants(k, v, mask), q0, iters, 1, None, flops,
          (nbytes, need))


def main(argv=None) -> dict:
    """Run the suite; returns {"results": rows, "platform": card} (also
    written to ``--out``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--attn_only", action="store_true")
    ap.add_argument("--out", default="MICROBENCH.json")
    ap.add_argument("--cpu_interpret", action="store_true",
                    help="smoke the harness on the CPU (tiny shapes, the "
                    "plain versions)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions) instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.scripts import quality_run as qr
    device = "cpu" if args.cpu_interpret else qr.device_of(args)
    qr.log_device("microbench", device)
    dtype = torch.float32 if args.cpu_interpret else torch.bfloat16
    platform = profiling.card_label(device)
    results = []
    it = args.iters

    def flush():
        with open(args.out, "w") as f:
            json.dump({"results": results, "platform": platform}, f,
                      indent=2)

    with torch.no_grad():
        if args.cpu_interpret:
            bench_int8_matmul(results, 2, 8, 256, 128, 2, dtype, device)
            bench_int4_matmul(results, 2, 8, 256, 128, 2, dtype, device)
        else:
            # 1.2B decode shapes: batch 256 rows through QKV/out/up/down
            # + head
            shapes = [(12, 256, 2048, 6144), (12, 256, 2048, 2048),
                      (12, 256, 2048, 8192), (12, 256, 8192, 2048)]
            if not args.quick:
                shapes.append((1, 256, 2048, 50304))    # LM head
            for (L, M, K, N) in ([] if args.attn_only else shapes):
                bench_int8_matmul(results, L, M, K, N, it, dtype, device)
                bench_int4_matmul(results, L, M, K, N, it, dtype, device)
                print(f"[microbench] matmuls K{K} N{N} done", flush=True)
                flush()
            bench_decode_attention(results, 12, 256, 16, 640, 128, 1, it,
                                   dtype, device)
            flush()
            if not args.quick and not args.attn_only:
                bench_decode_attention(results, 12, 64, 16, 640, 128, 1, it,
                                       dtype, device)
                flush()
                bench_flash_prefill(results, 8, 16, 2048, 128,
                                    max(4, it // 8), dtype, device)
            print("[microbench] attention done", flush=True)
    flush()
    width = max(len(r["op"]) for r in results) + 2
    print(f"{'op':{width}s} {'variant':10s} {'us':>10s} {'GB/s':>8s} "
          f"{'TFLOP/s':>9s} {'bound us':>9s}")
    for r in results:
        print(f"{r['op']:{width}s} {r['variant']:10s} {r['us']:10.1f} "
              f"{r.get('GB/s', float('nan')):8.1f} "
              f"{r.get('TFLOP/s', float('nan')):9.2f} {r['bound_us']:9.2f}")
    print(f"platform: {platform}")
    return {"results": results, "platform": platform}


if __name__ == "__main__":
    main()
