#!/usr/bin/env python3
"""Drive the PyTorch port (``block_transformer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one. In
one process it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels K1-K3 from ``block_transformer_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints ptxas's register and
   spill lines;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes generation with ``block_main_b4_1.2b`` at B=8, prompt 2048 tokens
   and 128 new tokens gives it, in bf16, and times kernel, plain version,
   one PyTorch library call computing the same function (a yardstick only:
   the port never calls it) and the bound from the shapes;
4. checks the port on the card against the same port on the CPU (plain
   versions) at a small configuration in float32: forward logits, and
   greedy tokens of INT8-weight, INT8-KV generation;
5. generates with ``block_main_b4_1.2b`` at full width (random weights from
   a seed, bf16, INT8 weights, INT8 global KV cache), greedy, B=8,
   p2048/d128: one warm-up run, then a timed run between launch-count
   resets, and asserts every kernel ran in it.

The second-to-last line is a JSON object listing each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``. Any
failure raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from block_transformer_tpu_torch import config  # noqa: E402
from block_transformer_tpu_torch import profile_generate as pg  # noqa: E402
from block_transformer_tpu_torch.inference import generate as gen  # noqa: E402
from block_transformer_tpu_torch.kernels import build  # noqa: E402
from block_transformer_tpu_torch.kernels import decode_attention as k2  # noqa: E402
from block_transformer_tpu_torch.kernels import dequant_matmul as k1  # noqa: E402
from block_transformer_tpu_torch.kernels import flash_attention as k3  # noqa: E402
from block_transformer_tpu_torch.models import block_transformer as bt  # noqa: E402
from block_transformer_tpu_torch.ops import masks  # noqa: E402
from block_transformer_tpu_torch.ops import quant  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TOL = 2e-2      # max |kernel - plain| / max |plain| in bf16 (~2^-8 rounding
                # of outputs and probabilities, summed in another order)

MODEL, BATCH = pg.MODEL, pg.BATCH
PROMPT_TOKENS, NEW_TOKENS = pg.PROMPT_TOKENS, pg.NEW_TOKENS
KERNELS = [
    (k1.int8_matmul_stacked, "K1", "block_transformer_tpu_torch/csrc/dequant_matmul.cu",
     "block_transformer_tpu/ops/dequant_matmul.py:86"),
    (k2.decode_attention_int8_stacked, "K2",
     "block_transformer_tpu_torch/csrc/decode_attention.cu",
     "block_transformer_tpu/ops/decode_attention.py:143"),
    (k3.flash_attention, "K3", "block_transformer_tpu_torch/csrc/flash_attention.cu",
     "block_transformer_tpu/ops/flash_attention.py:83"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_need(mask: masks.AttnMask, H: int, D: int):
    """What masked attention needs on this mask's data, summed over heads:
    (key rows read, value rows read, operations). A key is read when some
    query of its batch row may see it; a query with no allowed key takes
    the uniform mean of all values, so its batch row reads every value."""
    allowed = mask.allowed()                   # [B, Q, K]
    K = allowed.shape[-1]
    seen = allowed.any(1)                      # [B, K]
    empty = ~allowed.any(-1)                   # [B, Q]
    k_rows = seen.sum().item()
    v_rows = torch.where(empty.any(-1), K, seen.sum(-1)).sum().item()
    ops = 4 * D * allowed.sum().item() + D * K * empty.sum().item()
    return H * k_rows, H * v_rows, H * ops


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if err > TOL * scale:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} > "
                             f"{TOL} * max|plain| {scale:.3e}")
    return err


def record(rows, kernel, label, err, ms, plain_ms, library_ms, nbytes, flops):
    fn, tag, source, replaces = next(k for k in KERNELS if k[0] is kernel)
    bound_ms, bound_by = bound(nbytes, flops)
    rows.append({"name": f"{tag} {fn.__name__} [{label}]", "route": "cuda",
                 "source": source, "replaces": replaces, "launches": None,
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": library_ms})
    log(f"{tag} [{label}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"max_abs_err {err:.3e}")


def phase_k1(rows, cfg):
    """K1 at the main path's shapes, cycling through a 12-layer stack so the
    weights come from device memory, as in the layer loop, not from L2."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    h, m, L = cfg.block_decoder.hidden_size, cfg.block_decoder.intermediate_size, 12
    V = cfg.vocab_size
    shapes = [("qkv M=8", 8, h, 3 * h, L), ("mlp_down M=8", 8, m, h, L),
              ("lm_head M=8", 8, h, V, 1), ("qkv M=4096", 4096, h, 3 * h, L)]
    for label, M, K, N, layers in shapes:
        w = quant.quantize_int8(torch.randn((layers, K, N), generator=g,
                                            device=dev, dtype=bf16) * 0.02)
        w_q, scale = w
        x = torch.randn((M, K), generator=g, device=dev, dtype=bf16)
        w_deq = [quant.dequantize_int8(w_q[i], scale[i], bf16)
                 for i in range(layers)]
        got = k1.int8_matmul_stacked(x, w_q, scale, layers - 1)
        want = k1.int8_matmul_stacked_plain(x, w_q, scale, layers - 1)
        err = compare(f"K1 {label}", got, want)
        it = iter(range(10 ** 9))
        nxt = lambda: next(it) % layers          # noqa: E731
        iters = 10 if M > 64 else 60
        ms = time_ms(lambda: k1.int8_matmul_stacked(x, w_q, scale, nxt()),
                     iters)
        plain_ms = time_ms(lambda: k1.int8_matmul_stacked_plain(
            x, w_q, scale, nxt()), iters)
        lib_ms = time_ms(lambda: torch.matmul(x, w_deq[nxt()]), iters)
        nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
        record(rows, k1.int8_matmul_stacked, label, err, ms, plain_ms, lib_ms,
               nbytes, 2 * M * K * N)
        del w_q, scale, w_deq


def phase_k2(rows, cfg):
    """K2 at the block decoder's decode step: B=8, H=16, S=1, D=128, a
    12-layer cache of capacity 640 filled to 530 slots, layer 5, some rows
    finished (kv_valid 0 on their last slots) and some left-padded."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, D = BATCH, cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    L, cap, filled, S = 12, 640, 530, 1
    kv = torch.randn((2, L, B, H, cap, D), generator=g, device=dev)
    kq, ks = quant.quantize_kv(kv[0].reshape(L * B, H, cap, D))
    vq, vs = quant.quantize_kv(kv[1].reshape(L * B, H, cap, D))
    kq, vq = kq.reshape(L, B, H, cap, D), vq.reshape(L, B, H, cap, D)
    ks, vs = ks.reshape(L, B, H, cap), vs.reshape(L, B, H, cap)
    q = torch.randn((B, H, S, D), generator=g, device=dev, dtype=bf16)
    valid = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, 16 * b:filled] = 1           # left pad of 16*b blocks
    valid[B - 2:, filled - 4:filled] = 0       # finished rows
    valid[0] = 0                               # a row with no allowed key
    mask = masks.block_decode_mask(filled - 1, cap, S, valid)
    got = k2.decode_attention_int8_stacked(q, kq, ks, vq, vs, 5, mask)
    want = k2.decode_attention_int8_stacked_plain(q, kq, ks, vq, vs, 5, mask)
    err = compare("K2", got, want)
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % L                 # noqa: E731
    ms = time_ms(lambda: k2.decode_attention_int8_stacked(
        q, kq, ks, vq, vs, nxt(), mask), 100)
    plain_ms = time_ms(lambda: k2.decode_attention_int8_stacked_plain(
        q, kq, ks, vq, vs, nxt(), mask), 20)
    k_deq = [(kq[i].float() * ks[i][..., None]).to(bf16) for i in range(L)]
    v_deq = [(vq[i].float() * vs[i][..., None]).to(bf16) for i in range(L)]
    allowed = mask.allowed()[:, None]          # [B, 1, S, cap]

    def library():
        i = nxt()
        return torch.nn.functional.scaled_dot_product_attention(
            q, k_deq[i], v_deq[i], attn_mask=allowed)

    lib_ms = time_ms(library, 100)
    k_rows, v_rows, ops = attention_need(mask, H, D)
    nbytes = (2 * B * H * S * D * 2 + (k_rows + v_rows) * (D + 4)
              + (B * S + cap + B * cap) * 4)
    record(rows, k2.decode_attention_int8_stacked, "B=8 H=16 S=1 cap=640",
           err, ms, plain_ms, lib_ms, nbytes, ops)


def phase_k3(rows, cfg):
    """K3 at the fresh prefill's first query tile: B=8, H=16, 128 queries
    against the 512 prompt blocks, D=128, block-causal, with left-padded
    rows (their first queries have no allowed key)."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    B, H, D = BATCH, cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    Q, K = 128, PROMPT_TOKENS // cfg.block_length
    copies = 4
    qkv = [torch.randn((3, B, H, K, D), generator=g, device=dev, dtype=bf16)
           for _ in range(copies)]
    qs = [t[0, :, :, :Q].contiguous() for t in qkv]
    valid = torch.ones((B, K), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, :13 * b] = 0                  # left pad of 13*b blocks
    full = masks.block_decode_mask(0, K, K, valid)
    mask = masks.AttnMask(full.q_idx[:Q], full.kv_idx, full.kv_valid)
    got = k3.flash_attention(qs[0], qkv[0][1], qkv[0][2], mask)
    want = k3.flash_attention_plain(qs[0], qkv[0][1], qkv[0][2], mask)
    err = compare("K3", got, want)
    it = iter(range(10 ** 9))

    def pick():
        i = next(it) % copies
        return qs[i], qkv[i][1], qkv[i][2]

    ms = time_ms(lambda: k3.flash_attention(*pick(), mask), 50)
    plain_ms = time_ms(lambda: k3.flash_attention_plain(*pick(), mask), 20)
    allowed = mask.allowed()[:, None]          # [B, 1, Q, K]
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *pick(), attn_mask=allowed), 50)
    k_rows, v_rows, ops = attention_need(mask, H, D)
    nbytes = ((2 * B * H * Q + k_rows + v_rows) * D * 2
              + (B * Q + K + B * K) * 4)
    record(rows, k3.flash_attention, "B=8 H=16 Q=128 K=512", err, ms,
           plain_ms, lib_ms, nbytes, ops)


def phase_small_reference():
    """The port on the card (kernels) against the port on the CPU (plain
    versions), small configuration, float32."""
    cfg = config.make_block_config("smoke", 128, 2, vocab_size=512)
    params = bt.init_block_transformer_params(0, cfg, device="cpu")
    qparams = quant.quantize_block_transformer(params, bits=8)
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}  # noqa: E731
                        if isinstance(t, dict) else t.cuda())
    rng = np.random.default_rng(0)
    B, N, L = 2, 12, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, :2], att[1, :2] = 0, 0              # a left-padded row
    bam = att.any(-1).astype(np.int32)
    args = [torch.from_numpy(a) for a in (ids, att, bam)]
    want = bt.block_transformer_forward(qparams, cfg, *args).logits
    got = bt.block_transformer_forward(to_dev(qparams), cfg,
                                       *[a.cuda() for a in args]).logits
    err = (got.cpu() - want).abs().max().item()
    if err > 1e-3:
        raise AssertionError(f"small forward: card vs CPU logits differ by {err}")
    run = lambda p, d: gen.generate_blocks(  # noqa: E731
        p, cfg, ids, att, bam, max_blocks=N + 4, kv_cache="int8", device=d)
    t_cpu, t_gpu = run(qparams, "cpu"), run(to_dev(qparams), "cuda")
    if t_cpu.n_blocks != t_gpu.n_blocks or not torch.equal(
            t_cpu.tokens, t_gpu.tokens.cpu()):
        raise AssertionError("small generation: card and CPU tokens differ")
    log(f"small reference: logits max err {err:.3e}, greedy tokens equal "
        f"({t_gpu.n_blocks} blocks)")


def reset_launches():
    for fn, *_ in KERNELS:
        fn.launches = 0


def phase_generation():
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = pg.main_path_model(seed=0)
    torch.cuda.synchronize()
    log(f"{MODEL}: random init + INT8 quantization on the card "
        f"{time.perf_counter() - t0:.2f} s")
    ids, att, bam = pg.ragged_prompts(cfg, BATCH, PROMPT_TOKENS, seed=0)
    L, N = cfg.block_length, ids.shape[1]
    max_blocks = N + NEW_TOKENS // L

    def run():
        return gen.generate_blocks(params, cfg, ids, att, bam,
                                   max_blocks=max_blocks, kv_cache="int8",
                                   device="cuda")

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn, *_ in KERNELS}

    toks = res.tokens
    if tuple(toks.shape) != (BATCH, max_blocks, L):
        raise AssertionError(f"tokens shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("tokens out of [0, vocab)")
    if not torch.equal(toks[:, :N].cpu(), torch.from_numpy(ids)):
        raise AssertionError("prompt blocks were not kept")
    generated = BATCH * (res.n_blocks - N) * L
    log(f"{MODEL} generate_blocks B={BATCH} p{PROMPT_TOKENS}/d{NEW_TOKENS} "
        f"int8 weights + int8 KV: {res.n_blocks - N} blocks generated; warm-up "
        f"run {warm_s:.2f} s; timed run {secs:.3f} s = "
        f"{generated / secs:.1f} tok/s (prefill included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches in the timed run: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    # float32 products are compared against each other: keep them in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    took = build.build_all(["dequant_matmul", "decode_attention",
                            "flash_attention"])
    log(f"kernel build {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    cfg = config.get_config(MODEL)
    rows = []
    phase_k1(rows, cfg)
    phase_k2(rows, cfg)
    phase_k3(rows, cfg)
    phase_small_reference()
    launches = phase_generation()
    for row in rows:
        row["launches"] = launches[row["name"].split()[1]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
