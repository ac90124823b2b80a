#!/usr/bin/env python3
"""Drive the PyTorch port (``block_transformer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one. In
one process it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels K1-K8, W8A8-q and W8A8-mm from
   ``block_transformer_tpu_torch/csrc`` (one ``nvcc`` per source, in
   parallel) and prints ptxas's register and spill lines;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes its main path gives it, in bf16, and times kernel, plain version,
   one PyTorch library call computing the same function (a yardstick only:
   the port never calls it) and the bound from the data (device times, with
   the launch queue filled first so that host cost is left out; K1 and K4
   rows also give their wrapper's host microseconds a call): K1-K4 at
   generation with ``block_main_b4_1.2b`` at B=8, prompt 2048 tokens and
   128 new tokens (K1 and K4 at decode M = 8, the token decoder's M = 32
   prefix step and the M = 4096 prefill, each row naming the route, tile
   and split ``plan`` gave it; K2 at the block decoder's decode step and K3
   at the prefill's first and last query tiles); K2's bf16 form at the
   block decoder's decode step over a bf16 cache (split route) and at the
   token decoder's local cache, its token step and its prefix step (warp
   route); K2 and K3 also at the ``vanilla_410`` baseline's decode step
   (D = 64, capacity 2176) and prompt (Q = 2048 causal), each K2 row
   naming its route and split of the cache and each K3 row its route;
   W8A8-q and W8A8-mm (bit for bit) at the prefill's linears, the block
   decoder's four at M = 4096 and the baseline's qkv at M = 16384, beside
   ``torch._int_mm`` and K1 at the same shape (each W8A8-mm row naming
   the route, tile, splits and grid ``plan`` gave it, its wrapper's host
   microseconds a call and its share of the int8 peak), then the W8A8
   pair against K1 at M from 256 to 4096 (``w8a8_crossover``, one JSON
   line);
   K5-K8 at the serving engine's shapes (16 slots, 12 layers, 16 heads of
   128, capacity 640 contiguous, 3 pages of 256 paged), K6 and K8 also on
   the packed INT4 pool, each K6 row naming its split of the virtual slots;
   then the ablation families' new shapes (hidden 768, heads of 64):
   W8A8-q/-mm at ``block_uniform_b4_85``'s prefill qkv (M = 2344, bit for
   bit), K3 at its last, partial query tile (Q = 37 of K = 293), K2 bf16
   at its local cache (capacity 9, warp route), K2 INT8 at
   ``block_megabyte_b4_85``'s decode step (capacity 640) and K1 at its
   token decoder's qkv (M = 32, K = 512, N = 1536);
   then an empty kernel's launch, timed the same way, printed on its own
   line as ``launch_floor_ms`` beside the card's name and power limit;
4. checks the port on the card against the same port on the CPU (plain
   versions) at a small configuration in float32: forward logits, greedy
   tokens of INT8-weight generation with the INT8, INT4 and bf16 global
   caches, of INT4- and mixed48-weight INT8-KV generation, of the vanilla
   baseline (INT8 and INT4 weights, INT8 KV), of the serving engine
   with each of its four quantized caches (contiguous INT8 and INT4, paged
   INT8 and INT4), of ``block_main_b4_5`` (INT8) with W8A8 at every M, and
   of the streaming prefill on the bf16, INT8 and INT4 caches; then the
   quantization workflow at ``block_main_b4_5``: two train steps, plain
   and QAT ``mixed48`` (loss, grad_norm and every parameter leaf within
   1e-5 relative of the CPU's), and GPTQ INT4 trees (at least 99.9% of Q
   equal to the CPU's, the rest one step apart, the differences counted);
   then every ablation family at a small size (INT8 weights): forward
   logits within TOL, and greedy tokens equal with the INT8 global cache
   (the RoBERTa, RoBERTa-CLS and T5 embedders, the projection layer, the
   summation and T5 cross-attention token decoders) or, for the GPT-Neo
   block decoder, the unquantized cache through the streaming prefill;
5. generates with ``block_main_b4_1.2b`` at full width (random weights from
   a seed, bf16), greedy, B=8, p2048/d128: INT8 weights with the INT8,
   bf16 and INT4 global caches, then INT4 weights (no K1 launch) and
   mixed48 weights (block decoder and head INT8, token decoder INT4) with
   the INT8 cache, and INT8 weights with the streaming prefill (4 chunks
   of 128 blocks through the INT8 cache): each one warm-up run, then a
   timed run between launch-count resets, asserting every kernel of the
   path ran in it (and none it must not run), and that W8A8 took the 48
   prefill linears of each fresh prefill with INT8 block-decoder weights
   (M = 4096; none of the streaming chunks, M = 1024 under the INT8 cache)
   and K1 every other INT8 linear;
6. serves with ``ContinuousBatchingEngine`` at the same width (INT8
   weights), 16 slots, 24 requests submitted together (8 of 512 prompt
   tokens and 32 new ones, then 16 of 2048 and 128), once with each cache:
   contiguous INT8 and INT4, paged INT8 and INT4: a short warm-up, then a
   timed ``run()`` between launch-count resets; asserts every request is
   served and every kernel of the path ran, and logs how far the
   contiguous and paged caches of one width agree; then runs one
   block-decoder decode step from identical prefilled K/V through the
   contiguous and the paged stack of each width (K2 + K5 against K6 with
   the fresh term + K7; the INT4 cache against K6 INT4) and asserts the
   outputs agree within ``TOL`` of their largest magnitude;
7. generates greedily with the ``vanilla_410`` baseline (INT8 weights, INT8
   KV cache) at the same B, prompt and new tokens, the same way, and prints
   the block/vanilla throughput ratio as a smoke figure;
8. generates with the four shipped ablation configs at full width
   (``FAMILY_NAMES``, read by the port's YAML loader:
   ``block_megabyte_b4_85``,
   ``block_ablation_b4_85_cls_cross_attn``, ``block_uniform_b4_85``,
   ``block_ablation_b4_85_roberta_prefix``; random bf16 weights from a
   seed, INT8 weights and global cache, greedy, B=8, 2048 prompt tokens
   rounded up to whole blocks, 128 new ones): one warm-up run, a timed run
   between launch-count resets (K1, K2, K3 and W8A8 on their main routes
   in every one; K2's bf16 form by the warp route on the local cache of
   the two prefix decoders and not on the two re-run ones), then the
   prefill alone and a run with the inner loop timed, each logged with
   run s, tok/s and prefill s and as one JSON line;
9. trains ``block_main_b4_1.2b`` at full width (random float32 weights from
   a seed, two sequences of 2048 tokens, remat, TF32 off): 3 steps, then 3
   QAT ``mixed48`` steps from a fresh optimizer, each logged with its ms,
   tokens per second, peak memory and loss, asserting finite losses and
   that no kernel launched (K3 included: attention under autograd stays on
   the plain path); quantizes the fine-tuned weights with the recipe and
   generates from them as in step 5 (W8A8 at the prefill and K1 for the
   INT8 block decoder and head, K4 for the INT4 token decoder); then runs
   GPTQ INT4 g128 on the card from the same two sequences, logging each
   trunk's calibration and rounding seconds and the layer-output error of
   GPTQ and RTN for the first and last layers' four linears, and generates
   from the GPTQ tree (K4 only, no K1);
10. trains through the training loop (``phase_trainer``; checkpoints under
   a temporary directory of ``build/``, removed afterwards): the native
   packer against numpy on 2048-token samples; (d) a tiny trainer (hidden
   64, accumulation 2, ramp-up 2) 3 steps on the card and on the CPU from
   one initial state, float32, every record within 1e-4 relative; (a)
   ``block_main_b4_1.2b`` through ``pretrain_block_transformer.main`` with
   ``configs/block_main_b4_1.2b.yaml`` (bf16), a synthetic corpus and
   2048-token samples, batch 2, 2 steps; (b) the same model through
   ``Trainer``, total batch 4 of micro 2, ramp-up 1, 3 steps saving at
   step 2, then a second ``Trainer`` resumed from it to step 3 (its loss
   within 1e-3 relative of the uninterrupted run's), each step's s and
   tokens/s, peak memory, checkpoint bytes and save / restore s; (c)
   ``vanilla_160`` through ``pretrain_vanilla_transformer.main`` for 2
   steps, its parameters uptrained (``partition``) into
   ``block_uptrain_b4_85_10``'s decoders, 2 steps more; no hand kernel
   may launch in any of them.

Every timed full-width run of steps 5-9 asserts that W8A8-q and W8A8-mm
launched once for each INT8 linear that took W8A8 and K1 once for each
other one (the baseline: its 96 prefill linears at M = 16384 by W8A8),
that K1, K3 and K4 launched by the tensor-core route only and W8A8-mm by
its wgmma route only, and every one with a token decoder that K2's bf16
form took the warp route there (its split route runs only on the bf16
global cache). The last three lines are
the ``nvidia-smi`` line, a JSON object listing each kernel's launches (from
the run of step 5, 6, 7 or 8 named by the row's ``path``; a K6 or K8 row
counts the launches on its pool width, and a K2 bf16 row gives those of its
own route as ``route_launches``), error and times, and
``{"ok": true, "device": {...}}``.
Any failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from block_transformer_tpu_torch import config  # noqa: E402
from block_transformer_tpu_torch import config_yaml  # noqa: E402
from block_transformer_tpu_torch.data import native as native_packer  # noqa: E402
from block_transformer_tpu_torch.data import packing  # noqa: E402
from block_transformer_tpu_torch import profile_generate as pg  # noqa: E402
from block_transformer_tpu_torch.config import NeoXConfig  # noqa: E402
from block_transformer_tpu_torch.inference import generate as gen  # noqa: E402
from block_transformer_tpu_torch.kernels import build  # noqa: E402
from block_transformer_tpu_torch.kernels import decode_attention as k2  # noqa: E402
from block_transformer_tpu_torch.kernels import dequant_matmul as k1  # noqa: E402
from block_transformer_tpu_torch.kernels import flash_attention as k3  # noqa: E402
from block_transformer_tpu_torch.kernels import paged_attention as kp  # noqa: E402
from block_transformer_tpu_torch.kernels import w8a8  # noqa: E402
from block_transformer_tpu_torch.models import block_transformer as bt  # noqa: E402
from block_transformer_tpu_torch.models import embedder as emb  # noqa: E402
from block_transformer_tpu_torch.models import neox  # noqa: E402
from block_transformer_tpu_torch.models import vanilla  # noqa: E402
from block_transformer_tpu_torch.ops import linear as linear_ops  # noqa: E402
from block_transformer_tpu_torch.ops import masks  # noqa: E402
from block_transformer_tpu_torch.ops import gptq  # noqa: E402
from block_transformer_tpu_torch.ops import quant  # noqa: E402
from block_transformer_tpu_torch.train import optimizer as opt  # noqa: E402
from block_transformer_tpu_torch.train import train_step as ts  # noqa: E402
from block_transformer_tpu_torch.train import trainer as trainer_lib  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s and
# int8 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
TOL = 2e-2      # max |kernel - plain| / max |plain| in bf16 (~2^-8 rounding
                # of outputs and probabilities, summed in another order)

MODEL, VANILLA_MODEL, BATCH = pg.MODEL, pg.VANILLA_MODEL, pg.BATCH
GROUP_SIZE = pg.GROUP_SIZE
CARD = "cuda"
PROMPT_TOKENS, NEW_TOKENS = pg.PROMPT_TOKENS, pg.NEW_TOKENS
MATMUL_CU = "block_transformer_tpu_torch/csrc/dequant_matmul.cu"
DECODE_CU = "block_transformer_tpu_torch/csrc/decode_attention.cu"
DECODE_PY = "block_transformer_tpu/ops/decode_attention.py"
PAGED_CU = "block_transformer_tpu_torch/csrc/paged_attention.cu"
PAGED_PY = "block_transformer_tpu/ops/paged_attention.py"
W8A8_CU = "block_transformer_tpu_torch/csrc/w8a8.cu"
# not a TPU kernel: XLA ops in the JAX package (_w8a8_dot)
W8A8_JAX = "block_transformer_tpu/ops/linear.py:219"
# the shipped ablation YAMLs the families phase runs
FAMILY_NAMES = ("block_megabyte_b4_85", "block_ablation_b4_85_cls_cross_attn",
                "block_uniform_b4_85", "block_ablation_b4_85_roberta_prefix")
ROOT = os.path.dirname(os.path.abspath(__file__))


def config_path(name: str) -> str:
    return os.path.join(ROOT, "configs", f"{name}.yaml")


def family_config(name: str) -> config.BlockTransformerConfig:
    """``configs/<name>.yaml`` through the port's loader."""
    return config_yaml.load_block_config_yaml(config_path(name))


# (wrapper, tag, source, TPU kernel replaced, the run whose launches count,
# the pool width whose launches a K6/K8 row counts, else None: all)
KERNELS = [
    (k1.int8_matmul_stacked, "K1", MATMUL_CU,
     "block_transformer_tpu/ops/dequant_matmul.py:86", "generation", None),
    (k2.decode_attention_int8_stacked, "K2", DECODE_CU, f"{DECODE_PY}:143",
     "generation", None),
    (k2.decode_attention_stacked, "K2 bf16", DECODE_CU, f"{DECODE_PY}:293",
     "generation kv bf16", None),
    (k3.flash_attention, "K3", "block_transformer_tpu_torch/csrc/flash_attention.cu",
     "block_transformer_tpu/ops/flash_attention.py:83", "generation", None),
    (k1.int4_matmul_stacked, "K4", MATMUL_CU,
     "block_transformer_tpu/ops/dequant_matmul.py:181", "generation int4",
     None),
    (kp.paged_write_int8, "K5", PAGED_CU, f"{PAGED_PY}:428", "engine int8",
     None),
    (kp.paged_decode_attention_int8, "K6", PAGED_CU, f"{PAGED_PY}:221",
     "engine paged", "int8"),
    (kp.paged_decode_attention_int8, "K6 int4", PAGED_CU, f"{PAGED_PY}:221",
     "engine paged-int4", "int4"),
    (kp.paged_write_layers_int8, "K7", PAGED_CU, f"{PAGED_PY}:549",
     "engine paged", None),
    (kp.paged_page_copy_int8, "K8", PAGED_CU, f"{PAGED_PY}:646",
     "engine paged", "int8"),
    (kp.paged_page_copy_int8, "K8 int4", PAGED_CU, f"{PAGED_PY}:646",
     "engine paged-int4", "int4"),
    (w8a8.w8a8_quant, "W8A8-q", W8A8_CU, W8A8_JAX, "generation", None),
    (w8a8.w8a8_matmul_stacked, "W8A8-mm", W8A8_CU, W8A8_JAX, "generation",
     None),
]
W8A8 = ("W8A8-q", "W8A8-mm")
# the kernels each main path must launch; every path with a token decoder
# runs K2's bf16 form on its local cache
PATH_KERNELS = {
    "generation": ("K1", "K2", "K2 bf16", "K3", *W8A8),
    "generation streaming": ("K1", "K2", "K2 bf16", "K3"),
    "generation int4": ("K2", "K2 bf16", "K3", "K4"),
    "generation mixed48": ("K1", "K2", "K2 bf16", "K3", "K4", *W8A8),
    "generation kv bf16": ("K1", "K2 bf16", "K3", *W8A8),
    "generation kv int4": ("K1", "K2 bf16", "K3", *W8A8),
    "engine int8": ("K1", "K2", "K2 bf16", "K3", "K5", *W8A8),
    "engine int4": ("K1", "K2 bf16", "K3", *W8A8),
    "engine paged": ("K1", "K2 bf16", "K3", "K6", "K7", "K8", *W8A8),
    "engine paged-int4": ("K1", "K2 bf16", "K3", "K6 int4", "K8 int4",
                          *W8A8),
    "vanilla": ("K1", "K2", "K3", *W8A8),
}
# the kernels a main path must not launch: INT4 weights leave K1 no linear;
# the INT4 and bf16 caches take no INT8 cache kernel; the baseline has no
# bf16 cache
PATH_ABSENT = {
    "generation streaming": W8A8,   # chunks of M = 1024 < 2048 (INT8 KV)
    "generation int4": ("K1", *W8A8),
    "generation kv bf16": ("K2",),
    "generation kv int4": ("K2", "K5"),
    "engine int4": ("K2", "K5", "K6", "K6 int4"),
    "engine paged": ("K6 int4", "K8 int4"),
    "engine paged-int4": ("K2", "K5", "K6", "K7", "K8"),
    "vanilla": ("K2 bf16",),
}


def family_path(name: str) -> str:
    return f"family {name}"


def add_family_path(name: str, prefix: bool) -> str:
    """Register an ablation family's run (INT8 weights and global cache) in
    PATH_KERNELS / PATH_ABSENT: K2's bf16 form serves the local cache of
    the prefix decoders; the re-run decoders keep no cache; no INT4
    weights. Returns the path's name."""
    path = family_path(name)
    PATH_KERNELS[path] = ("K1", "K2", "K3", *W8A8) + (
        ("K2 bf16",) if prefix else ())
    PATH_ABSENT[path] = ("K4",) + (() if prefix else ("K2 bf16",))
    return path
# K1, K3, K4 and W8A8-mm count their launches by route as well; a
# full-width path takes the route named here only: the tensor cores ("tc")
# for K1, K3 and K4, wgmma fed by TMA for W8A8-mm
ROUTED = {"K1": (k1.int8_matmul_stacked, "tc"),
          "K3": (k3.flash_attention, "tc"),
          "K4": (k1.int4_matmul_stacked, "tc"),
          "W8A8-mm": (w8a8.w8a8_matmul_stacked, "wgmma")}


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_label(line: str) -> str:
    """A short name for ptxas's mangled entry function: the kernel's name,
    its element type and its integer and bool template arguments, e.g.
    tc_matmul_kernel<16,128,32,16,16,6,3,0> or int8_matmul_kernel<f32,4>."""
    mangled = line.split("'")[1] if "'" in line else line
    m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel)I(.*?)EEv", mangled)
    if m is None:
        return mangled[-40:]
    args = m.group(2)
    kind = ("f32" if args.startswith("f") else
            "bf16" if args.startswith("13__nv_bfloat16") else None)
    return m.group(1) + "<" + ",".join(
        ([kind] if kind else []) + re.findall(r"L[ib](\d+)E", args)) + ">"


def time_ms_host(fn, iters: int):
    """(mean device ms, mean host us) of ``fn`` over ``iters`` calls. The
    device first spins for ~10 ms, so the host has queued the calls before
    the device reaches them: the CUDA events time the device's work alone,
    unless ``fn`` itself waits for the device, and the host clock times
    the calls' host cost."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)              # clock cycles
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_us


def time_ms(fn, iters: int) -> float:
    return time_ms_host(fn, iters)[0]


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """(ms, "bytes" or "operations"): the larger of nbytes over the memory
    rate and flops over ``peak`` (the bf16 tensor-core rate by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_need(mask: masks.AttnMask, H: int, D: int, B: int = 1):
    """What masked attention needs on this mask's data for B batch rows,
    summed over heads: (key rows read, value rows read, operations). A key
    is read when some query of its batch row may see it; a query with no
    allowed key takes the uniform mean of all values, so its batch row
    reads every value."""
    allowed = mask.allowed()                   # [B, Q, K] (B = 1: shared)
    allowed = allowed.expand(max(B, allowed.shape[0]), -1, -1)
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


def record(rows, tag, label, err, ms, plain_ms, library_ms, nbytes, flops,
           plan=None, host_us=None, extra=None, path=None, peak=BF16_FLOPS):
    """One kernel row of the kernel ``tag`` in KERNELS; ``plan`` (K1, K4) is
    the dequant-matmul's launch, ``host_us`` the wrapper's host time a call,
    ``extra`` more keys (K2's split, K3's route), ``path`` the main path
    whose launches the row reports (by default the kernel's own in
    KERNELS)."""
    fn, _, source, replaces, own_path, _ = next(k for k in KERNELS
                                                if k[1] == tag)
    bound_ms, bound_by = bound(nbytes, flops, peak)
    row = {"name": f"{tag} {fn.__name__} [{label}]", "tag": tag,
           "route": "cuda",
           "path": path or own_path, "source": source, "replaces": replaces, "launches": None,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    row.update(extra or {})
    note = "".join(f", {k} {v}" for k, v in (extra or {}).items())
    if plan is not None:
        row["matmul_route"] = (f"{plan.route} {'x'.join(map(str, plan.tile))}"
                               f" splits {plan.splits}")
        note = f", route {row['matmul_route']}"
    if host_us is not None:
        row["host_us"] = host_us
        note += f", host {host_us:.1f} us/call"
    rows.append(row)
    lib = "none" if library_ms is None else f"{library_ms:.5f} ms"
    log(f"{tag} [{label}]: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"library {lib}, bound {bound_ms:.5f} ms ({bound_by}), "
        f"max_abs_err {err:.3e}{note}")


def matmul_plan(M, K, N):
    """K1's / K4's launch plan for bf16 x on this card (K: packed rows for
    K4)."""
    return k1.plan(M, K, N, torch.bfloat16, build.sm_count(0))


def k1_row(rows, g, label, M, K, N, layers, path=None):
    """K1 at x [M, K] @ an INT8 [layers, K, N] stack against its plain
    version and ``torch.matmul`` on the dequantized layer, cycling through
    the layers so the weights come from device memory, as in the layer
    loop, not from L2."""
    dev, bf16 = "cuda", torch.bfloat16
    w_q, scale = quant.quantize_int8(torch.randn((layers, K, N), generator=g,
                                                 device=dev, dtype=bf16)
                                     * 0.02)
    x = torch.randn((M, K), generator=g, device=dev, dtype=bf16)
    w_deq = [quant.dequantize_int8(w_q[i], scale[i], bf16)
             for i in range(layers)]
    got = k1.int8_matmul_stacked(x, w_q, scale, layers - 1)
    want = k1.int8_matmul_stacked_plain(x, w_q, scale, layers - 1)
    err = compare(f"K1 {label}", got, want)
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % layers          # noqa: E731
    iters = 10 if M > 64 else 60
    ms, host_us = time_ms_host(
        lambda: k1.int8_matmul_stacked(x, w_q, scale, nxt()), iters)
    plain_ms = time_ms(lambda: k1.int8_matmul_stacked_plain(
        x, w_q, scale, nxt()), iters)
    lib_ms = time_ms(lambda: torch.matmul(x, w_deq[nxt()]), iters)
    nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
    record(rows, "K1", label, err, ms, plain_ms, lib_ms,
           nbytes, 2 * M * K * N, matmul_plan(M, K, N), host_us, path=path)


def phase_k1(rows, cfg):
    """K1 at the main path's shapes, each over a 12-layer stack (the head
    over one layer)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    h, m, L = cfg.block_decoder.hidden_size, cfg.block_decoder.intermediate_size, 12
    V = cfg.vocab_size
    shapes = [("qkv M=8", 8, h, 3 * h, L), ("mlp_down M=8", 8, m, h, L),
              ("lm_head M=8", 8, h, V, 1), ("qkv M=32", 32, h, 3 * h, L),
              ("qkv M=4096", 4096, h, 3 * h, L)]
    for label, M, K, N, layers in shapes:
        k1_row(rows, g, label, M, K, N, layers)


def phase_k4(rows, cfg):
    """K4 at the INT4 path's shapes (group size 128), cycling through a
    12-layer stack as ``phase_k1`` does."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(4)
    h, m, L = cfg.block_decoder.hidden_size, cfg.block_decoder.intermediate_size, 12
    V = cfg.vocab_size
    shapes = [("qkv M=8", 8, h, 3 * h, L), ("mlp_down M=8", 8, m, h, L),
              ("lm_head M=8", 8, h, V, 1), ("qkv M=32", 32, h, 3 * h, L),
              ("qkv M=4096", 4096, h, 3 * h, L)]
    for label, M, K, N, layers in shapes:
        w_p, scale = quant.quantize_int4(
            torch.randn((layers, K, N), generator=g, device=dev, dtype=bf16)
            * 0.02, pg.GROUP_SIZE)
        G = scale.shape[1]
        x = torch.randn((M, K), generator=g, device=dev, dtype=bf16)
        w_deq = [quant.dequantize_int4(w_p[i], scale[i], bf16)
                 for i in range(layers)]
        got = k1.int4_matmul_stacked(x, w_p, scale, layers - 1)
        want = k1.int4_matmul_stacked_plain(x, w_p, scale, layers - 1)
        err = compare(f"K4 {label}", got, want)
        it = iter(range(10 ** 9))
        nxt = lambda: next(it) % layers          # noqa: E731
        iters = 10 if M > 64 else 60
        ms, host_us = time_ms_host(
            lambda: k1.int4_matmul_stacked(x, w_p, scale, nxt()), iters)
        plain_ms = time_ms(lambda: k1.int4_matmul_stacked_plain(
            x, w_p, scale, nxt()), iters)
        lib_ms = time_ms(lambda: torch.matmul(x, w_deq[nxt()]), iters)
        nbytes = M * K * 2 + K * N // 2 + G * N * 4 + M * N * 2
        record(rows, "K4", f"{label} G={G}", err, ms,
               plain_ms, lib_ms, nbytes, 2 * M * K * N,
               matmul_plan(M, K // 2, N), host_us)
        del w_p, scale, w_deq


def exact_pair(name, got, want) -> None:
    """Bit for bit, as the W8A8 kernels must be."""
    for a, b in zip(got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{name}: kernel and plain differ")


def int_mm_ms(xq, w_q, nxt):
    """(ms, layout) of ``torch._int_mm(xq, w_q[layer])`` cycling through the
    layers (M > 16, K and N multiples of 8): the faster of the row-major
    weights as they are and a column-major copy, each where the library
    takes it."""
    best = None
    for layout in ("row-major", "column-major"):
        ws = [w if layout == "row-major" else w.t().contiguous().t()
              for w in w_q]
        try:
            torch._int_mm(xq, ws[0])
        except RuntimeError as e:                  # a layout it refuses
            log(f"torch._int_mm refuses {layout} weights: {e}")
            continue
        ms = time_ms(lambda: torch._int_mm(xq, ws[nxt()]), 20)
        if best is None or ms < best[0]:
            best = (ms, layout)
    if best is None:
        raise AssertionError("torch._int_mm takes neither layout")
    return best


def w8a8_pair(x, w_q, scale, layer):
    xq, sx = w8a8.w8a8_quant(x)
    return w8a8.w8a8_matmul_stacked(xq, sx, w_q, scale, layer, x.dtype)


def w8a8_rows(rows, g, label, M, K, N, L, path):
    """W8A8-q and W8A8-mm at x [M, K] @ an INT8 [L, K, N] stack: each
    bit-exact against its plain version and timed beside it, beside
    ``torch._int_mm`` (W8A8-mm's library yardstick; W8A8-q has none) and
    beside K1 at the same shape, cycling through the layers. Returns (x,
    w_q, scale, the layer cycler)."""
    dev, bf16 = "cuda", torch.bfloat16
    w_q, scale = quant.quantize_int8(torch.randn(
        (L, K, N), generator=g, device=dev, dtype=bf16) * 0.02)
    x = torch.randn((M, K), generator=g, device=dev, dtype=bf16)
    xq, sx = w8a8.w8a8_quant(x)
    exact_pair(f"W8A8-q {label}", (xq, sx), w8a8.w8a8_quant_plain(x))
    got = w8a8.w8a8_matmul_stacked(xq, sx, w_q, scale, L - 1, bf16)
    exact_pair(f"W8A8-mm {label}", (got,), (
        w8a8.w8a8_matmul_stacked_plain(xq, sx, w_q, scale, L - 1, bf16),))
    del got
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % L             # noqa: E731
    q_ms = time_ms(lambda: w8a8.w8a8_quant(x), 20)
    q_plain = time_ms(lambda: w8a8.w8a8_quant_plain(x), 5)
    mm_ms, mm_host_us = time_ms_host(lambda: w8a8.w8a8_matmul_stacked(
        xq, sx, w_q, scale, nxt(), bf16), 20)
    mm_plain = time_ms(lambda: w8a8.w8a8_matmul_stacked_plain(
        xq, sx, w_q, scale, nxt(), bf16), 3)
    lib_ms, layout = int_mm_ms(xq, w_q, nxt)
    k1_ms = time_ms(lambda: k1.int8_matmul_stacked(x, w_q, scale, nxt()), 10)
    extra = {"k1_ms": k1_ms, "pair_ms": q_ms + mm_ms}
    record(rows, "W8A8-q", f"{label} M={M} K={K}", 0.0, q_ms, q_plain,
           None, M * K * 2 + M * K + M * 4, 0, path=path, extra=extra)
    p = w8a8.plan(M, K, N, build.sm_count(0))
    record(rows, "W8A8-mm", f"{label} M={M} K={K} N={N}", 0.0, mm_ms,
           mm_plain, lib_ms, M * K + K * N + M * 4 + N * 4 + M * N * 2,
           2 * M * K * N, path=path, peak=INT8_OPS, host_us=mm_host_us,
           extra={**extra, "w8a8_plan": (
                      f"{p.route} {'x'.join(map(str, p.tile))} splits "
                      f"{p.splits} blocks {p.blocks}"),
                  "int8_peak_share": 2 * M * K * N / INT8_OPS
                  / (mm_ms * 1e-3),
                  "int_mm_layout": layout})
    return x, w_q, scale, nxt


def phase_w8a8(rows, cfg, vcfg, smi):
    """W8A8-q and W8A8-mm (``w8a8_rows``) at the prefill's linears over a
    12-layer stack: the block decoder's (M = B x 512 prompt blocks = 4096:
    qkv, attn-out, mlp-up, mlp-down) and the baseline's qkv (M = 8 x 2048
    = 16384). Then the crossover on the block decoder's four shapes: the
    W8A8 pair against K1 at M from 256 to 4096, printed as one JSON line
    with the card."""
    g = torch.Generator(device="cuda").manual_seed(13)
    h, m = cfg.block_decoder.hidden_size, cfg.block_decoder.intermediate_size
    vh, L = vcfg.hidden_size, 12
    Mb = BATCH * PROMPT_TOKENS // cfg.block_length * cfg.n_embedding_tokens
    shapes = [("qkv", Mb, h, 3 * h, "generation"),
              ("attn_out", Mb, h, h, "generation"),
              ("mlp_up", Mb, h, m, "generation"),
              ("mlp_down", Mb, m, h, "generation"),
              ("baseline qkv", BATCH * PROMPT_TOKENS, vh, 3 * vh, "vanilla")]
    crossover = []
    for label, M, K, N, path in shapes:
        x, w_q, scale, nxt = w8a8_rows(rows, g, label, M, K, N, L, path)
        if path == "generation":
            for Mc in (256, 384, 512, 1024, 2048, 4096):
                xc = x[:Mc]
                crossover.append({
                    "shape": label, "M": Mc, "K": K, "N": N,
                    "k1_ms": time_ms(lambda: k1.int8_matmul_stacked(
                        xc, w_q, scale, nxt()), 10),
                    "w8a8_ms": time_ms(lambda: w8a8_pair(
                        xc, w_q, scale, nxt()), 10)})
        del w_q, scale, x
    log(json.dumps({"w8a8_crossover": crossover, "card": smi}))


def int8_layers(g, L, B, H, cap, D):
    """A random L-layer INT8 cache, quantized as the model writes it:
    (k int8, k_scale, v int8, v_scale)."""
    kv = torch.randn((2, L, B, H, cap, D), generator=g, device="cuda")
    kq, ks = quant.quantize_kv(kv[0].reshape(L * B, H, cap, D))
    vq, vs = quant.quantize_kv(kv[1].reshape(L * B, H, cap, D))
    return (kq.reshape(L, B, H, cap, D), ks.reshape(L, B, H, cap),
            vq.reshape(L, B, H, cap, D), vs.reshape(L, B, H, cap))


def k2_row(rows, label, cache, q, mask, iters, path=None):
    """K2 against its plain version and SDPA on the cache's bf16 layers
    (dequantized for the INT8 form), cycling through the layers so they
    come from device memory. ``cache``: (k_q, k_s, v_q, v_s) for the INT8
    form, (k, v) in bf16 for the bf16 form."""
    int8 = len(cache) == 4
    tag = "K2" if int8 else "K2 bf16"
    fn, plain = ((k2.decode_attention_int8_stacked,
                  k2.decode_attention_int8_stacked_plain) if int8 else
                 (k2.decode_attention_stacked,
                  k2.decode_attention_stacked_plain))
    L, B, H, cap, _ = cache[0].shape
    S, D = q.shape[2], q.shape[3]
    route = k2.route(cap, S, D, cache[0].dtype)
    before = dict(k2.decode_attention_stacked.route_launches)
    got = fn(q, *cache, L // 2, mask)
    if not int8 and (k2.decode_attention_stacked.route_launches[route]
                     != before[route] + 1):
        raise AssertionError(f"{tag} {label}: not the {route} route")
    err = compare(f"{tag} {label}", got, plain(q, *cache, L // 2, mask))
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % L                 # noqa: E731
    ms = time_ms(lambda: fn(q, *cache, nxt(), mask), iters)
    plain_ms = time_ms(lambda: plain(q, *cache, nxt(), mask), 10)
    if int8:
        kq, ks, vq, vs = cache
        layers = [(quant.dequantize_kv(kq[i], ks[i], q.dtype),
                   quant.dequantize_kv(vq[i], vs[i], q.dtype))
                  for i in range(L)]
    else:
        layers = list(zip(*cache))
    allowed = mask.allowed()[:, None]          # [B, 1, S, cap]

    def library():
        k, v = layers[nxt()]
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=allowed)

    lib_ms = time_ms(library, iters)
    k_rows, v_rows, ops = attention_need(mask, H, D, B)
    row_bytes = D + 4 if int8 else 2 * D       # values (+ scale) of a slot
    mask_ints = sum(t.numel() for t in mask if t is not None)
    nbytes = (2 * B * H * S * D * 2 + (k_rows + v_rows) * row_bytes
              + mask_ints * 4)
    if route == "warp":
        how = "one warp a (b, h), 4 a block"
    else:
        p = k2.plan(B, H, cap, build.sm_count(0))
        how = f"splits {p.splits} x {p.slots_per_split} slots"
    record(rows, tag, label, err, ms, plain_ms, lib_ms, nbytes, ops,
           path=path, extra={"decode_route": route, "decode_plan": how})
    del layers


def phase_k2(rows, cfg, vcfg):
    """K2 at the block decoder's decode step (B=8, H=16, S=1, D=128, a
    12-layer cache of capacity 640 filled to 530 slots, some rows finished,
    some left-padded) and at the baseline's (B=8, H=16, S=1, D=64, a
    24-layer cache of capacity 2176 filled to 2100); in each, one row has
    no allowed key."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, D = BATCH, cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    cap, filled = 640, 530
    cache = int8_layers(g, 12, B, H, cap, D)
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    valid = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, 16 * b:filled] = 1           # left pad of 16*b blocks
    valid[B - 2:, filled - 4:filled] = 0       # finished rows
    valid[0] = 0                               # a row with no allowed key
    mask = masks.block_decode_mask(filled - 1, cap, 1, valid)
    k2_row(rows, "B=8 H=16 S=1 D=128 cap=640", cache, q, mask, 100)
    del cache

    H, D = vcfg.num_heads, vcfg.head_dim
    cap, filled = PROMPT_TOKENS + NEW_TOKENS, 2100
    cache = int8_layers(g, vcfg.num_layers, B, H, cap, D)
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    valid = torch.ones((B, cap), dtype=torch.int32, device=dev)
    valid[1] = 0                               # a row with no allowed key
    mask = masks.decode_mask(filled - 1, cap, 1, valid, device=dev)
    k2_row(rows, f"baseline B=8 H={H} S=1 D={D} cap={cap}", cache, q, mask,
           100, path="vanilla")
    del cache


def phase_k2_bf16(rows, cfg):
    """K2's bf16 form at the block decoder's decode step over a bf16 global
    cache (B=8, H=16, S=1, D=128, 12 layers of capacity 640 filled to 530,
    as ``phase_k2``; one row with no allowed key: the split route) and at
    the token decoder's local cache (B=8, H=16, D=128, 12 layers of
    capacity n_exp + block_length = 6, the token decoder's own mask: the
    warp route), at its last token step (S=1 at position 4) and its prefix
    step (S=n_exp=2 at positions 0-1)."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(9)
    B, H, D = BATCH, cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    cap, filled = 640, 530
    k, v = (torch.randn((12, B, H, cap, D), generator=g, device=dev,
                        dtype=bf16) for _ in range(2))
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    valid = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, 16 * b:filled] = 1
    valid[B - 2:, filled - 4:filled] = 0
    valid[0] = 0
    mask = masks.block_decode_mask(filled - 1, cap, 1, valid)
    k2_row(rows, "B=8 H=16 S=1 D=128 cap=640", (k, v), q, mask, 100)
    del k, v

    tcfg = cfg.token_decoder.neox
    H, D, L = tcfg.num_heads, tcfg.head_dim, tcfg.num_layers
    cap = cfg.n_expanded_emb + cfg.block_length
    k, v = (torch.randn((L, B, H, cap, D), generator=g, device=dev,
                        dtype=bf16) for _ in range(2))
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    mask = masks.decode_mask(cap - 2, cap, 1, device=dev)
    k2_row(rows, f"token decoder's local cache B=8 H={H} S=1 D={D} "
           f"cap={cap}", (k, v), q, mask, 50, path="generation")
    S = cfg.n_expanded_emb
    q = torch.randn((B, H, S, D), generator=g, device=dev, dtype=bf16)
    mask = masks.decode_mask(0, cap, S, device=dev)
    k2_row(rows, f"token decoder's local cache, prefix step B=8 H={H} "
           f"S={S} D={D} cap={cap}", (k, v), q, mask, 50, path="generation")


def launch_floor_ms(iters: int = 200) -> float:
    """Device ms of one launch of an empty kernel (one warp), timed as the
    kernel rows are: the least a launch of any kernel costs on the card."""
    fn = build.load("decode_attention").bt_empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        build.check(fn(build.raw_stream(0)), "bt_empty_launch")

    return time_ms(launch, iters)


def k3_row(rows, label, qkv, mask, iters, plain_iters, path=None):
    """K3 against its plain version and SDPA, cycling through copies of
    (q, k, v); asserts the tensor-core route."""
    q0, k0, v0 = qkv[0]
    B, H, Q, D = q0.shape
    K = k0.shape[2]
    before = dict(k3.flash_attention.route_launches)
    got = k3.flash_attention(q0, k0, v0, mask)
    if k3.flash_attention.route_launches["tc"] != before["tc"] + 1:
        raise AssertionError(f"K3 {label}: not the tensor-core route")
    want = k3.flash_attention_plain(q0, k0, v0, mask)
    err = compare(f"K3 {label}", got, want)
    del got, want
    it = iter(range(10 ** 9))
    pick = lambda: qkv[next(it) % len(qkv)]   # noqa: E731
    ms = time_ms(lambda: k3.flash_attention(*pick(), mask), iters)
    plain_ms = time_ms(lambda: k3.flash_attention_plain(*pick(), mask),
                       plain_iters)
    allowed = mask.allowed()[:, None]          # [B, 1, Q, K]
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *pick(), attn_mask=allowed), iters)
    k_rows, v_rows, ops = attention_need(mask, H, D)
    nbytes = ((2 * B * H * Q + k_rows + v_rows) * D * 2
              + (B * Q + K + B * K) * 4)
    record(rows, "K3", label, err, ms, plain_ms, lib_ms, nbytes,
           ops, path=path, extra={"attention_route": k3.route(q0.dtype, D, K)})


def phase_k3(rows, cfg, vcfg):
    """K3 at the fresh prefill's first and last query tiles (B=8, H=16, 128
    queries against the 512 prompt blocks, D=128, block-causal, with
    left-padded rows whose first queries have no allowed key) and at the
    baseline's prompt (B=8, H=16, Q=2048 against the 2176-slot cache, D=64,
    causal: slots from 2048 on carry indices past every query, as
    ``vanilla_prefill`` builds it)."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    B, H, D = BATCH, cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    Q, K = 128, PROMPT_TOKENS // cfg.block_length
    qkv = [torch.randn((3, B, H, K, D), generator=g, device=dev, dtype=bf16)
           for _ in range(4)]
    valid = torch.ones((B, K), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, :13 * b] = 0                  # left pad of 13*b blocks
    full = masks.block_decode_mask(0, K, K, valid)
    for label, t0 in (("first", 0), ("last", K - Q)):
        mask = masks.AttnMask(full.q_idx[t0:t0 + Q], full.kv_idx,
                              full.kv_valid)
        tiles = [(t[0, :, :, t0:t0 + Q].contiguous(), t[1], t[2])
                 for t in qkv]
        k3_row(rows, f"{label} tile B=8 H=16 Q={Q} K={K} D={D}", tiles,
               mask, 50, 20)
    del qkv, tiles

    H, D = vcfg.num_heads, vcfg.head_dim
    Q, K = PROMPT_TOKENS, PROMPT_TOKENS + NEW_TOKENS
    qkv = [(torch.randn((B, H, Q, D), generator=g, device=dev, dtype=bf16),
            torch.randn((B, H, K, D), generator=g, device=dev, dtype=bf16),
            torch.randn((B, H, K, D), generator=g, device=dev, dtype=bf16))
           for _ in range(2)]
    mask = masks.decode_mask(0, K, Q, torch.ones((B, K), dtype=torch.int32,
                                                 device=dev), device=dev)
    k3_row(rows, f"baseline B=8 H={H} Q={Q} K={K} D={D} causal", qkv, mask,
           20, 2, path="vanilla")
    del qkv


ENGINE_L, ENGINE_B = 12, pg.ENGINE_SLOTS   # block decoder layers, slots


def random_pools(g, L, P, H, ps, D, packed=False):
    """int8 [L, P, H, ps, D] values (``packed``: INT4, uint8 [..., D/2], each
    byte two nibbles) and f32 [L, P, H, ps] scales, as (k, k_scale, v,
    v_scale)."""
    def values():
        if packed:
            return torch.randint(0, 256, (L, P, H, ps, D // 2), generator=g,
                                 device="cuda", dtype=torch.uint8)
        return torch.randint(-127, 128, (L, P, H, ps, D), generator=g,
                             device="cuda", dtype=torch.int8)

    def f32():
        return 0.01 + 0.02 * torch.rand((L, P, H, ps), generator=g,
                                        device="cuda")

    return [values(), f32(), values(), f32()]


def random_step(g, lead, H, D):
    """One decode step's quantized K/V: (kq, ks, vq, vs)."""
    return (torch.randint(-127, 128, (*lead, H, D), generator=g,
                          device="cuda", dtype=torch.int8),
            torch.rand((*lead, H), generator=g, device="cuda"),
            torch.randint(-127, 128, (*lead, H, D), generator=g,
                          device="cuda", dtype=torch.int8),
            torch.rand((*lead, H), generator=g, device="cuda"))


def exact(name: str, got, want, skip_page0: bool) -> float:
    """Pools must be equal bit for bit (outside page 0 if asked)."""
    for a, b in zip(got, want):
        if skip_page0:
            a, b = a[:, 1:], b[:, 1:]
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: kernel and plain pools differ")
    return 0.0


def clones(ts):
    return [t.clone() for t in ts]


def phase_k5(rows, cfg):
    """K5 at the contiguous INT8 engine cache's decode write: the cache
    [12, 16, 16, 640, 128] as a pool with one page per slot, 16 rows at
    their frontiers, one finished row at off == cap (dropped)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    L, B = ENGINE_L, ENGINE_B
    H, D, cap = cfg.block_decoder.num_heads, cfg.block_decoder.head_dim, 640
    pools = random_pools(g, L, B, H, cap, D)
    page = torch.arange(B, dtype=torch.int32, device="cuda")
    off = torch.randint(0, cap, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    off[3] = cap
    step = random_step(g, (B,), H, D)
    want = kp.paged_write_int8_plain(*clones(pools), L // 2, page, off, *step)
    got = kp.paged_write_int8(*clones(pools), L // 2, page, off, *step)
    err = exact("K5", got, want, skip_page0=False)
    for a, b in zip(got, pools):
        if not torch.equal(a[:, 3], b[:, 3]):
            raise AssertionError("K5: the row at off == cap was written")
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % L                 # noqa: E731
    ms = time_ms(lambda: kp.paged_write_int8(*pools, nxt(), page, off, *step),
                 200)
    plain_ms = time_ms(lambda: kp.paged_write_int8_plain(
        *pools, nxt(), page, off, *step), 50)
    ok = off < cap
    pg_, of_ = page[ok].long(), off[ok].long()
    new = [t[ok] for t in step]

    def library():
        layer = nxt()
        for pool, val in zip(pools, new):      # [P, ps, H(, D)] views
            pool[layer].transpose(1, 2).index_put_((pg_, of_), val)

    lib_ms = time_ms(library, 200)
    n = int(ok.sum())
    nbytes = 2 * 2 * n * H * (D + 4) + 2 * B * 4     # read + write, page/off
    record(rows, "K5", "B=16 H=16 D=128 pool [12,16,16,640]",
           err, ms, plain_ms, lib_ms, nbytes, 0)


def engine_pool_case(g, cfg, packed=False):
    """The paged engine's pool [12, 49, 16, 256, 128] (``packed``: the
    paged-int4 engine's, [..., 64] bytes), 16 rows of 3 virtual pages on
    distinct pages; row 0 holds one page, its tail on page 0."""
    L, B = ENGINE_L, ENGINE_B
    H, D = cfg.block_decoder.num_heads, cfg.block_decoder.head_dim
    ps, n_virt = 256, 3
    P = B * n_virt + 1
    pools = random_pools(g, L, P, H, ps, D, packed)
    pt = (1 + torch.randperm(B * n_virt, generator=g, device="cuda")).reshape(
        B, n_virt).to(torch.int32)
    pt[0, 1:] = 0
    return pools, pt, (L, B, H, D, ps, n_virt, P)


def phase_k6(rows, cfg, int4=False):
    """K6 at a paged engine's decode step: 16 rows, ragged lengths (row 0
    within its one page), S=1. INT8 pool: the deferred write, the fresh
    pair on and mask q_idx - 1. Packed INT4 pool (``int4``): no fresh term,
    the step's K/V already written at the frontier, which the mask
    allows."""
    tag = "K6 int4" if int4 else "K6"
    g = torch.Generator(device="cuda").manual_seed(10 if int4 else 6)
    bf16 = torch.bfloat16
    pools, pt, (L, B, H, D, ps, n_virt, P) = engine_pool_case(g, cfg, int4)
    K = ps * n_virt
    frontier = torch.randint(130, K, (B,), generator=g, device="cuda")
    frontier[0] = 200
    valid = (torch.arange(K, device="cuda")[None]
             <= frontier[:, None]).to(torch.int32)
    for b in range(B):
        valid[b, :8 * b] = 0                   # left pad
    q_idx = frontier if int4 else frontier - 1
    mask = masks.AttnMask(q_idx[:, None].to(torch.int32),
                          torch.arange(K, dtype=torch.int32, device="cuda"),
                          valid)
    q = torch.randn((B, H, 1, D), generator=g, device="cuda", dtype=bf16)
    fresh = None if int4 else tuple(
        0.3 * torch.randn((B, H, D), generator=g, device="cuda")
        for _ in range(2))
    got = kp.paged_decode_attention_int8(q, *pools, L // 2, pt, mask,
                                         fresh=fresh)
    want = kp.paged_decode_attention_int8_plain(q, *pools, L // 2, pt, mask,
                                                fresh=fresh)
    err = compare(tag, got, want)
    it = iter(range(10 ** 9))
    nxt = lambda: next(it) % L                 # noqa: E731
    ms = time_ms(lambda: kp.paged_decode_attention_int8(
        q, *pools, nxt(), pt, mask, fresh=fresh), 100)
    plain_ms = time_ms(lambda: kp.paged_decode_attention_int8_plain(
        q, *pools, nxt(), pt, mask, fresh=fresh), 20)
    ptl = pt.long()
    allowed = mask.allowed()

    def deq(vals, scale, extra):               # pages (+ fresh column), bf16
        x = quant.dequantize_kv(vals[ptl], scale[ptl], bf16).permute(
            0, 2, 1, 3, 4).reshape(B, H, K, D)
        return x if int4 else torch.cat([x, extra[:, :, None].to(bf16)], 2)

    k_deq = [deq(pools[0][i], pools[1][i], fresh and fresh[0])
             for i in range(L)]
    v_deq = [deq(pools[2][i], pools[3][i], fresh and fresh[1])
             for i in range(L)]
    if fresh is not None:
        allowed = torch.cat([allowed, torch.ones(
            (B, 1, 1), dtype=torch.bool, device="cuda")], dim=2)
    allowed = allowed[:, None]

    def library():
        i = nxt()
        return torch.nn.functional.scaled_dot_product_attention(
            q, k_deq[i], v_deq[i], attn_mask=allowed)

    lib_ms = time_ms(library, 100)
    k_rows, v_rows, ops = attention_need(mask, H, D)
    if bool((~mask.allowed().any(-1)).any()):
        raise AssertionError(f"{tag} case: every row should see a pool key")
    row_bytes = (D // 2 if int4 else D) + 4
    nbytes = ((k_rows + v_rows) * row_bytes + 2 * B * H * D * 2
              + (B + K + B * K + B * n_virt) * 4)
    if fresh is not None:                      # kf, vf and their products
        nbytes += 2 * B * H * D * 4
        ops += 4 * B * H * D
    label = ("B=16 H=16 S=1 D=128 packed pool [12,49,16,256] n_virt=3"
             if int4 else
             "B=16 H=16 S=1 D=128 pool [12,49,16,256] n_virt=3 fresh")
    p = k2.plan(B, H, K, build.sm_count(0))
    record(rows, tag, label, err, ms, plain_ms, lib_ms, nbytes, ops,
           extra={"decode_plan": f"splits {p.splits} x {p.slots_per_split} "
                                 "slots"})
    del k_deq, v_deq


def phase_k7(rows, cfg):
    """K7 after the paged engine's layer loop: kq [12, 16, 16, 128] into the
    pool [12, 49, 16, 256, 128]; row 0 is finished (page 0)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    pools, pt, (L, B, H, D, ps, n_virt, P) = engine_pool_case(g, cfg)
    vp = torch.randint(0, n_virt, (B,), generator=g, device="cuda")
    vp[0] = 0
    page = pt.gather(1, vp[:, None])[:, 0].contiguous()
    page[0] = 0
    off = torch.randint(0, ps, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    step = random_step(g, (L, B), H, D)
    want = kp.paged_write_layers_int8_plain(*clones(pools), page, off, *step)
    got = kp.paged_write_layers_int8(*clones(pools), page, off, *step)
    err = exact("K7", got, want, skip_page0=True)
    ms = time_ms(lambda: kp.paged_write_layers_int8(*pools, page, off, *step),
                 200)
    plain_ms = time_ms(lambda: kp.paged_write_layers_int8_plain(
        *pools, page, off, *step), 50)
    lidx = torch.arange(L, device="cuda")[:, None]
    pg_, of_ = page.long()[None], off.long()[None]

    def library():
        for pool, val in zip(pools, step):     # [L, P, ps, H(, D)] views
            pool.transpose(2, 3).index_put_((lidx, pg_, of_), val)

    lib_ms = time_ms(library, 200)
    nbytes = 2 * 2 * L * B * H * (D + 4) + 2 * B * 4
    record(rows, "K7",
           "L=12 B=16 H=16 D=128 pool [12,49,16,256]", err, ms, plain_ms,
           lib_ms, nbytes, 0)


def phase_k8(rows, cfg, int4=False):
    """K8 at a paged engine's admission of 16 rows: rows
    [12, 16, 16, 768, 128] into the pool [12, 49, 16, 256, 128], 3 pages a
    row (row 0's tail on page 0); ``int4``: packed rows and pool, [..., 64]
    bytes."""
    tag = "K8 int4" if int4 else "K8"
    g = torch.Generator(device="cuda").manual_seed(11 if int4 else 8)
    pools, pt, (L, B, H, D, ps, n_virt, P) = engine_pool_case(g, cfg, int4)
    src = random_pools(g, L, B, H, n_virt * ps, D, int4)
    want = kp.paged_page_copy_int8_plain(*clones(pools), pt, *src)
    got = kp.paged_page_copy_int8(*clones(pools), pt, *src)
    err = exact(tag, got, want, skip_page0=True)
    ms = time_ms(lambda: kp.paged_page_copy_int8(*pools, pt, *src), 20)
    plain_ms = time_ms(lambda: kp.paged_page_copy_int8_plain(
        *pools, pt, *src), 5)
    ptl = pt.long()
    pages = [kp._pages(t, n_virt) for t in src]   # strided views

    def library():
        for pool, val in zip(pools, pages):
            pool[:, ptl] = val

    lib_ms = time_ms(library, 5)
    row_bytes = (D // 2 if int4 else D) + 4
    nbytes = 2 * 2 * L * B * n_virt * H * ps * row_bytes + B * n_virt * 4
    record(rows, tag, "L=12 G=16 nv=3 ps=256 H=16 D=128"
           + (" packed" if int4 else ""), err, ms, plain_ms, lib_ms, nbytes, 0)
    del src, pages


def phase_family_kernels(rows):
    """The kernels at the ablation families' new shapes (hidden 768, heads
    of 64): W8A8-q and W8A8-mm (``w8a8_rows``) at block_uniform_b4_85's
    prefill qkv over its 6 layers (M = 8 x 293 blocks = 2344, a partial
    last tile of tokens; K = 768, N = 2304; bit for bit), K3 at its last
    query tile (Q = 37 of 293 blocks, K = 293, B=8, H=12, D=64,
    block-causal, rows left-padded by 4*b blocks as the prompts are), K2
    bf16 (warp route) at its token decoder's local cache at the last token
    step (capacity n_exp + 7 = 9), K2 INT8 at block_megabyte_b4_85's
    decode step (B=8, H=12, S=1, D=64, its
    11 layers of capacity 640 filled to 530, some rows finished, one with
    no allowed key) and K1 at that model's token decoder qkv (M = B x 4 =
    32, K = 512, N = 1536, over its 4 layers)."""
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(14)
    name = "block_uniform_b4_85"
    cfg = family_config(name)
    bcfg = cfg.block_decoder
    h, H, D = bcfg.hidden_size, bcfg.num_heads, bcfg.head_dim
    K = -(-PROMPT_TOKENS // cfg.block_length)           # 293 prompt blocks
    w8a8_rows(rows, g, "uniform qkv", BATCH * K, h, 3 * h, bcfg.num_layers,
              family_path(name))
    B, Q = BATCH, K % 128
    qkv = [torch.randn((3, B, H, K, D), generator=g, device=dev, dtype=bf16)
           for _ in range(4)]
    valid = torch.ones((B, K), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, :4 * b] = 0
    full = masks.block_decode_mask(0, K, K, valid)
    mask = masks.AttnMask(full.q_idx[K - Q:], full.kv_idx, full.kv_valid)
    tiles = [(t[0, :, :, K - Q:].contiguous(), t[1], t[2]) for t in qkv]
    k3_row(rows, f"uniform last tile B=8 H={H} Q={Q} K={K} D={D}", tiles,
           mask, 50, 20, path=family_path(name))
    del qkv, tiles
    tcfg = cfg.token_decoder.neox
    cap = cfg.n_expanded_emb + cfg.block_length
    k, v = (torch.randn((tcfg.num_layers, B, H, cap, D), generator=g,
                        device=dev, dtype=bf16) for _ in range(2))
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    k2_row(rows, f"uniform local cache B=8 H={H} S=1 D={D} cap={cap}",
           (k, v), q, masks.decode_mask(cap - 2, cap, 1, device=dev), 50,
           path=family_path(name))

    name = "block_megabyte_b4_85"
    cfg = family_config(name)
    cap, filled = 640, 530
    cache = int8_layers(g, cfg.block_decoder.num_layers, B, H, cap, D)
    q = torch.randn((B, H, 1, D), generator=g, device=dev, dtype=bf16)
    valid = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, 16 * b:filled] = 1
    valid[B - 2:, filled - 4:filled] = 0
    valid[0] = 0
    mask = masks.block_decode_mask(filled - 1, cap, 1, valid)
    k2_row(rows, f"megabyte B=8 H={H} S=1 D={D} cap={cap}", cache, q, mask,
           100, path=family_path(name))
    del cache
    t = cfg.token_decoder.neox
    k1_row(rows, g, f"megabyte token decoder qkv M={B * cfg.block_length}",
           B * cfg.block_length, t.hidden_size, 3 * t.hidden_size,
           t.num_layers, path=family_path(name))


# small versions of the families for the card-against-CPU check: (block
# length, embedder fields, token decoder fields, block decoder class); all
# at hidden 128, 2 layers, vocab 512
SMALL_FAMILIES = {
    "megabyte": (4, dict(hidden_size=32),
                 dict(decoding_strategy="summation", expansion_ratio=None),
                 "gpt-neo-x"),
    "cls_cross_attn": (4, dict(cls="roberta_cls", hidden_size=64,
                               n_cls_tokens=2),
                       dict(decoding_strategy="cross_attention",
                            expansion_ratio=None, cls="t5"), "gpt-neo-x"),
    "uniform": (7, dict(hidden_size=32, projection_method="projection_layer"),
                dict(expansion_ratio=2), "gpt-neo-x"),
    "roberta_prefix": (4, dict(cls="roberta", hidden_size=32),
                       dict(expansion_ratio=2), "gpt-neo-x"),
    "t5_embedder": (4, dict(cls="t5", hidden_size=32),
                    dict(expansion_ratio=2), "gpt-neo-x"),
    "gpt_neo": (4, dict(hidden_size=32),
                dict(expansion_ratio=2, cls="gpt-neo"), "gpt-neo"),
}


def small_family_config(name: str) -> config.BlockTransformerConfig:
    block_length, emb_fields, td_fields, bd_cls = SMALL_FAMILIES[name]
    neox_cfg = NeoXConfig.from_hidden_layers(128, 2, vocab_size=512,
                                             max_position_embeddings=64)
    return config.BlockTransformerConfig(
        block_length=block_length,
        embedder=config.EmbedderConfig(vocab_size=512,
                                       projection_hidden_size=128,
                                       encoder_layers=2, **emb_fields),
        block_decoder=neox_cfg,
        token_decoder=config.TokenDecoderConfig(neox=neox_cfg, **td_fields),
        block_decoder_cls=bd_cls, block_decoder_window=4,
        name=f"small {name}")


def quiet_eos(params, cfg):
    """Random weights for generation: a T5 token decoder's tied embedding
    row of token 0, which is its BOS, pad and EOS at once, scaled by 0.02.
    At random init (rows N(0, 1)) the decoder fed [BOS, pad, ...] predicts
    its own input, so every row would end at EOS in the first block (in the
    JAX package as well); the other families are left as they are."""
    if cfg.token_decoder.cls == "t5":
        params["token_decoder"]["t5"]["embed"]["weight"][
            cfg.eos_token_id] *= 0.02
    return params


def phase_small_families():
    """Every ablation family on the card (kernels) against the same port on
    the CPU (plain versions), small configurations, float32, INT8 weights
    (``quiet_eos``):
    forward logits within TOL of their largest magnitude, and greedy tokens
    of ``generate_blocks`` equal with the INT8 global cache (GPT-Neo: the
    unquantized cache, float32 here, through the streaming prefill, the
    only cache and prefill it takes)."""
    rng = np.random.default_rng(8)
    for name in SMALL_FAMILIES:
        cfg = small_family_config(name)
        params = quant.quantize_block_transformer(quiet_eos(
            bt.init_block_transformer_params(8, cfg, device="cpu"), cfg),
            bits=8)
        card = to_card(params)
        B, N, L = 2, 12, cfg.block_length
        ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
        att = np.ones_like(ids)
        ids[1, :2], att[1, :2] = 0, 0
        ids[0, 3, 2:], att[0, 3, 2:] = 0, 0       # padded tokens in a block
        bam = att.any(-1).astype(np.int32)
        args = [torch.from_numpy(a) for a in (ids, att, bam)]
        want = bt.block_transformer_forward(params, cfg, *args).logits
        got = bt.block_transformer_forward(
            card, cfg, *[a.to(CARD) for a in args]).logits
        err = (got.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        if not bool(torch.isfinite(got).all()) or err > TOL * scale:
            raise AssertionError(f"small family {name}: card vs CPU logits "
                                 f"differ by {err} (max |logit| {scale})")
        kv = "bf16" if cfg.block_decoder_cls == "gpt-neo" else "int8"
        res = [gen.generate_blocks(p, cfg, ids, att, bam, max_blocks=N + 4,
                                   kv_cache=kv, device=d)
               for p, d in ((params, "cpu"), (card, CARD))]
        if res[0].n_blocks != res[1].n_blocks or not torch.equal(
                res[0].tokens, res[1].tokens.cpu()):
            raise AssertionError(f"small family {name} kv {kv}: card and "
                                 "CPU tokens differ")
        log(f"small family {name}: logits max err {err:.3e} (max |logit| "
            f"{scale:.3e}); greedy tokens equal on the card and the CPU, "
            f"int8 weights + {kv} KV ({res[1].n_blocks} blocks)")


def family_prompts(cfg):
    """The families' prompts: PROMPT_TOKENS tokens rounded up to whole
    blocks (293 blocks of 7 tokens at block length 7), random, row b
    left-padded by 4*b blocks."""
    L = cfg.block_length
    return pg.ragged_prompts(cfg, BATCH, -(-PROMPT_TOKENS // L) * L, seed=0)


def inner_loop_seconds(run):
    """(run s, inner-loop s) of one more ``run``, the device synchronized
    around each ``decode_block_tokens`` call to time the token decoder's
    share (the synchronizations slow the run a little)."""
    inner = 0.0
    decode = gen.decode_block_tokens

    def timed(*args, **kw):
        nonlocal inner
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(*args, **kw)
        torch.cuda.synchronize()
        inner += time.perf_counter() - t0
        return out

    gen.decode_block_tokens = timed
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        gen.decode_block_tokens = decode
    return total, inner


def phase_families(smi: str) -> dict:
    """The four shipped ablation configs at full width (FAMILY_NAMES),
    random bf16 weights from a seed (``quiet_eos``) quantized to INT8, the
    INT8 global cache, greedy ``generate_blocks``, B=8, PROMPT_TOKENS prompt
    tokens (rounded up to whole blocks) and NEW_TOKENS new ones: one
    warm-up run, then a timed run between launch-count resets, asserting
    that it reached its last block and that every kernel of the path ran
    on its main route (K2's bf16 form by the warp route on the prefix
    decoders' local cache, and not on the re-run decoders), W8A8 on the
    block decoder's prefill linears alone; then the prefill alone, and one
    more run with the inner loop timed. Returns {path: launches}."""
    out = {}
    for name in FAMILY_NAMES:
        cfg = family_config(name)
        prefix = cfg.token_decoder.decoding_strategy == "prefix"
        path = add_family_path(name, prefix)
        t0 = time.perf_counter()
        params = quant.quantize_block_transformer(quiet_eos(
            bt.init_block_transformer_params(0, cfg, dtype=torch.bfloat16,
                                             device=CARD), cfg), bits=8)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ids, att, bam = family_prompts(cfg)
        L, N, n = cfg.block_length, ids.shape[1], cfg.n_embedding_tokens
        max_blocks = N + -(-NEW_TOKENS // L)

        def run():
            return gen.generate_blocks(params, cfg, ids, att, bam,
                                       max_blocks=max_blocks, kv_cache="int8",
                                       device=CARD)

        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        reset_launches()
        with W8A8Decisions() as decisions:
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        out[path] = read_launches(path)
        decisions.check(path, out[path],
                        (4 * cfg.block_decoder.num_layers, BATCH * N * n))
        toks = res.tokens
        if tuple(toks.shape) != (BATCH, max_blocks, L):
            raise AssertionError(f"{name}: tokens shape {tuple(toks.shape)}")
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"{name}: tokens out of [0, vocab)")
        if not torch.equal(toks[:, :N].cpu(), torch.from_numpy(ids)):
            raise AssertionError(f"{name}: prompt blocks were not kept")
        generated = BATCH * (res.n_blocks - N) * L
        if res.n_blocks != max_blocks:
            raise AssertionError(f"{name}: {res.n_blocks - N} blocks "
                                 f"generated, not {max_blocks - N}")

        capacity = -(-max_blocks * n // 128) * 128
        dev_args = [torch.as_tensor(a, device=CARD) for a in (ids, att, bam)]
        with linear_ops.kv_mode("int8"):
            t0 = time.perf_counter()
            gen.prefill_blocks(params, cfg, *dev_args, capacity=capacity,
                               kv_cache="int8")
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        total_s, inner_s = inner_loop_seconds(run)
        strategy = cfg.token_decoder.decoding_strategy
        loop = "cached" if prefix else "re-run"
        log(f"{name} ({cfg.embedder.cls} embedder, {strategy} "
            f"{cfg.token_decoder.cls} token decoder, L={L}) generate_blocks "
            f"B={BATCH} p{N * L}/d{NEW_TOKENS} int8 weights + int8 KV: init "
            f"+ quantization {init_s:.2f} s; {res.n_blocks - N} blocks "
            f"generated; warm-up run {warm_s:.2f} s; timed run {secs:.3f} s "
            f"= {generated / secs:.1f} tok/s (prefill included); prefill "
            f"alone {prefill_s:.3f} s; a run with the {loop} inner loop "
            f"timed: {total_s:.3f} s, the inner loop {inner_s:.3f} s "
            f"({inner_s / total_s:.1%}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(json.dumps({"family": name, "inner_loop": loop, "run_s": secs,
                        "generated_tok_s": generated / secs,
                        "prefill_s": prefill_s, "timed_inner_run_s": total_s,
                        "inner_loop_s": inner_s, "card": smi}))
        del params, res
    return out


def small_config():
    cfg = config.make_block_config("smoke", 128, 2, vocab_size=512)
    params = bt.init_block_transformer_params(0, cfg, device="cpu")
    return cfg, quant.quantize_block_transformer(params, bits=8)


def to_card(tree):
    if isinstance(tree, dict):
        return {k: to_card(v) for k, v in tree.items()}
    return tree.cuda()


def phase_small_engine():
    """The serving engine on the card (kernels) against the same engine on
    the CPU (plain versions): small configuration, float32, INT8 weights,
    3 slots, 5 requests of uneven prompts and budgets; contiguous INT8 and
    INT4 caches and paged INT8 and INT4 pools (page size 4)."""
    cfg, qparams = small_config()
    traffic = ((1, 37, 9), (1, 12, 30), (1, 64, 5), (1, 5, 17), (1, 26, 12))
    requests = pg.engine_requests(cfg, traffic, seed=3)
    for kind in pg.ENGINE_KINDS:
        out = []
        for params, dev in ((qparams, "cpu"), (to_card(qparams), "cuda")):
            eng = pg.make_engine(params, cfg, kind, n_slots=3, max_blocks=40,
                                 bucket_blocks=4, page_size=4, device=dev)
            res = pg.serve(eng, requests)
            out.append([r.generated for r in res["requests"]])
        if out[0] != out[1] or not all(out[0]):
            raise AssertionError(f"small engine {kind}: card and CPU tokens "
                                 f"differ:\n{out[0]}\n{out[1]}")
        log(f"small engine {kind}: greedy tokens equal on the card and the "
            f"CPU ({sum(map(len, out[0]))} tokens, 5 requests, 3 slots)")


def phase_small_reference():
    """The port on the card (kernels) against the port on the CPU (plain
    versions), small configuration, float32."""
    cfg, qparams = small_config()
    to_dev = to_card
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
    log(f"small reference: logits max err {err:.3e}")
    for kv in ("int8", "int4", "bf16"):
        run = lambda p, d: gen.generate_blocks(  # noqa: E731
            p, cfg, ids, att, bam, max_blocks=N + 4, kv_cache=kv, device=d)
        t_cpu, t_gpu = run(qparams, "cpu"), run(to_dev(qparams), "cuda")
        if t_cpu.n_blocks != t_gpu.n_blocks or not torch.equal(
                t_cpu.tokens, t_gpu.tokens.cpu()):
            raise AssertionError(f"small generation kv {kv}: card and CPU "
                                 "tokens differ")
        log(f"small generation kv {kv}: greedy tokens equal on the card and "
            f"the CPU ({t_gpu.n_blocks} blocks)")


def phase_small_quantized():
    """INT4 and mixed48 weights (group size 32) and the vanilla baseline
    (INT8 and INT4 weights, INT8 KV) on the card against the CPU: small
    configurations, float32, greedy tokens equal."""
    cfg = config.make_block_config("smoke", 128, 2, vocab_size=512)
    params = bt.init_block_transformer_params(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    B, N, L = 2, 12, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, :2], att[1, :2] = 0, 0
    bam = att.any(-1).astype(np.int32)
    for kind in ("int4", "mixed48"):
        q = quant.quantize_block_transformer(
            params, **dict(pg.QUANTIZE[kind], group_size=32))
        res = [gen.generate_blocks(p, cfg, ids, att, bam, max_blocks=N + 4,
                                   kv_cache="int8", device=d)
               for p, d in ((q, "cpu"), (to_card(q), "cuda"))]
        if res[0].n_blocks != res[1].n_blocks or not torch.equal(
                res[0].tokens, res[1].tokens.cpu()):
            raise AssertionError(f"small generation {kind}: card and CPU "
                                 "tokens differ")
        log(f"small generation {kind}: greedy tokens equal on the card and "
            f"the CPU ({res[1].n_blocks} blocks)")
    vcfg = NeoXConfig.from_hidden_layers(128, 2, vocab_size=512, num_heads=4)
    vparams = vanilla.init_vanilla_params(0, vcfg, device="cpu")
    vids = torch.from_numpy(rng.integers(1, 512, (2, 12)).astype(np.int32))
    for bits in (8, 4):
        q = quant.quantize_model_params(vparams, bits, group_size=32)
        toks = [pg.vanilla_generate(p, vcfg, i, 6)
                for p, i in ((q, vids), (to_card(q), vids.cuda()))]
        if not torch.equal(toks[0], toks[1].cpu()):
            raise AssertionError(f"small vanilla int{bits}: card and CPU "
                                 f"tokens differ")
        log(f"small vanilla int{bits} weights + int8 KV: greedy tokens equal "
            f"on the card and the CPU ({toks[1].shape[1]} per row)")


class W8A8Decisions:
    """Records every W8A8 decision taken inside, as (M, taken): the card's
    INT8 linears each ask ``ops.linear._use_w8a8`` once."""

    def __enter__(self):
        self.seen, self._use = [], linear_ops._use_w8a8

        def use(m):
            taken = self._use(m)
            self.seen.append((m, taken))
            return taken

        linear_ops._use_w8a8 = use
        return self

    def __exit__(self, *exc):
        linear_ops._use_w8a8 = self._use

    def check(self, path: str, launches: dict, taken_at=None) -> None:
        """W8A8-q and W8A8-mm launched once for each decision taken and K1
        once for each one left to it; ``taken_at``: (count, M) the run must
        have taken (all at that M)."""
        taken = [m for m, t in self.seen if t]
        left = [m for m, t in self.seen if not t]
        log(f"W8A8 in the timed {path} run: {len(taken)} linears (M "
            f"{sorted(set(taken))}), {len(left)} to K1 (M "
            f"{sorted(set(left))})")
        if not launches["W8A8-q"] == launches["W8A8-mm"] == len(taken):
            raise AssertionError(f"{path}: W8A8 launches {launches['W8A8-q']}"
                                 f" / {launches['W8A8-mm']} for {len(taken)} "
                                 "linears that took it")
        if launches["K1"] != len(left):
            raise AssertionError(f"{path}: K1 launches {launches['K1']} for "
                                 f"{len(left)} linears left to it")
        if taken_at is not None and (len(taken), set(taken)) != (
                taken_at[0], {taken_at[1]} if taken_at[0] else set()):
            raise AssertionError(f"{path}: W8A8 took {len(taken)} linears at "
                                 f"M {sorted(set(taken))}, not {taken_at[0]}"
                                 f" at M {taken_at[1]}")


def phase_small_w8a8():
    """W8A8 and the streaming prefill on the card (kernels) against the CPU
    (plain versions), float32, greedy tokens equal: ``block_main_b4_5``
    (random weights, INT8, INT8 KV) with W8A8 forced at every M, the CPU
    run taking W8A8's plain versions through the port's card gate, opened
    for it; then ``generate_blocks(fresh_prefill=False)`` on the bf16, INT8
    and INT4 caches at the small configuration, 12 prompt blocks in chunks
    of 5 (padded to 15 of 16 slots)."""
    cfg = config.get_config("block_main_b4_5")
    params = quant.quantize_block_transformer(
        bt.init_block_transformer_params(5, cfg, device="cpu"), bits=8)
    rng = np.random.default_rng(5)
    B, N, L = 2, 12, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, :2], att[1, :2] = 0, 0
    bam = att.any(-1).astype(np.int32)
    run = lambda p, d: gen.generate_blocks(  # noqa: E731
        p, cfg, ids, att, bam, max_blocks=N + 4, kv_cache="int8", device=d)
    with linear_ops.w8a8_min_m(1):
        before = w8a8.w8a8_matmul_stacked.launches
        card = run(to_card(params), "cuda")
        launched = w8a8.w8a8_matmul_stacked.launches - before
        gate = linear_ops._on_card
        linear_ops._on_card = lambda x: True
        try:
            cpu = run(params, "cpu")
        finally:
            linear_ops._on_card = gate
    if launched <= 0 or card.n_blocks != cpu.n_blocks or not torch.equal(
            card.tokens.cpu(), cpu.tokens):
        raise AssertionError(f"small block_main_b4_5 W8A8: card and CPU "
                             f"tokens differ ({launched} W8A8-mm launches)")
    log(f"small block_main_b4_5 INT8 with W8A8 at every M: greedy tokens "
        f"equal on the card and the CPU ({card.n_blocks} blocks, "
        f"{launched} W8A8-mm launches)")

    cfg, qparams = small_config()
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    for kv in ("bf16", "int8", "int4"):
        run = lambda p, d: gen.generate_blocks(  # noqa: E731
            p, cfg, ids, att, bam, max_blocks=N + 4, kv_cache=kv,
            prefill_chunk_blocks=5, fresh_prefill=False, device=d)
        t_cpu, t_gpu = run(qparams, "cpu"), run(to_card(qparams), "cuda")
        if t_cpu.n_blocks != t_gpu.n_blocks or not torch.equal(
                t_cpu.tokens, t_gpu.tokens.cpu()):
            raise AssertionError(f"small streaming prefill kv {kv}: card "
                                 "and CPU tokens differ")
        log(f"small generation kv {kv}, streaming prefill (chunks of 5 "
            f"blocks): greedy tokens equal on the card and the CPU "
            f"({t_gpu.n_blocks} blocks)")


def reset_launches():
    for fn, *_ in KERNELS:
        fn.launches = 0
        if hasattr(fn, "form_launches"):
            fn.form_launches = dict.fromkeys(fn.form_launches, 0)
    for fn, _ in ROUTED.values():
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
    k2.decode_attention_stacked.route_launches = dict.fromkeys(
        k2.decode_attention_stacked.route_launches, 0)


def read_launches(path: str) -> dict:
    """{tag: launches} since the last reset (a K6/K8 tag: its pool width's
    launches; "K2 bf16 warp" and "K2 bf16 split": K2 bf16's by route);
    fails if a kernel of ``path`` did not run, or one it must not run
    did."""
    launches = {tag: fn.launches if form is None else fn.form_launches[form]
                for fn, tag, *_, form in KERNELS}
    routes = {tag: dict(fn.route_launches)
              for tag, (fn, _) in ROUTED.items()}
    log(f"launches in the timed {path} run: {json.dumps(launches)}; K1/K3/"
        f"K4/W8A8-mm by route: {json.dumps(routes)}")
    for tag in PATH_KERNELS[path]:
        if launches[tag] <= 0:
            raise AssertionError(f"{tag} was not launched on the {path} path")
    for tag in PATH_ABSENT.get(path, ()):
        if launches[tag]:
            raise AssertionError(f"{tag} was launched on the {path} path")
    for tag, by_route in routes.items():     # full width: one route only
        want = ROUTED[tag][1]
        if by_route[want] != launches[tag] or sum(by_route.values()) != \
                launches[tag]:
            raise AssertionError(f"{tag} took another route than {want} on "
                                 f"the {path} path: {by_route}")
    # K2 bf16 serves the token decoder's local cache by the warp route, and
    # only the bf16 global cache by the split route
    k2_routes = dict(k2.decode_attention_stacked.route_launches)
    log(f"K2 bf16 by route in the timed {path} run: {json.dumps(k2_routes)}")
    if "K2 bf16" in PATH_KERNELS[path] and k2_routes["warp"] <= 0:
        raise AssertionError(f"K2 bf16 did not take the warp route on the "
                             f"local cache of the {path} path: {k2_routes}")
    if (k2_routes["split"] > 0) != (path == "generation kv bf16"):
        raise AssertionError(f"K2 bf16's split route on the {path} path: "
                             f"{k2_routes}")
    launches.update({f"K2 bf16 {r}": n for r, n in k2_routes.items()})
    return launches


def generation_path(quantize: str, kv: str, fresh: bool = True) -> str:
    if not fresh:
        return "generation streaming"
    if kv != "int8":
        return f"generation kv {kv}"
    return "generation" if quantize == "int8" else f"generation {quantize}"


def phase_generation(cfg, params, quantize: str, kv: str = "int8",
                     fresh: bool = True, weights: str = None):
    """Full-width generation with ``quantize`` weights and the ``kv`` global
    cache, the fresh prefill or (``fresh=False``) the streaming one in 4
    chunks of 128 blocks; returns the launches of the timed run and its
    tokens per second. Asserts the W8A8 decisions: an INT8 block decoder's
    fresh prefill takes W8A8 for its 48 linears (12 layers x 4) at M =
    4096, the streaming chunks (M = 1024 under the INT8 cache) take none,
    and every other INT8 linear takes K1. ``weights`` names where the
    weights came from in the log (default: random, ``quantize`` RTN)."""
    path = generation_path(quantize, kv, fresh)
    torch.cuda.reset_peak_memory_stats()
    ids, att, bam = pg.ragged_prompts(cfg, BATCH, PROMPT_TOKENS, seed=0)
    L, N = cfg.block_length, ids.shape[1]
    max_blocks = N + NEW_TOKENS // L

    def run():
        return gen.generate_blocks(params, cfg, ids, att, bam,
                                   max_blocks=max_blocks, kv_cache=kv,
                                   fresh_prefill=fresh, device="cuda")

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launches()
    with W8A8Decisions() as decisions:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = read_launches(path)
    layers = cfg.block_decoder.num_layers
    decisions.check(path, launches, None if quantize == "int4" else (
        4 * layers, BATCH * N * cfg.n_embedding_tokens) if fresh else (0, 0))

    toks = res.tokens
    if tuple(toks.shape) != (BATCH, max_blocks, L):
        raise AssertionError(f"tokens shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("tokens out of [0, vocab)")
    if not torch.equal(toks[:, :N].cpu(), torch.from_numpy(ids)):
        raise AssertionError("prompt blocks were not kept")
    generated = BATCH * (res.n_blocks - N) * L
    log(f"{MODEL} generate_blocks B={BATCH} p{PROMPT_TOKENS}/d{NEW_TOKENS} "
        f"{weights or quantize} weights + {kv} KV, "
        f"{'fresh' if fresh else 'streaming'} "
        f"prefill: {res.n_blocks - N} blocks generated; "
        f"warm-up run {warm_s:.2f} s; timed run {secs:.3f} s = "
        f"{generated / secs:.1f} tok/s (prefill included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, generated / secs


def phase_vanilla(cfg, params):
    """The baseline at the block model's B, prompt and new tokens (unpadded
    random prompts, as ``bench.py``): one warm-up run, then a timed run
    between launch-count resets. Returns (launches, tokens per second),
    counting B x 128 decode-step tokens as ``bench.py`` does."""
    torch.cuda.reset_peak_memory_stats()
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (BATCH, PROMPT_TOKENS)), dtype=torch.int32,
        device="cuda")

    def run():
        return pg.vanilla_generate(params, cfg, ids, NEW_TOKENS)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launches()
    with W8A8Decisions() as decisions:
        t0 = time.perf_counter()
        toks = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = read_launches("vanilla")
    decisions.check("vanilla", launches,
                    (4 * cfg.num_layers, BATCH * PROMPT_TOKENS))
    if tuple(toks.shape) != (BATCH, NEW_TOKENS + 1):
        raise AssertionError(f"vanilla tokens shape {tuple(toks.shape)}")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("vanilla tokens out of [0, vocab)")
    generated = BATCH * NEW_TOKENS
    log(f"{VANILLA_MODEL} greedy B={BATCH} p{PROMPT_TOKENS}/d{NEW_TOKENS} "
        f"int8 weights + int8 KV: warm-up run {warm_s:.2f} s; timed run "
        f"{secs:.3f} s = {generated / secs:.1f} tok/s (prefill included); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, generated / secs


def phase_engine(kind: str, cfg, params):
    """Serve the engine traffic at full width with the ``kind`` cache: a
    short warm-up, then one timed run between launch-count resets."""
    eng = pg.make_engine(params, cfg, kind)
    t0 = time.perf_counter()
    warm = pg.serve(eng, pg.engine_requests(cfg, ((2, 512, 8),), seed=1))
    log(f"engine {kind}: warm-up ({len(warm['requests'])} short requests) "
        f"{time.perf_counter() - t0:.2f} s")
    requests = pg.engine_requests(cfg, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with W8A8Decisions() as decisions:
        res = pg.serve(eng, requests)
    launches = read_launches(f"engine {kind}")
    decisions.check(f"engine {kind}", launches)
    reqs = res["requests"]
    early = 0
    for r, (_, budget) in zip(reqs, requests):
        if r.error or not r.done or not 1 <= len(r.generated) <= budget:
            raise AssertionError(f"engine {kind}: request {r.uid} served "
                                 f"{len(r.generated)} of {budget} tokens "
                                 f"(error {r.error!r})")
        if min(r.generated) < 0 or max(r.generated) >= cfg.vocab_size:
            raise AssertionError(f"engine {kind}: tokens out of [0, vocab)")
        early += len(r.generated) < budget      # ended at an EOS
    if kind.startswith("paged") and (
            sorted(eng._free_pages) != list(range(1, eng.pool_pages))
            or bool(eng.cache.page_table.any())):
        raise AssertionError(f"engine {kind}: pages were not all freed")
    lat = res["latency"]
    log(f"{MODEL} engine kv_cache={kind}: {len(reqs)} requests, 16 slots, "
        f"{res['tokens']} tokens in {res['seconds']:.3f} s = "
        f"{res['tokens'] / res['seconds']:.1f} tok/s (admission included); "
        f"engine_admit_s {res['admit_s']:.4f}; dispatches "
        f"{res['dispatches']}; {early} requests ended at an EOS; TTFT mean "
        f"{lat['ttft_s_mean']:.3f} s p50 {lat['ttft_s_p50']:.3f} s p95 "
        f"{lat['ttft_s_p95']:.3f} s; TPOT mean {lat['tpot_s_mean'] * 1e3:.2f} "
        f"ms p95 {lat['tpot_s_p95'] * 1e3:.2f} ms; queue wait mean "
        f"{lat['queue_wait_s_mean']:.3f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, [r.generated for r in reqs]


def phase_cache_agreement(cfg, params):
    """One full-width decode step of the block decoder (INT8 weights, the
    engine's 16 slots, 3 pages of 256 slots a row) from identical prefilled
    K/V, through the contiguous stack and the paged one: INT8 (K5 writes,
    K2 attends) against the paged INT8 pool (K6 with the fresh term, then
    K7), and the contiguous INT4 cache against the paged INT4 pool (K6 INT4).
    A random 512-position prefill fills the contiguous cache, K8 copies its
    pages into the pool; the step runs at ragged frontiers. Asserts that
    the outputs agree within TOL * max|out|."""
    dev, bf16 = "cuda", torch.bfloat16
    bcfg, bd = cfg.block_decoder, params["block_decoder"]
    B, ps, n_virt, S0 = ENGINE_B, pg.ENGINE_PAGE_SIZE, 3, 512
    cap, n = ps * n_virt, cfg.n_embedding_tokens
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((B, S0, bcfg.hidden_size), generator=g, device=dev,
                    dtype=bf16)
    x_step = torch.randn((B, n, bcfg.hidden_size), generator=g, device=dev,
                         dtype=bf16)
    valid = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, 8 * b:S0] = 1                 # left pad of 8*b positions
    prefill = masks.block_decode_mask(0, cap, S0, valid, n)
    wp = (S0 - 200 + 13 * torch.arange(B, device=dev)).to(torch.int32)
    step_valid = valid.clone()
    cols = torch.arange(cap, device=dev)[None]
    step_valid[cols >= wp[:, None]] = 0        # the rows' frontiers
    step_valid[cols == wp[:, None]] = 1        # the step's own slot
    step = masks.AttnMask((wp // n)[:, None].to(torch.int32),
                          (torch.arange(cap, device=dev) // n).to(torch.int32),
                          step_valid)
    positions = wp[:, None] + torch.arange(n, dtype=torch.int32, device=dev)
    pt = (1 + torch.randperm(B * n_virt, generator=g, device=dev)).reshape(
        B, n_virt).to(torch.int32)
    for bits in (8, 4):
        contig = neox.QuantKVCache.create(bcfg, B, cap, bits=bits, device=dev)
        _, contig = neox.neox_stack(bd, x, cfg=bcfg, mask=prefill,
                                    positions=torch.arange(
                                        S0, dtype=torch.int32, device=dev),
                                    cache=contig)
        paged = neox.PagedKVCache.create(bcfg, B, cap, n_pages=B * n_virt + 1,
                                         page_size=ps, bits=bits, device=dev)
        paged.page_table.copy_(pt)
        kp.paged_page_copy_int8(paged.k, paged.k_scale, paged.v,
                                paged.v_scale, pt, contig.k, contig.k_scale,
                                contig.v, contig.v_scale)
        outs = [neox.neox_stack(bd, x_step, cfg=bcfg, mask=step,
                                positions=positions, cache=c, write_pos=wp)[0]
                for c in (contig, paged)]
        for o in outs:
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"cache agreement int{bits}: not finite")
        delta = (outs[0].float() - outs[1].float()).abs()
        diff, scale = delta.max().item(), outs[0].float().abs().max().item()
        name = "int8 vs paged" if bits == 8 else "int4 vs paged-int4"
        log(f"one block-decoder step from identical K/V, {name}: max |diff| "
            f"{diff:.4e}, max |out| {scale:.4e}, ratio {diff / scale:.3e} "
            f"(limit TOL {TOL}); mean |diff| {delta.mean().item():.4e}, mean "
            f"|out| {outs[0].float().abs().mean().item():.4e}, "
            f"{(delta > 0).float().mean().item():.3f} of outputs differ")
        if diff > TOL * scale:
            raise AssertionError(f"cache agreement {name}: {diff:.4e} > "
                                 f"{TOL} * {scale:.4e}")
        del contig, paged, outs


def log_agreement(a: str, b: str, x_tokens, y_tokens) -> None:
    """How far the greedy tokens of engine caches ``a`` and ``b`` agree."""
    pairs = [(p, q) for x, y in zip(x_tokens, y_tokens)
             for p, q in zip(x, y)]
    prefix = [next((i for i, (p, q) in enumerate(zip(x, y)) if p != q),
                   min(len(x), len(y)))
              for x, y in zip(x_tokens, y_tokens)]
    log(f"engine {a} vs {b}: the two caches agree on "
        f"{sum(p == q for p, q in pairs)} of {len(pairs)} tokens (bf16 "
        f"near-ties may differ); common prefix per request: min "
        f"{min(prefix)}, mean {np.mean(prefix):.1f} tokens, "
        f"{sum(p == len(x) for p, x in zip(prefix, x_tokens))} of "
        f"{len(prefix)} requests equal")


# the train phase: two sequences of 2048 tokens, float32 master weights, TF32
# off; 3 plain steps, then a QAT fine-tune of 3 steps with a fresh optimizer
TRAIN_SEQS, TRAIN_TOKENS, TRAIN_STEPS = 2, 2048, 3
TRAIN_LR = dict(peak_lr=1e-4, warmup_steps=1, total_steps=10)
QAT_RECIPE = "mixed48"
CARD_CPU_RTOL = 1e-5    # train steps, card against CPU, float32: loss,
                        # grad_norm, Adam's moments (each leaf, Frobenius)
UPDATE_RTOL = 1e-4      # each parameter leaf: |card - CPU| within
                        # CARD_CPU_RTOL |p0| + UPDATE_RTOL |update|, over the
                        # coordinates whose gradient is zero or above float32
NOISE_FLOOR = 1e-6      # noise, sqrt(nu) > NOISE_FLOOR * max sqrt(nu) (the
                        # CPU's nu): Adam turns a gradient that is zero in
                        # exact arithmetic (the key bias off RoPE's dims)
                        # into the sign of its rounding noise
GPTQ_EQUAL = 0.999      # gptq_round on one (W, H), card against CPU: share
                        # of Q equal, the rest one step apart
GPTQ_TREE_RTOL = 0.02   # whole GPTQ trees, card against CPU: mean layer-
                        # output error within 2% relative


def train_batch(cfg, seed: int, tokens: int = TRAIN_TOKENS,
                rows: int = TRAIN_SEQS):
    """The train step's batch (numpy): ``rows`` rows of random tokens, row 1
    left-padded by 96 tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (rows, tokens))
    att = np.ones_like(ids)
    ids[1, :96], att[1, :96] = 0, 0
    return packing.make_train_batch(ids, att, cfg.block_length)


def calibration(batch):
    """A train batch as GPTQ's calibration batches (block format)."""
    return [(batch["input_ids"], batch["attention_mask"],
             batch["block_attention_mask"])]


def train_steps(cfg, state, tx, batch, n: int, transform, what: str):
    """``n`` train steps on the card, each timed (host clock, the device
    synchronized) with its peak memory and loss; asserts finite losses and
    that no kernel launched (K3 included: attention under autograd takes
    the plain path)."""
    step = ts.make_train_step(cfg, tx, param_transform=transform)
    dev_batch = packing.to_device(batch, CARD)
    tokens = dev_batch["input_ids"].numel()
    before = {tag: fn.launches for fn, tag, *_ in KERNELS}
    for _ in range(n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, dev_batch)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"{MODEL} train step {state.step} ({what}, B={TRAIN_SEQS} x "
            f"{TRAIN_TOKENS} tokens, remat, float32, TF32 off): "
            f"{secs * 1e3:.1f} ms = {tokens / secs:.1f} tokens/s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss "
            f"{loss:.6f}, grad_norm {norm:.6f}, lr "
            f"{tx.schedule(state.step - 1):.3e}")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"train step {state.step} ({what}): loss "
                                 f"{loss}, grad_norm {norm}")
    after = {tag: fn.launches for fn, tag, *_ in KERNELS}
    moved = {t: after[t] - before[t] for t in after if after[t] != before[t]}
    log(f"kernel launches during the {what} train steps: {moved or 'none'} "
        f"(K3: {after['K3'] - before['K3']})")
    if moved:
        raise AssertionError(f"kernels launched under autograd: {moved}")
    return state


def phase_train_quantize(cfg):
    """The quantization workflow at full width: random float32
    ``block_main_b4_1.2b``, TRAIN_STEPS plain train steps, then TRAIN_STEPS
    QAT steps (``mixed48``) from a fresh optimizer; the QAT weights
    quantized with the recipe (RTN) and served; GPTQ INT4 g128 of the same
    weights, calibrated on the train batch, and served. Returns the
    launches of both generation runs."""
    tx, _ = opt.make_optimizer(**TRAIN_LR)
    t0 = time.perf_counter()
    state = ts.create_train_state(0, cfg, tx, device=CARD)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in opt.tree_leaves(state.params))
    log(f"{MODEL}: {n_params} float32 parameters and AdamW moments on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    batch = train_batch(cfg, seed=0)
    state = train_steps(cfg, state, tx, batch, TRAIN_STEPS, None, "plain")
    state = ts.TrainState(state.params, None, 0)       # free the moments
    state = ts.TrainState(state.params, tx.init(state.params), 0)
    transform = functools.partial(quant.fake_quant_block_transformer,
                                  **quant.RECIPES[QAT_RECIPE])
    state = train_steps(cfg, state, tx, batch, TRAIN_STEPS, transform,
                        f"QAT {QAT_RECIPE}")
    params = state.params
    del state
    launches = {}
    qat = quant.cast_floats(quant.quantize_block_transformer(
        params, **quant.RECIPES[QAT_RECIPE]), torch.bfloat16)
    launches["QAT mixed48"], _ = phase_generation(
        cfg, qat, QAT_RECIPE, weights=f"QAT {QAT_RECIPE} (RTN of the "
        "fine-tuned weights)")
    del qat

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = gptq.gptq_quantize_block_transformer(
        params, cfg, calibration(batch), bits=4, group_size=GROUP_SIZE,
        device=CARD, stats=stats)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"GPTQ INT4 g{GROUP_SIZE} of {MODEL} on the card, calibrated on "
        f"{TRAIN_SEQS} x {TRAIN_TOKENS} tokens: {secs:.2f} s; " + ", ".join(
            f"{k} {v:.3f}" for k, v in stats.items() if k.endswith("_s")))
    L = cfg.block_decoder.num_layers
    ratios = []
    for e in stats["layer_errors"]:
        ratios.append(e["gptq"] / e["rtn"])
        if e["layer"] in (0, L - 1):
            log(f"  {e['trunk']} layer {e['layer']} {e['linear']} (K "
                f"{e['K']}, N {e['N']}): ||X(W - W_hat)|| / ||XW|| GPTQ "
                f"{e['gptq']:.5f}, RTN {e['rtn']:.5f}")
    log(f"GPTQ / RTN layer-output error over all {len(ratios)} linears of "
        f"both stacks: mean {np.mean(ratios):.4f}, max {max(ratios):.4f}")
    if not np.mean(ratios) < 1.0:
        raise AssertionError("GPTQ's layer-output error is not below RTN's")
    del params
    tree = quant.cast_floats(tree, torch.bfloat16)
    launches["GPTQ int4"], _ = phase_generation(
        cfg, tree, "int4", weights=f"GPTQ int4 g{GROUP_SIZE}")
    for what, n in launches.items():
        log(f"launches generating from the {what} tree: {json.dumps(n)}")
    return launches


def q_values(tree):
    """{path: int32 Q} of every quantized kernel (INT4 unpacked)."""
    out = {}
    for path, leaf in opt.tree_items(tree):
        if path[-1] == "kernel_q4":
            out[path] = quant.unpack_int4(leaf.cpu()).to(torch.int32)
        elif path[-1] == "kernel_q8":
            out[path] = leaf.cpu().to(torch.int32)
    return out


def train_state_error(p0, cpu, card) -> dict:
    """Card state against CPU state after the same steps from parameters
    ``p0`` ({path: tensor}): the largest over leaves of the relative
    Frobenius difference of Adam's moments ``mu`` and ``nu``, and of
    ``|p_card - p_cpu| / (CARD_CPU_RTOL |p0| + UPDATE_RTOL |p_cpu - p0|)``
    over the coordinates whose ``sqrt(nu)`` is zero or above NOISE_FLOOR
    of the leaf's largest (at most 1 passes)."""
    out = {"mu": 0.0, "nu": 0.0, "params": 0.0}
    for name in ("mu", "nu"):
        a = dict(opt.tree_items(getattr(cpu.opt_state, name)))
        b = dict(opt.tree_items(getattr(card.opt_state, name)))
        out[name] = max(float((b[k].cpu() - v).norm() / v.norm())
                        for k, v in a.items() if v.norm() > 0)
    nu = dict(opt.tree_items(cpu.opt_state.nu))
    p_cpu = dict(opt.tree_items(cpu.params))
    p_card = dict(opt.tree_items(card.params))
    for path, w0 in p0.items():
        rms = nu[path].sqrt()
        live = (rms == 0) | (rms > NOISE_FLOOR * rms.max())
        w, diff = p_cpu[path][live], (p_card[path].cpu() - p_cpu[path])[live]
        limit = (CARD_CPU_RTOL * w0[live].norm()
                 + UPDATE_RTOL * (w - w0[live]).norm())
        if diff.norm() > 0:
            out["params"] = max(out["params"], float(diff.norm() / limit))
    return out


def phase_small_train_gptq():
    """The train step and GPTQ on the card against the CPU (both the port,
    float32, TF32 off) at ``block_main_b4_5``: 2 steps (the first at lr 0),
    plain and QAT ``mixed48``: loss, grad_norm and Adam's moments within
    CARD_CPU_RTOL, the parameters as ``train_state_error`` states; GPTQ
    INT4 g128, calibrated on 8 sequences of 2048 tokens: ``gptq_round`` on
    one (W, H) on both devices, at least GPTQ_EQUAL of Q equal and the rest
    one step apart (cuSOLVER's inverse and Cholesky against LAPACK's), the
    differences counted; whole trees by their quality, the mean layer-
    output error within GPTQ_TREE_RTOL, their Q agreement logged. A row
    sweep carries each rounding that flips down its column, so a last-bit
    difference of the float32 calibration forward moves many entries, the
    more so where the calibration holds fewer positions than a linear has
    inputs (H singular but for the damping)."""
    cfg = config.get_config("block_main_b4_5")
    tx, _ = opt.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    batch = train_batch(cfg, seed=6, tokens=256)
    params0 = ts.create_train_state(0, cfg, tx, device="cpu").params
    p0 = dict(opt.tree_items(params0))
    for recipe in (None, QAT_RECIPE):
        transform = None if recipe is None else functools.partial(
            quant.fake_quant_block_transformer, **quant.RECIPES[recipe])
        runs = []
        for dev in ("cpu", CARD):
            params = opt.tree_map(lambda t: t.to(dev, copy=True), params0)
            state = ts.TrainState(params, tx.init(params), 0)
            step = ts.make_train_step(cfg, tx, param_transform=transform)
            metrics = []
            for _ in range(2):
                state, m = step(state, packing.to_device(batch, dev))
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
            runs.append((np.array(metrics), state))
        (m_cpu, s_cpu), (m_gpu, s_gpu) = runs
        m_err = float(np.max(np.abs(m_gpu - m_cpu) / np.abs(m_cpu)))
        err = train_state_error(p0, s_cpu, s_gpu)
        what = "plain" if recipe is None else f"QAT {recipe}"
        log(f"small train steps block_main_b4_5 ({what}), card vs CPU: "
            f"losses {m_gpu[:, 0].tolist()} / {m_cpu[:, 0].tolist()}, "
            f"grad_norms {m_gpu[:, 1].tolist()} / {m_cpu[:, 1].tolist()}; "
            f"max relative diff: loss/grad_norm {m_err:.3e}, mu "
            f"{err['mu']:.3e}, nu {err['nu']:.3e} (limit {CARD_CPU_RTOL}); "
            f"parameters {err['params']:.3f} of their limit")
        if max(m_err, err["mu"], err["nu"]) > CARD_CPU_RTOL or (
                err["params"] > 1.0):
            raise AssertionError(f"small train steps ({what}): card and CPU "
                                 "differ")
    calib = calibration(train_batch(cfg, seed=7, rows=8))
    # the rounding alone: gptq_round on one (W, H) on both devices, H from
    # the calibration's inputs to the block decoder's first qkv and MLP up
    ids, att, bam = (torch.from_numpy(a) for a in calib[0])
    n_emb, layers = cfg.n_embedding_tokens, params0["block_decoder"]["layers"]
    x = emb.embed_blocks(params0["embedder"], cfg.embedder, cfg.block_length,
                         ids, attention_mask=att).reshape(
        ids.shape[0], -1, cfg.embedder.projection_hidden_size)
    valid = torch.repeat_interleave(bam, n_emb, dim=1)
    for name, ln, w in (("qkv", "ln1", layers["attn"]["qkv"]["kernel"][0]),
                        ("up", "ln2", layers["mlp"]["up"]["kernel"][0])):
        H = gptq._gram(neox.layer_norm(x, {k: v[0] for k, v in
                                           layers[ln].items()},
                                       cfg.block_decoder.layer_norm_eps),
                       valid)
        q_cpu, s_cpu = gptq.gptq_round(w, H, bits=4, group_size=GROUP_SIZE)
        q_card, s_card = gptq.gptq_round(w.to(CARD), H.to(CARD), bits=4,
                                         group_size=GROUP_SIZE)
        diff = (q_card.cpu() - q_cpu).abs()
        s_err = float(((s_card.cpu() - s_cpu).abs() / s_cpu).max())
        log(f"small gptq_round block_main_b4_5 layer 0 {name} (K "
            f"{w.shape[0]}, N {w.shape[1]}), one H on both, card vs CPU: "
            f"{int((diff == 0).sum())} of {diff.numel()} Q equal, "
            f"{int((diff > 0).sum())} ties broken apart by cuSOLVER against "
            f"LAPACK, max |diff| {int(diff.max())}; scales max rel diff "
            f"{s_err:.3e}")
        if (diff == 0).float().mean() < GPTQ_EQUAL or diff.max() > 1:
            raise AssertionError(f"small gptq_round {name}: card and CPU "
                                 "differ")
    # whole trees: the calibration forward in float32 differs in its last
    # bits between the devices, and the row sweep carries each rounding
    # that flips down its column, so trees are compared by their quality
    stats = [{}, {}]
    trees = [q_values(gptq.gptq_quantize_block_transformer(
        params0, cfg, calib, bits=4, group_size=GROUP_SIZE, device=dev,
        stats=st)) for dev, st in zip(("cpu", CARD), stats)]
    n = equal = worst = 0
    for path, q_cpu in trees[0].items():
        diff = (trees[1][path] - q_cpu).abs()
        n, equal = n + diff.numel(), equal + int((diff == 0).sum())
        worst = max(worst, int(diff.max()))
    err = [{k: np.mean([e[k] for e in st["layer_errors"]])
            for k in ("gptq", "rtn")} for st in stats]
    log(f"small GPTQ int4 g{GROUP_SIZE} block_main_b4_5 (8 x 2048 "
        f"calibration tokens), card vs CPU trees: {equal} of {n} Q entries "
        f"equal ({equal / n:.6f}), max |diff| {worst}; mean layer-output "
        f"error GPTQ {err[1]['gptq']:.5f} / {err[0]['gptq']:.5f}, RTN "
        f"{err[1]['rtn']:.5f} / {err[0]['rtn']:.5f} (limit: GPTQ within "
        f"{GPTQ_TREE_RTOL} relative, below RTN)")
    if (abs(err[1]["gptq"] - err[0]["gptq"]) > GPTQ_TREE_RTOL * err[0]["gptq"]
            or not err[1]["gptq"] < err[1]["rtn"]):
        raise AssertionError("small GPTQ: the card's tree is not the CPU's "
                             "in quality")

# the trainer phase: the training loop through its entry points at full
# width (bf16 as the YAMLs say), then the tiny trainer card against CPU
BLOCK_YAML = "block_main_b4_1.2b"
VANILLA_YAML, UPTRAIN_YAML = "vanilla_160", "block_uptrain_b4_85_10"
SYNTHETIC_TOKENS = 200000   # the synthetic corpus: ~1000 random documents
RESUME_RTOL = 1e-3      # the resumed run's step-3 loss against the
                        # uninterrupted run's (bf16, the same parameters)
TRAINER_CPU_RTOL = 1e-4  # tiny trainer records, card against CPU, float32
TRAINER_DISK_BYTES = 30e9  # (b)'s checkpoints 2 and 3 of block_main_b4_1.2b


def launch_counts() -> dict:
    return {tag: fn.launches for fn, tag, *_ in KERNELS}


def assert_no_launch(before: dict, what: str) -> None:
    """No hand kernel launched since ``before``: training runs the plain
    paths under autograd, as JAX's trainer does under its mesh (Pallas off
    there)."""
    moved = {t: n - before[t] for t, n in launch_counts().items()
             if n != before[t]}
    log(f"kernel launches during {what}: {moved or 'none'}")
    if moved:
        raise AssertionError(f"kernels launched during {what}: {moved}")


def metrics_records(out_dir: str) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def finite_records(recs: list, what: str) -> None:
    for r in recs:
        if not (math.isfinite(r["loss"])
                and math.isfinite(r.get("grad_norm", 0.0))):
            raise AssertionError(f"{what}: step {r['step']} record {r}")


def checkpoint_bytes(out_dir: str, step: int) -> int:
    path = os.path.join(out_dir, f"checkpoint-{step}")
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def phase_packer(smi: str) -> None:
    """The native packer (``csrc/packer.cpp`` built with g++) against the
    numpy mapping on the synthetic corpus at 2048-token samples."""
    from block_transformer_tpu_torch.pretrain_block_transformer import (
        synthetic_corpus)
    ds = packing.PackedDataset(
        synthetic_corpus(SYNTHETIC_TOKENS, 50304, 512), 2048, eos_token=0,
        pad_token=0, block_length=4)
    # the trainer's indices (mod len): the native packer wraps a window
    # that crosses the corpus end, the numpy mapping pads it
    idxs = np.arange(64) % len(ds)
    t0 = time.perf_counter()
    built = native_packer.get_packer() is not None
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = ds.get_batch(idxs)
    native_s = time.perf_counter() - t0
    route = ds.last_route
    t0 = time.perf_counter()
    plain = ds.get_batch(idxs, use_native=False)
    numpy_s = time.perf_counter() - t0
    same = all(np.array_equal(native[k], plain[k]) for k in plain)
    log(f"packer: native library {'built' if built else 'not built'} in "
        f"{build_s:.2f} s; 64 samples of 2048 tokens by the {route} route "
        f"{native_s * 1e3:.2f} ms, numpy {numpy_s * 1e3:.2f} ms (host); "
        f"equal: {same} [{smi}]")
    if not same:
        raise AssertionError("the native packer differs from numpy")


def phase_trainer_entry(work: str, smi: str) -> None:
    """(a) ``block_main_b4_1.2b`` through ``pretrain_block_transformer.main``
    with its YAML (bf16), a synthetic corpus, 2048-token samples, batch 2,
    2 steps; the step's wall time from ``metrics.jsonl``."""
    from block_transformer_tpu_torch import pretrain_block_transformer
    out = os.path.join(work, "entry")
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t = pretrain_block_transformer.main([
        "--config", config_path(BLOCK_YAML), "--synthetic",
        str(SYNTHETIC_TOKENS), "--steps", "2", "--batch_size", "2",
        "--output_dir", out])
    secs = time.perf_counter() - t0
    assert_no_launch(before, "the entry point's train steps")
    recs = metrics_records(out)
    finite_records(recs, "entry point")
    last = recs[-1]
    tokens = t.micro_batch * t.tcfg.max_length
    dtypes = sorted({str(p.dtype) for p in opt.tree_leaves(t.state.params)})
    log(f"(a) {BLOCK_YAML} pretrain_block_transformer.main (YAML, "
        f"{dtypes}, B=2 x {t.tcfg.max_length}, remat): step {last['step']} "
        f"{last['wall_time_s']:.3f} s = {tokens / last['wall_time_s']:.1f} "
        f"tokens/s, loss {last['loss']:.5f}; main() {secs:.2f} s with init "
        f"and the step-2 checkpoint ({checkpoint_bytes(out, 2)} bytes); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{smi}]")
    if t.state.step != 2 or dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"entry point: step {t.state.step}, {dtypes}")
    del t
    shutil.rmtree(out)


def resumed_state_differences(got, want) -> list:
    """The leaves (and counters) of two ``TrainState``s that are not equal
    bit for bit, dtype included."""
    bad = [name for name, a, b in (
        ("step", got.step, want.step),
        ("count", got.opt_state.count, want.opt_state.count)) if a != b]
    for name, ta, tb in (("params", got.params, want.params),
                         ("mu", got.opt_state.mu, want.opt_state.mu),
                         ("nu", got.opt_state.nu, want.opt_state.nu)):
        b = dict(opt.tree_items(tb))
        for path, a in opt.tree_items(ta):
            if a.dtype != b[path].dtype:
                bad.append(f"{name}/{'/'.join(map(str, path))} "
                           f"{a.dtype} != {b[path].dtype}")
            elif not torch.equal(a, b[path]):
                d = (a.float() - b[path].float()).abs().max()
                bad.append(f"{name}/{'/'.join(map(str, path))} max abs "
                           f"difference {float(d):.3e}")
    return bad


def phase_trainer_resume(work: str, smi: str) -> None:
    """(b) The same model through ``Trainer``: total batch 4 of micro 2
    (accumulation 2), ramp-up 1, 3 steps, saving at step 2; a second
    ``Trainer`` resumes from it to step 3, and its state equals the
    uninterrupted run's bit for bit (the moments too: the step-3 loss
    alone is computed before step 3's update)."""
    cfg = config_yaml.load_block_config_yaml(config_path(BLOCK_YAML))
    tkw = config_yaml.load_trainer_kwargs_yaml(config_path(BLOCK_YAML))
    out = os.path.join(work, "resume")
    tkw.update(output_dir=out, total_batch_size=4, micro_batch_size=2,
               batch_size_rampup_steps=1, stop_steps=3, save_steps=2,
               logging_steps=1)
    from block_transformer_tpu_torch.pretrain_block_transformer import (
        synthetic_corpus)
    T = tkw["max_length"]
    ds = packing.PackedDataset(
        synthetic_corpus(SYNTHETIC_TOKENS, cfg.vocab_size, 512), T,
        eos_token=0, pad_token=0, block_length=cfg.block_length)
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    first = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(**tkw), ds,
                                device=CARD)
    first.train()
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = metrics_records(out)
    finite_records(recs, "uninterrupted run")
    for r in recs:
        tokens = first._effective_accum(r["step"] - 1) * 2 * T
        log(f"(b) {BLOCK_YAML} Trainer step {r['step']} (bf16, "
            f"{tokens // T} x {T} tokens, accumulation "
            f"{first._effective_accum(r['step'] - 1)}): {r['wall_time_s']:.3f}"
            f" s = {tokens / r['wall_time_s']:.1f} tokens/s; loss "
            f"{r['loss']:.6f}, grad_norm {r['grad_norm']:.5f} [{smi}]")
    saves = [e for e in first.checkpoint_log if e["op"] == "save"]
    nbytes = checkpoint_bytes(out, 2)
    moments = sorted({str(t.dtype) for t in opt.tree_leaves(
        first.state.opt_state.mu)})
    log(f"(b) peak memory {peak:.2f} GiB; checkpoint {nbytes} bytes "
        f"(bf16 params, {moments} moments): save "
        + ", ".join(f"step {e['step']} {e['s']:.2f} s "
                    f"({nbytes / e['s'] / 1e9:.2f} GB/s)" for e in saves)
        + f" [{smi}]")
    # the uninterrupted step-3 state stays on the card (~14.5 GB) for the
    # exact comparison below
    want_state = first.state
    del first
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(out, "checkpoint-3"))
    os.rename(os.path.join(out, "metrics.jsonl"),
              os.path.join(work, "uninterrupted.jsonl"))
    second = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(**tkw), ds,
                                 device=CARD)
    second.train(resume=True)
    assert_no_launch(before, "the Trainer's steps and resume")
    restore = second.checkpoint_log[0]
    got = metrics_records(out)[-1]
    want = recs[-1]
    err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    log(f"(b) resumed from step {restore['step']} (restore "
        f"{restore['s']:.2f} s = {nbytes / restore['s'] / 1e9:.2f} GB/s): "
        f"step {got['step']} {got['wall_time_s']:.3f} s, loss "
        f"{got['loss']:.6f} against the uninterrupted {want['loss']:.6f} "
        f"(relative {err:.2e}, limit {RESUME_RTOL}) [{smi}]")
    differ = resumed_state_differences(second.state, want_state)
    log(f"(b) resumed step-3 state against the uninterrupted one, bit for "
        f"bit (params, mu, nu, count, step): "
        f"{differ or 'equal'} [{smi}]")
    if restore["op"] != "restore" or got["step"] != 3 or err > RESUME_RTOL \
            or differ:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    del second, want_state
    torch.cuda.empty_cache()
    shutil.rmtree(out)


def phase_trainer_uptrain(work: str, smi: str) -> None:
    """(c) ``vanilla_160`` through ``pretrain_vanilla_transformer.main``
    (2 steps, batch 2 x 2048, float32 as the JAX script trains it), its
    checkpoint's parameters partitioned into ``block_uptrain_b4_85_10``
    (6 + 6 x 768) with the YAML's ``load_from_vanilla`` options and the
    computed token-decoder embeddings, cast to the YAML's bf16, and 2 block
    train steps from there."""
    from block_transformer_tpu_torch import pretrain_vanilla_transformer
    from block_transformer_tpu_torch.pretrain_block_transformer import (
        synthetic_corpus)
    from block_transformer_tpu_torch.train import uptrain
    from block_transformer_tpu_torch.utils import checkpoint as ckpt
    vout = os.path.join(work, "vanilla")
    before = launch_counts()
    t0 = time.perf_counter()
    vt = pretrain_vanilla_transformer.main([
        "--config", config_path(VANILLA_YAML), "--synthetic", str(SYNTHETIC_TOKENS), "--steps", "2",
        "--max_length", "2048", "--batch_size", "2", "--output_dir", vout])
    secs = time.perf_counter() - t0
    recs = metrics_records(vout)
    finite_records(recs, "vanilla")
    log(f"(c) {VANILLA_YAML} pretrain_vanilla_transformer.main (float32, "
        f"B=2 x 2048): step {recs[-1]['step']} {recs[-1]['wall_time_s']:.3f}"
        f" s, loss {recs[-1]['loss']:.5f}; main() {secs:.2f} s [{smi}]")
    vcfg = vt.model_cfg
    del vt
    vp = opt.tree_map(lambda t: t.to(torch.bfloat16),
                      ckpt.restore_params(vout, 2, device=CARD))
    cfg = config_yaml.load_block_config_yaml(config_path(UPTRAIN_YAML))
    # the YAML's concat embedder (hidden 192) cannot take vanilla_160's
    # [V, 768] table, in JAX as here; its load_from_vanilla options ask for
    # the mean projection, which is a projection layer over tokens of the
    # vanilla width
    cfg = dataclasses.replace(cfg, embedder=dataclasses.replace(
        cfg.embedder, hidden_size=vcfg.hidden_size,
        projection_method="projection_layer"))
    stanza = config_yaml.read_yaml(config_path(UPTRAIN_YAML))[
        "load_from_vanilla"]
    tkw = config_yaml.load_trainer_kwargs_yaml(config_path(UPTRAIN_YAML))
    bout = os.path.join(work, "uptrain")
    tkw.update(output_dir=bout, total_batch_size=2, micro_batch_size=None,
               stop_steps=2, logging_steps=1)
    ds = packing.PackedDataset(
        synthetic_corpus(SYNTHETIC_TOKENS, cfg.vocab_size, 512),
        tkw["max_length"], eos_token=0, pad_token=0,
        block_length=cfg.block_length)
    bt_trainer = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(**tkw),
                                     ds, device=CARD)
    t0 = time.perf_counter()
    params = uptrain.load_block_from_vanilla(
        bt_trainer.state.params, cfg, vp, vcfg, method=stanza["method"],
        initialize_mean_embedder_projection=stanza[
            "initialize_mean_embedder_projection"],
        initialize_identity_expansion_layer=stanza[
            "initialize_identity_expansion_layer"],
        compute_token_decoder_embeddings=True)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    del vp
    bt_trainer.state = ts.TrainState(
        params, bt_trainer.tx.init(params), 0)
    bt_trainer.train()
    assert_no_launch(before, "the vanilla run, the uptraining init (the "
                     "block decoder over [V, 1, h]: Q = 1 takes the plain "
                     "attention) and the uptrained steps")
    recs = metrics_records(bout)
    finite_records(recs, "uptrained")
    bd, td = cfg.block_decoder, cfg.token_decoder.neox
    log(f"(c) uptrained ({stanza['method']}, mean projection, identity "
        f"expansion, computed embeddings: {up_s:.2f} s) into {UPTRAIN_YAML} "
        f"({bd.num_layers} + {td.num_layers} x {bd.hidden_size}, "
        f"projection-layer embedder of {cfg.embedder.hidden_size}, bf16): "
        f"losses "
        + ", ".join(f"step {r['step']} {r['loss']:.5f} "
                    f"({r['wall_time_s']:.3f} s)" for r in recs)
        + f" [{smi}]")
    del bt_trainer, params
    torch.cuda.empty_cache()
    shutil.rmtree(vout)
    shutil.rmtree(bout)


def phase_trainer_small(work: str) -> None:
    """(d) The tiny trainer (hidden 64, one layer, vocab 96, 32-token
    samples; accumulation 2, ramp-up 2) for 3 steps on the card and on the
    CPU from the same initial state, float32: every record within
    TRAINER_CPU_RTOL."""
    cfg = config.make_block_config("tiny", block_decoder_hidden=64,
                                   block_decoder_layers=1, vocab_size=96,
                                   max_length=32)
    from block_transformer_tpu_torch.pretrain_block_transformer import (
        synthetic_corpus)
    ds = packing.PackedDataset(
        synthetic_corpus(8000, 96, 64), 32, eos_token=0, pad_token=0,
        block_length=4)
    runs = []
    state0 = None
    for i, dev in enumerate(("cpu", CARD)):
        tcfg = trainer_lib.TrainerConfig(
            output_dir=os.path.join(work, f"small_{i}"), learning_rate=3e-3,
            num_train_steps=12, stop_steps=3, num_warmup_steps=1,
            total_batch_size=8, micro_batch_size=4, batch_size_rampup_steps=2,
            max_length=32, logging_steps=1, remat=False)
        t = trainer_lib.Trainer(cfg, tcfg, ds, device=dev)
        if state0 is None:
            state0 = t.state
        params = opt.tree_map(lambda p: p.to(dev, copy=True), state0.params)
        t.state = ts.TrainState(params, t.tx.init(params), 0)
        t.train()
        runs.append(metrics_records(tcfg.output_dir))
    cpu, card = runs
    worst = 0.0
    for a, b in zip(cpu, card):
        if (a["step"], a["tokens_seen"], a["lr"]) != (
                b["step"], b["tokens_seen"], b["lr"]):
            raise AssertionError(f"small trainer records: {a} / {b}")
        for k in ("loss", "token_decoding_loss", "grad_norm",
                  "loss_by_position"):
            x, y = np.asarray(a[k]), np.asarray(b[k])
            worst = max(worst, float(np.max(np.abs(y - x) / np.abs(x))))
    log(f"(d) tiny trainer 3 steps card vs CPU (float32, TF32 off): losses "
        f"{[r['loss'] for r in card]} / {[r['loss'] for r in cpu]}; max "
        f"relative diff of loss, "
        f"grad_norm, loss_by_position {worst:.3e} (limit "
        f"{TRAINER_CPU_RTOL})")
    if len(card) != 3 or worst > TRAINER_CPU_RTOL:
        raise AssertionError("small trainer: card and CPU differ")


def phase_trainer(smi: str) -> None:
    """The training loop at full width (a)-(c) and card against CPU (d),
    with the packer; checkpoints under a temporary directory of the
    checkout's ``build/``, removed afterwards."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_trainer_",
                            dir=os.path.join(ROOT, "build"))
    try:
        free = shutil.disk_usage(work).free
        log(f"trainer phase: {free / 1e9:.1f} GB free under {work}")
        if free < TRAINER_DISK_BYTES:
            raise RuntimeError(
                f"the trainer phase holds two 14.5 GB checkpoints at once "
                f"and needs {TRAINER_DISK_BYTES / 1e9:.0f} GB free under "
                f"{work}; {free / 1e9:.1f} GB are")
        phase_packer(smi)
        phase_trainer_small(work)
        phase_trainer_entry(work, smi)
        phase_trainer_resume(work, smi)
        phase_trainer_uptrain(work, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    started = time.perf_counter()
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
                            "flash_attention", "paged_attention", "w8a8"])
    log(f"kernel build {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for name, text in build.build_logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_label(line)
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {entry}: {line.strip()}")

    cfg = config.get_config(MODEL)
    vcfg = config.get_vanilla_config(VANILLA_MODEL)
    rows = []
    phase_k1(rows, cfg)
    phase_k2(rows, cfg, vcfg)
    phase_k2_bf16(rows, cfg)
    phase_k3(rows, cfg, vcfg)
    phase_k4(rows, cfg)
    phase_w8a8(rows, cfg, vcfg, smi)
    phase_k5(rows, cfg)
    phase_k6(rows, cfg)
    phase_k6(rows, cfg, int4=True)
    phase_k7(rows, cfg)
    phase_k8(rows, cfg)
    phase_k8(rows, cfg, int4=True)
    phase_family_kernels(rows)
    floor = launch_floor_ms()
    log(json.dumps({"launch_floor_ms": floor, "card": smi}))
    phase_small_reference()
    phase_small_quantized()
    phase_small_engine()
    phase_small_w8a8()
    phase_small_train_gptq()
    phase_small_families()
    launches, tok_s, tokens = {}, {}, {}
    for quantize in ("int8", "int4", "mixed48"):
        t0 = time.perf_counter()
        cfg, params = pg.main_path_model(seed=0, quantize=quantize)
        torch.cuda.synchronize()
        log(f"{MODEL}: random init + {quantize} quantization on the card "
            f"{time.perf_counter() - t0:.2f} s")
        kvs = ("int8", "bf16", "int4") if quantize == "int8" else ("int8",)
        for kv in kvs:
            launches[generation_path(quantize, kv)], tok_s[(quantize, kv)] = (
                phase_generation(cfg, params, quantize, kv))
        if quantize == "int8":
            launches["generation streaming"], _ = phase_generation(
                cfg, params, quantize, "int8", fresh=False)
            for kind in pg.ENGINE_KINDS:
                launches[f"engine {kind}"], tokens[kind] = phase_engine(
                    kind, cfg, params)
            phase_cache_agreement(cfg, params)
        del params
    for a, b in (("int8", "paged"), ("int4", "paged-int4")):
        log_agreement(a, b, tokens[a], tokens[b])
    vcfg, vparams = pg.vanilla_model(seed=0, quantize="int8")
    launches["vanilla"], tok_s["vanilla"] = phase_vanilla(vcfg, vparams)
    del vparams
    launches.update(phase_families(smi))
    phase_train_quantize(config.get_config(MODEL))
    phase_trainer(smi)
    log("block/vanilla generated tokens per second at B=8 p2048/d128, "
        "INT8 KV (smoke figures, not a benchmark): " + ", ".join(
            f"{q} {tok_s[(q, 'int8')] / tok_s['vanilla']:.3f}"
            for q in ("int8", "int4", "mixed48")))
    for row in rows:
        tag = row.pop("tag")
        row["launches"] = launches[row["path"]][tag]
        if tag == "K2 bf16":   # the launches of the row's own route
            row["route_launches"] = launches[row["path"]][
                f"K2 bf16 {row['decode_route']}"]
    log(f"chip_smoke.py total {time.perf_counter() - started:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
