"""The benchmark: decode throughput of the Block Transformer on one
NVIDIA GPU (port of the JAX benchmark ``bench.py``).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, in the JAX
benchmark's format, and writes the detail to ``--detail_out``.

Regime (the JAX benchmark's): prefill 2048 / decode 128 greedy, the block
model at ``--batch``, INT8 weights and an INT8 block-level KV cache by
default. ``vs_baseline`` is the decode-throughput ratio against the vanilla
GPTNeoX baseline at matched parameter count (precision-matched: the same
weight and cache widths) measured in the same process. ``--engine`` also
serves the same work through the continuous-batching engine, once at its
maximum window and once in latency mode.

Runs on the card unless ``--cpu`` (without a card and without ``--cpu`` it
refuses to run). Where it differs from the JAX benchmark:

- ``--detail_out`` defaults to ``build/BENCH_DETAIL.json`` (``build/`` is
  not tracked), not ``BENCH_DETAIL.json`` at the repository's root;
- there is no compile cache (nothing is compiled ahead of time but the
  CUDA kernels, which ``kernels/build.py`` builds once a process);
- ``--attn_impl`` is taken and changes nothing: the port's ``attention``
  sends every prompt-shaped block to its flash kernel under either value;
- the stage decomposition falls back to half the batch only when the card
  runs out of memory (``torch.cuda.OutOfMemoryError``); any other error
  raises;
- the stage decomposition also reports the card's busy time in each
  stage (``device_*`` keys, torch.profiler), and the MFU / HBM ratios are against
  the H100's peaks (``utils/roofline.py``), with no ``*_effective`` keys.

The JAX benchmark's environment variables keep their names and defaults:
``BT_BENCH_REPS`` (5), ``BT_INT4_GROUP`` (128), ``BT_SKIP_QUANT_HEAD`` (0),
``BT_BENCH_DECOMP`` (1), ``BT_BENCH_DECOMP_BATCH`` (the batch),
``BT_ENGINE_SYNC_BLOCKS`` (8).

    python -m block_transformer_tpu_torch.bench --batch 16 --engine \\
        [--prefill 2048] [--decode 128] [--quantize int8] [--kv int8] \\
        [--detail_out build/BENCH_DETAIL.json] [--cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from block_transformer_tpu_torch import config
from block_transformer_tpu_torch import profile_generate as pg
from block_transformer_tpu_torch.inference import engine as engine_lib
from block_transformer_tpu_torch.inference import generate as gen
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.models import vanilla
from block_transformer_tpu_torch.ops import quant
from block_transformer_tpu_torch.utils import hbm
from block_transformer_tpu_torch.utils import profiling
from block_transformer_tpu_torch.utils import roofline

ITERS = 32      # the stage decomposition's iterations a stage
DETAIL_OUT = os.path.join("build", "BENCH_DETAIL.json")


def _quant_kwargs(quantize: str, skip_head: bool) -> dict:
    """--quantize value -> quantize_block_transformer kwargs.

    mixed48 = block decoder INT8, token decoder INT4 (group scales), LM
    head INT8: at decode the token decoder re-reads its whole stack per
    *token* step (weight-streaming-bound) while the block decoder pays per
    *block* step, so INT4 goes where the bytes are and INT8 stays where
    quality is cheap.
    """
    group_size = int(os.environ.get("BT_INT4_GROUP", "128"))
    if quantize == "mixed48":
        return {"bits": 8, "token_decoder_bits": 4,
                "lm_head_bits": None if skip_head else 8,
                "skip_lm_head": skip_head, "group_size": group_size}
    return {"bits": 8 if quantize == "int8" else 4,
            "skip_lm_head": skip_head, "group_size": group_size}


def _dtype(dtype_str: str) -> torch.dtype:
    return torch.bfloat16 if dtype_str == "bfloat16" else torch.float32


def _reps() -> int:
    return int(os.environ.get("BT_BENCH_REPS", "5"))


def _block_params(cfg, dtype, quantize: Optional[str], device):
    """Random weights from seed 0 on ``device``, quantized as
    ``--quantize``."""
    params = bt.init_block_transformer_params(0, cfg, dtype=dtype,
                                              device=device)
    if quantize and quantize != "none":
        skip_head = os.environ.get("BT_SKIP_QUANT_HEAD", "0") == "1"
        params = quant.quantize_block_transformer(
            params, **_quant_kwargs(quantize, skip_head))
    return params


def _timed_reps(run) -> list:
    """Seconds of each of ``BT_BENCH_REPS`` calls of ``run`` (which waits
    for the card), after one untimed call."""
    run()
    times = []
    for _ in range(_reps()):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return times


def _release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


@torch.no_grad()
def bench_block(model_name: str, batch, prefill: int, decode: int,
                dtype_str: str = "bfloat16", quantize: str = None,
                kv_cache: str = "bf16", attn_impl: str = None, *,
                device="cuda"):
    """(decode tokens a second, batch, detail) of ``generate_blocks``:
    the median of ``BT_BENCH_REPS`` timed runs (prefill included) of
    ``batch`` random prompts of ``prefill`` tokens and ``decode`` new ones,
    then the stage decomposition at the headline batch."""
    dtype = _dtype(dtype_str)
    cfg = config.get_config(model_name)   # attn_impl changes nothing here
    if batch == "auto":
        batch = hbm.auto_batch(
            lambda b: hbm.block_model_bytes(cfg, b, prefill, decode,
                                            kv_cache=kv_cache,
                                            quantize=quantize))
        print(f"[bench] block auto batch -> {batch}", flush=True)
    batch = int(batch)
    params = _block_params(cfg, dtype, quantize, device)
    L = cfg.block_length
    N = prefill // L
    max_blocks = (prefill + decode) // L
    rng = np.random.default_rng(0)
    i32 = dict(dtype=torch.int32, device=device)
    ids = torch.as_tensor(rng.integers(1, 50254, size=(batch, N, L)), **i32)
    att = torch.ones((batch, N, L), **i32)
    bam = torch.ones((batch, N), **i32)

    def run():
        res = gen.generate_blocks(params, cfg, ids, att, bam,
                                  max_blocks=max_blocks, greedy=True,
                                  kv_cache=kv_cache, device=device)
        profiling.block_until_ready(res.tokens)
        return res

    times = _timed_reps(run)
    # the median: one stalled rep (times_s keeps every rep) would swing a
    # mean; std_s still flags it
    dt = float(np.median(times))
    detail = {
        "median_s": dt, "mean_s": float(np.mean(times)),
        "std_s": float(np.std(times)), "reps": len(times),
        "ms_per_sample": 1e3 * dt / batch,
        "ms_per_token": 1e3 * dt / (batch * decode),
        "times_s": [round(t, 4) for t in times],
    }
    if os.environ.get("BT_BENCH_DECOMP", "1") != "0":
        # stage timings at the HEADLINE batch, so that the MFU fields
        # describe the operating point; a stage that does not fit on the
        # card halves the probe batch (per-block-step times scale about
        # linearly in batch) and is recorded
        dbatch = min(batch, int(os.environ.get("BT_BENCH_DECOMP_BATCH",
                                               str(batch))))
        d = None
        while dbatch >= 16:
            try:
                d = _two_level_decomposition(params, cfg, dbatch, prefill,
                                             decode, dtype, kv_cache)
                break
            except torch.cuda.OutOfMemoryError as e:
                detail.setdefault("decomposition_fallbacks", []).append(
                    {"batch": dbatch, "error": str(e)[:160]})
            dbatch //= 2
            _release()
        if d is not None:
            d["decomposition_batch"] = dbatch
            detail.update(d)
            try:
                detail.update(roofline.mfu_summary(
                    cfg, batch=dbatch, prefill=prefill, decode=decode,
                    kv_cache=kv_cache, quantize=quantize,
                    bd_ms=d.get("block_decoder_ms_per_block_step"),
                    td_ms=d.get("token_decoder_ms_per_block_step"),
                    prefill_ms=d.get("prefill_ms")))
            except ValueError as e:  # hbm.weight_bytes: an unmodelled width
                detail["decomposition_error"] = str(e)[:200]
        else:
            detail["decomposition_error"] = "all probe batches failed"
    tps = batch * decode / dt
    try:
        # headline MFU: whole-run tok/s x analytic FLOPs/token at the full
        # batch against the bf16 peak (prefill time in the denominator, so
        # it lower-bounds the decode-stage MFU above)
        m = roofline.decode_stage_model(cfg, batch, prefill, decode,
                                        kv_cache, quantize)
        detail["mfu_decode_headline"] = (
            tps * m["flops_per_token"]) / roofline.PEAK_BF16_FLOPS
    except ValueError:  # hbm.weight_bytes: an unmodelled width
        pass
    return tps, batch, detail


@torch.no_grad()
def _two_level_decomposition(params, cfg, batch, prefill, decode, dtype,
                             kv_cache, iters: Optional[int] = None):
    """Block-decoder against token-decoder time at the decode operating
    point (the reference's ``benchmark=True`` timing). Each stage loops
    ``iters`` (``ITERS``) times with a data dependence, issued from Python:

    - token: ``decode_block_tokens`` on block embeddings that depend on the
      previous iterations' tokens;
    - block: ``_block_decoder_step`` of one block on a cache filled to the
      prompt, its length reset after each step so the cache is updated in
      place at the same slots; the time of a cache-only fill (creating the
      zeroed cache, which a real decode never pays a step) is subtracted;
    - prefill: ``prefill_blocks`` of the prompt at this batch, the best of
      three.

    Each stage runs once untimed, then is timed by the host clock between
    synchronizations (``prefill_ms``, ``token_decoder_ms_per_block_step``,
    ``block_decoder_ms_per_block_step``). On the card one more call runs
    under torch.profiler, and the same keys with ``device_`` before them
    give the card's busy time in it: the union of its kernels' spans
    (``profile_generate.device_breakdown``), the host's issue gaps left
    out. (CUDA events behind a spin cannot leave them out here: a stage
    issues thousands of launches, more than the launch queue holds.) Every
    stage output passes ``profiling.block_until_ready``."""
    iters = iters or ITERS
    device = params["embedder"]["embeddings"]["weight"].device
    n = cfg.n_embedding_tokens
    ph = cfg.embedder.projection_hidden_size
    slots = (prefill + decode) // cfg.block_length * n
    capacity = -(-slots // 128) * 128
    filled = prefill // cfg.block_length * n
    be = torch.zeros((batch, n, ph), dtype=dtype, device=device)

    def token_stage():
        acc = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(iters):
            toks, _ = gen.decode_block_tokens(params, cfg, be + acc * 1e-9,
                                              greedy=True)
            acc = acc + toks.sum(dtype=torch.int32)
        return acc

    def make_cache():
        return neox.make_kv_cache(cfg.block_decoder, batch, capacity,
                                  kv_cache, dtype=dtype, device=device)

    def block_stage():
        cache = make_cache()._replace(length=filled)
        kv_valid = (torch.arange(capacity, device=device)[None]
                    < filled).to(torch.int32).repeat(batch, 1)
        new_valid = torch.ones((batch, n), dtype=torch.int32, device=device)
        x = be
        for _ in range(iters):
            h, cache, kv_valid = gen._block_decoder_step(
                params, cfg, x, cache, kv_valid, new_valid)
            cache = cache._replace(length=cache.length - n)  # stay in place
            x = h[:, -n:, :].to(x.dtype)
        return x

    def cache_only():
        # the zero fill of the cache, with a data dependence on it
        return be + torch.flatten(make_cache()[0])[0].to(be.dtype)

    # the prefill stage: the prompt pass at this batch, as generate_blocks
    # runs it
    N = max(1, prefill // cfg.block_length)
    rng = np.random.default_rng(0)
    p_ids = torch.as_tensor(rng.integers(1, cfg.embedder.vocab_size - 2,
                                         size=(batch, N, cfg.block_length)),
                            dtype=torch.int32, device=device)
    p_att = torch.ones_like(p_ids)
    p_bam = torch.ones((batch, N), dtype=torch.int32, device=device)

    def prefill_stage():
        ne, cache, kv_valid = gen.prefill_blocks(
            params, cfg, p_ids, p_att, p_bam, capacity=capacity,
            kv_cache=kv_cache)
        return ne

    def timed(stage, reps=1):
        """(the card's busy s or None off it, the best wall s of ``reps``
        calls) of ``stage``, synced through ``profiling.block_until_ready``,
        after one untimed call."""
        run = lambda: profiling.block_until_ready(stage())   # noqa: E731
        run()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        busy = (pg.device_breakdown(run)[1] / 1e6
                if torch.device(device).type == "cuda" else None)
        return busy, min(walls)

    times = {"prefill": timed(prefill_stage, 3), "token": timed(token_stage),
             "fill": timed(cache_only), "block": timed(block_stage)}
    out = {}
    for i, key in enumerate(("", "device_")):
        t = {k: v[1 - i] for k, v in times.items()}
        if t["prefill"] is None:
            continue
        out[f"{key}prefill_ms"] = 1e3 * t["prefill"]
        out[f"{key}token_decoder_ms_per_block_step"] = \
            1e3 * t["token"] / iters
        out[f"{key}block_decoder_ms_per_block_step"] = \
            1e3 * max(0.0, t["block"] - t["fill"]) / iters
    return out


@torch.no_grad()
def bench_vanilla(name: str, batch, prefill: int, decode: int,
                  dtype_str: str = "bfloat16", quantize: str = None,
                  kv_cache: str = "bf16", *, device="cuda"):
    """Vanilla GPTNeoX baseline at the same protocol as bench_block.

    ``quantize``/``kv_cache`` build the precision-matched baseline: the
    same quantize_model_params INT8/INT4 weights and the same token-level
    INT8/INT4 cache the block model gets, auto-batched with the same
    static memory model. The vanilla cache bounds its batch, so quantizing
    it raises its feasible batch: the architecture-only comparison is
    block-quantized against vanilla-quantized.
    """
    dtype = _dtype(dtype_str)
    cfg = config.get_vanilla_config(name)
    if batch == "auto":
        # vanilla decode holds about two cache copies through the loop
        batch = hbm.auto_batch(
            lambda b: hbm.vanilla_model_bytes(cfg, b, prefill, decode,
                                              kv_cache=kv_cache,
                                              quantize=quantize),
            margin=0.4)
        print(f"[bench] vanilla auto batch -> {batch}", flush=True)
    batch = int(batch)
    params = vanilla.init_vanilla_params(0, cfg, dtype=dtype, device=device)
    if quantize and quantize != "none":
        params = quant.quantize_model_params(
            params, bits=8 if quantize == "int8" else 4,
            group_size=int(os.environ.get("BT_INT4_GROUP", "128")))

    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(1, 50254, size=(batch, prefill)),
                          dtype=torch.int32, device=device)

    def run():
        # the cache is made inside the timed call, as the JAX benchmark
        # makes it inside its jit
        profiling.block_until_ready(pg.vanilla_generate(
            params, cfg, ids, decode, kv_cache=kv_cache, dtype=dtype))

    times = _timed_reps(run)
    dt = float(np.median(times))          # stall-robust (see bench_block)
    detail = {"median_s": dt, "mean_s": float(np.mean(times)),
              "std_s": float(np.std(times)), "reps": len(times),
              "ms_per_sample": 1e3 * dt / batch,
              "ms_per_token": 1e3 * dt / (batch * decode),
              "quantize": quantize or "none", "kv_cache": kv_cache}
    return batch * decode / dt, batch, detail


@torch.no_grad()
def bench_engine(model_name: str, n_slots: int, prefill: int, decode: int,
                 dtype_str: str = "bfloat16", quantize: str = None,
                 kv_cache: str = "int8", latency_mode: bool = False, *,
                 device="cuda"):
    """Continuous-batching engine throughput: n_slots concurrent prompts,
    steady-state decode tok/s. ``latency_mode`` runs the TTFT-bounded
    window ramp (short first window, geometric growth) and reports the
    latency metrics alongside throughput."""
    dtype = _dtype(dtype_str)
    cfg = config.get_config(model_name)
    params = _block_params(cfg, dtype, quantize, device)
    L = cfg.block_length
    max_blocks = (prefill + decode) // L + 2
    ekw = {}
    if kv_cache.startswith("paged"):
        # every request is max-length, so the memory paging reclaims is
        # zero by construction: a pool sized to the workload (every slot at
        # full length) measures paging's overhead at the same capacity as
        # the contiguous cache, where the engine's default pool (half the
        # dense footprint) would admit only half the slots
        ekw["pool_pages"] = pg.full_pool_pages(cfg, n_slots, max_blocks)
    eng = engine_lib.ContinuousBatchingEngine(
        params, cfg, n_slots=n_slots, max_blocks=max_blocks,
        kv_cache=kv_cache, bucket_blocks=prefill // L,
        sync_blocks=int(os.environ.get("BT_ENGINE_SYNC_BLOCKS", "8")),
        latency_mode=latency_mode, device=device, **ekw)
    rng = np.random.default_rng(0)

    def submit_all():
        for _ in range(n_slots):
            eng.submit(rng.integers(1, 50254, size=prefill), decode)

    submit_all()
    eng.run()                               # warm-up
    n_rep = _reps()
    runs = []
    for _ in range(n_rep):
        tokens0 = eng.stats.tokens_generated
        steps0 = eng.stats.steps
        waste0 = eng.stats.tokens_wasted
        done0 = len(eng.completed)
        submit_all()
        t0 = time.perf_counter()
        eng._admit()                        # batched prefill of all slots
        profiling.block_until_ready(eng.next_embeds)
        t_admit = time.perf_counter() - t0
        eng.run()
        runs.append({"dt": time.perf_counter() - t0, "admit": t_admit,
                     "produced": eng.stats.tokens_generated - tokens0,
                     "steps": eng.stats.steps - steps0,
                     "wasted": eng.stats.tokens_wasted - waste0,
                     # the median rep's latency describes the same
                     # requests as its throughput
                     "latency": eng.latency_metrics(skip=done0)})
    med = sorted(runs, key=lambda r: r["dt"])[len(runs) // 2]
    produced, dt = med["produced"], med["dt"]
    tps = produced / dt
    out = {"engine_tokens": produced, "engine_time_s": dt,
           "engine_admit_s": med["admit"],
           "engine_times_s": [round(r["dt"], 4) for r in runs],
           "reps": n_rep,
           "n_slots": n_slots,
           "latency_mode": latency_mode,
           "dispatches": med["steps"],
           "tokens_wasted": med["wasted"],
           "latency": med["latency"],
           "latency_all_reps": eng.latency_metrics()}
    try:
        # engine-mode MFU / HBM utilization at the serving operating point
        # (n_slots rows): whole-run tok/s x analytic per-token cost
        m = roofline.decode_stage_model(cfg, n_slots, prefill, decode,
                                        kv_cache, quantize)
        out["mfu_engine"] = tps * m["flops_per_token"] / roofline.PEAK_BF16_FLOPS
        if m.get("bytes_per_token"):
            out["hbm_util_engine"] = (
                tps * m["bytes_per_token"]) / roofline.PEAK_HBM_GBPS
    except ValueError:  # hbm.weight_bytes: an unmodelled width
        pass
    return tps, out


def main(argv=None) -> dict:
    """Run the benchmark; prints its JSON line and returns {"line": that
    line, "detail": what ``--detail_out`` holds}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # defaults: 1.2B, prefill 2048 / decode 128, each model at its max
    # feasible batch (static memory search)
    ap.add_argument("--model", default="block_main_b4_1.2b")
    ap.add_argument("--vanilla", default="vanilla_410")
    ap.add_argument("--batch", default="auto",
                    help="int or 'auto' (per-model static-memory batch "
                    "search)")
    ap.add_argument("--vanilla_batch", default=None,
                    help="vanilla baseline batch (defaults to --batch)")
    ap.add_argument("--vanilla_quantize",
                    choices=["none", "int8", "int4"], default="int8",
                    help="vanilla weight quantization — the precision-"
                    "matched baseline (default int8 = same width as the "
                    "block side; 'none' gives the bf16 baseline)")
    ap.add_argument("--vanilla_kv", choices=["bf16", "int8", "int4"],
                    default="int8",
                    help="vanilla token-level KV cache dtype (default int8 "
                    "to match the block side's quantized cache; its cache "
                    "bounds its batch, so this raises its feasible batch)")
    ap.add_argument("--prefill", type=int, default=2048)
    ap.add_argument("--decode", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--quantize",
                    choices=["int8", "int4", "mixed48", "none"],
                    default="int8",
                    help="weight quantization (default: int8 weights + "
                    "int8 KV)")
    ap.add_argument("--kv", choices=["bf16", "int8", "int4"], default="int8",
                    help="global block-level KV cache dtype (default int8; "
                    "gate an int4 cache on your own checkpoint with "
                    "scripts/decode_gate.py first)")
    ap.add_argument("--engine_kv", default=None,
                    help="engine-mode cache override: bf16/int8/int4/paged "
                    "(default: --kv, with int4 served as int8, as the JAX "
                    "benchmark does)")
    ap.add_argument("--attn_impl", choices=["xla", "pallas"], default=None,
                    help="the JAX attention switch: taken, and changes "
                    "nothing here (every prompt-shaped block takes the "
                    "flash kernel under either value)")
    ap.add_argument("--engine", action="store_true",
                    help="also benchmark the continuous-batching engine")
    ap.add_argument("--engine_slots", type=int, default=16)
    ap.add_argument("--engine_only", action="store_true",
                    help="skip the static block/vanilla benches")
    ap.add_argument("--detail_out", default=DETAIL_OUT)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions) "
                    "instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (--cpu runs on the CPU)")
    print(f"[bench] device {device} ({profiling.card_label(device)}), "
          f"torch {torch.__version__}", file=sys.stderr, flush=True)

    block_tps, block_batch, block_detail = 0.0, 0, {}
    if not args.engine_only:
        block_tps, block_batch, block_detail = bench_block(
            args.model, args.batch, args.prefill, args.decode, args.dtype,
            args.quantize, args.kv, args.attn_impl, device=device)
        print(f"[bench] block: {block_tps:.1f} tok/s at b{block_batch} "
              f"(std {block_detail['std_s']:.3f}s over {block_detail['reps']}; "
              f"{block_detail['ms_per_token']:.4f} ms/tok; decomposition: "
              f"block {block_detail.get('block_decoder_ms_per_block_step', 0):.2f} "
              f"/ token {block_detail.get('token_decoder_ms_per_block_step', 0):.2f}"
              f" ms per block step)", file=sys.stderr, flush=True)
        _release()

    engine_detail = {}
    if args.engine:
        engine_kv = args.engine_kv or (
            "int8" if args.kv == "int4" else args.kv)
        engine_tps, engine_detail = bench_engine(
            args.model, args.engine_slots, args.prefill, args.decode,
            args.dtype, args.quantize, engine_kv, device=device)
        engine_detail["engine_tok_per_s"] = engine_tps
        print(f"[bench] engine: {engine_tps:.1f} tok/s at {args.engine_slots} "
              f"slots", file=sys.stderr, flush=True)
        _release()
        # latency-mode row: the TTFT-bounded window ramp
        lat_tps, lat_detail = bench_engine(
            args.model, args.engine_slots, args.prefill, args.decode,
            args.dtype, args.quantize, engine_kv, latency_mode=True,
            device=device)
        lat_detail["engine_tok_per_s"] = lat_tps
        lat_detail["throughput_vs_max_mode"] = (
            lat_tps / engine_tps if engine_tps else None)
        engine_detail["latency_mode_row"] = lat_detail
        print(f"[bench] engine latency-mode: {lat_tps:.1f} tok/s "
              f"({100 * lat_tps / max(engine_tps, 1e-9):.0f}% of max mode; "
              f"ttft_p50={lat_detail['latency'].get('ttft_s_p50', -1):.2f}s)",
              file=sys.stderr, flush=True)
        _release()

    regime = {"prefill": args.prefill, "decode": args.decode,
              "quantize": args.quantize, "kv": args.kv}
    if args.engine_only:
        detail = {"engine": engine_detail, "engine_only": True,
                  "engine_slots": args.engine_slots, "regime": regime}
        line = {
            "metric": f"engine_tokens_per_sec[{args.model} "
                      f"slots{args.engine_slots} p{args.prefill}/"
                      f"d{args.decode}]",
            "value": round(engine_detail.get("engine_tok_per_s", 0.0), 1),
            "unit": "tok/s", "vs_baseline": None}
    else:
        vanilla_tps, vanilla_batch, van_detail = bench_vanilla(
            args.vanilla, args.vanilla_batch or args.batch, args.prefill,
            args.decode, args.dtype, args.vanilla_quantize, args.vanilla_kv,
            device=device)
        ratio = block_tps / vanilla_tps if vanilla_tps > 0 else 0.0
        detail = {"block": block_detail, "vanilla": van_detail,
                  "engine": engine_detail,
                  "block_tok_per_s": block_tps,
                  "vanilla_tok_per_s": vanilla_tps,
                  "block_batch": block_batch,
                  "vanilla_batch": vanilla_batch, "regime": regime}
        vq = ("" if args.vanilla_quantize == "none"
              else f"-{args.vanilla_quantize}")
        vkv = {"int8": "-kv8", "int4": "-kv4"}.get(args.vanilla_kv, "")
        line = {
            "metric": f"decode_tokens_per_sec[{args.model}"
                      f"{'-' + args.quantize if args.quantize and args.quantize != 'none' else ''}"
                      f"{ {'int8': '-kv8', 'int4': '-kv4'}.get(args.kv, '') }"
                      f" b{block_batch} "
                      f"p{args.prefill}/d{args.decode} vs {args.vanilla}{vq}{vkv} "
                      f"b{vanilla_batch}]",
            "value": round(block_tps, 1),
            "unit": "tok/s",
            "vs_baseline": round(ratio, 3),
        }
    os.makedirs(os.path.dirname(args.detail_out) or ".", exist_ok=True)
    with open(args.detail_out, "w") as f:
        json.dump(detail, f, indent=2)
    print(json.dumps(line), flush=True)
    return {"line": line, "detail": detail}


if __name__ == "__main__":
    main()
