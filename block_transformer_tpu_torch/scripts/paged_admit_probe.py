"""Decompose the paged engine's admission fixed cost (port of
``scripts/paged_admit_probe.py``).

The admit path's parts, each on a fresh engine (``--model``
``block_main_b4_1.2b``, random weights, ``--quantize`` INT8, ``--slots``
16, prompts of ``--prefill`` 2048 tokens, ``--decode`` 64 new ones),
warmed once, then ``--reps`` admits of the same prompts into a drained
engine, each bracketed by synchronizations; the median:

  1. contiguous INT8 engine admit (baseline): host prep + batched prefill
  2. paged admit, full: + page allocation + the page copy (K8)
  3. paged admit inside ``inference.engine.paged_probe_nocopy()``: the
     copy skipped (the pool is then wrong: a timing probe only; the JAX
     script's ``BT_PAGED_PROBE_NOCOPY=1``)

  paged_full - paged_nocopy     = the page copy's cost
  paged_nocopy - contiguous     = page-table allocation + mini-cache rest
  host_prep (measured apart)    = preprocessing / bucketing before dispatch

The device part of each admit is timed by wrapping the engine's
``_prefill`` (synchronized after each call). Also fits the per-dispatch
decode cost ``a + b * blocks`` of the contiguous and paged engines over
windows of 1, 2, 4 and 8 blocks (``_dispatch(window_len=w)``).

Runs on the card unless ``--cpu``; writes ``--out`` only. The JAX script's
TPU figures are not carried over.

    python -m block_transformer_tpu_torch.scripts.paged_admit_probe \\
        --out results/paged_admit_probe.json
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import time

import numpy as np
import torch


def _sync(eng) -> None:
    if torch.device(eng.device).type == "cuda":
        torch.cuda.synchronize()


def build_engine(kv, n_slots, prefill, decode, params, cfg, sync_blocks=8,
                 device="cuda"):
    from block_transformer_tpu_torch.inference.engine import (
        ContinuousBatchingEngine)
    L = cfg.block_length
    max_blocks = (prefill + decode) // L + 2
    ekw = {}
    if kv.startswith("paged"):
        n_emb = cfg.n_embedding_tokens
        cap = max_blocks * n_emb
        cap = -(-cap // 128) * 128 if cap >= 128 else cap
        ps = min(256, cap)
        n_virt = (-(-cap // ps) * ps) // ps
        ekw["pool_pages"] = n_slots * n_virt + 1
    return ContinuousBatchingEngine(
        params, cfg, n_slots=n_slots, max_blocks=max_blocks, kv_cache=kv,
        bucket_blocks=prefill // L, sync_blocks=sync_blocks, device=device,
        **ekw)


@torch.no_grad()
def time_admit(eng, prompts, decode, reps):
    """Median admit wall time + host-prep share over ``reps`` rounds.

    Each round submits the same prompts into a drained engine, times
    ``_admit`` end to end (synchronized after the prefill outputs), then
    runs the engine dry so slots free for the next round.
    """
    host_t, tot_t = [], []
    orig = eng._prefill
    dev_t = []

    def timed_prefill(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        _sync(eng)
        dev_t.append(time.perf_counter() - t0)
        return out

    eng._prefill = timed_prefill
    try:
        for r in range(reps + 1):               # +1 warmup
            for p in prompts:
                eng.submit(p, decode)
            dev_t.clear()
            _sync(eng)
            t0 = time.perf_counter()
            eng._admit()
            _sync(eng)
            dt = time.perf_counter() - t0
            if r > 0:
                tot_t.append(dt)
                host_t.append(dt - sum(dev_t))
            eng.run()                            # drain so slots free
    finally:
        eng._prefill = orig
    return {"admit_s_median": float(np.median(tot_t)),
            "admit_s_all": [round(t, 4) for t in tot_t],
            "host_prep_s_median": float(np.median(host_t))}


@torch.no_grad()
def window_overhead(eng, prompts, windows=(1, 2, 4, 8)):
    """Per-dispatch decode cost: time one decode window of w blocks for
    each w; fit t = a + b*w. Uses the engine's private window dispatch.
    Budgets are sized so every probed window decodes live slots (the
    decode loop stops once all slots die)."""
    L = eng.cfg.block_length
    n_prompt_blocks = -(-len(prompts[0]) // L) + 1     # ceil + boundary pad
    budget_blocks = eng.max_blocks - n_prompt_blocks - 2
    need = (len(windows) + 1) * 4 * max(windows)
    assert budget_blocks > need, (budget_blocks, need)
    for p in prompts:
        eng.submit(p, budget_blocks * L)
    eng._admit()
    _sync(eng)
    rows = []
    for w in windows:
        ts = []
        for r in range(4):                       # the first: warm-up
            _sync(eng)
            t0 = time.perf_counter()
            eng._dispatch(window_len=w)
            _sync(eng)
            if r:
                ts.append(time.perf_counter() - t0)
        rows.append((w, float(np.median(ts))))
    ws = np.array([r[0] for r in rows], np.float64)
    ts = np.array([r[1] for r in rows], np.float64)
    b, a = np.polyfit(ws, ts, 1)
    return {"windows": rows, "fixed_per_dispatch_s": float(a),
            "per_block_s": float(b)}


def main(argv=None) -> dict:
    """Time the three admits and the two window fits; returns the report
    written to ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="block_main_b4_1.2b")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--prefill", type=int, default=2048)
    ap.add_argument("--decode", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quantize", default="int8")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions) instead of the card")
    ap.add_argument("--out", default="results/paged_admit_probe.json")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.inference import engine as engine_mod
    from block_transformer_tpu_torch.models import block_transformer as bt
    from block_transformer_tpu_torch.ops import quant
    from block_transformer_tpu_torch.scripts import quality_run as qr
    from block_transformer_tpu_torch.utils import profiling

    device = qr.device_of(args)
    qr.log_device("paged_admit_probe", device)
    cfg = get_config(args.model)
    params = bt.init_block_transformer_params(0, cfg, dtype=torch.bfloat16,
                                              device=device)
    if args.quantize != "none":
        params = quant.quantize_block_transformer(params, bits=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 50254, size=args.prefill)
               for _ in range(args.slots)]

    out = {"model": args.model, "slots": args.slots,
           "prefill": args.prefill, "decode": args.decode}
    for name, kv, nocopy in [("contiguous", "int8", False),
                             ("paged", "paged", False),
                             ("paged_nocopy", "paged", True)]:
        with (engine_mod.paged_probe_nocopy() if nocopy
              else contextlib.nullcontext()):
            eng = build_engine(kv, args.slots, args.prefill, args.decode,
                               params, cfg, device=device)
            out[name] = time_admit(eng, prompts, args.decode, args.reps)
            print(f"[probe] {name}: admit "
                  f"{out[name]['admit_s_median']:.3f}s (host "
                  f"{out[name]['host_prep_s_median']:.3f}s)", flush=True)
            del eng
            if not nocopy:
                # the window probe needs budget for every probed window:
                # size the pool for 1024 decode tokens (256 blocks)
                eng2 = build_engine(kv, args.slots, args.prefill, 1024,
                                    params, cfg, device=device)
                out[name]["window_fit"] = window_overhead(eng2, prompts)
                print(f"[probe] {name}: dispatch fixed "
                      f"{out[name]['window_fit']['fixed_per_dispatch_s']:.4f}"
                      f"s + {out[name]['window_fit']['per_block_s']:.4f}"
                      f"s/blk", flush=True)
                del eng2
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    out["page_copy_s"] = (out["paged"]["admit_s_median"]
                          - out["paged_nocopy"]["admit_s_median"])
    out["paged_residual_vs_contig_s"] = (
        out["paged_nocopy"]["admit_s_median"]
        - out["contiguous"]["admit_s_median"])
    out["card"] = profiling.card_label(device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, dict)}, indent=1))
    return out


if __name__ == "__main__":
    main()
