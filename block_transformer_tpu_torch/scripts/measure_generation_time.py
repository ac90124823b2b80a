"""Generation-time benchmark (port of ``scripts/measure_generation_time.py``,
the analogue of the reference's measure_generation_time.py): a prefill /
decode regime, a warm-up run and ``--n_rep`` timed ones with mean and
standard deviation, ms a sample and a token, rows appended to
``<out>/<model>/generation_time.csv``, an optional ``torch.profiler``
trace, and the batch picked by device-memory accounting.

As in the JAX script, ``--batch auto`` predicts the bytes of weights, KV
caches and an activation margin (``utils/hbm.py``) against the card's
memory, where the reference tried batches until one ran out of memory;
the block prefill is clamped to at least 4 tokens while the row records
``--prefill`` as given; ``vanilla_*`` names run the baseline (prefill, then
one greedy decode step a token). Each run is timed between device
synchronizations. ``--profile`` traces the first timed run of the block
model with ``torch.profiler`` into ``<out>/<model>/trace/``. Everything
runs on the card unless ``--cpu`` is given.

    python -m block_transformer_tpu_torch.scripts.measure_generation_time \\
        --model block_main_b4_5 --prefill 128 --decode 2048 \\
        [--batch auto] [--profile]
"""

from __future__ import annotations

import argparse
import csv
import os
import statistics
import sys
import time

import numpy as np
import torch

from block_transformer_tpu_torch.utils.hbm import (  # noqa: F401
    auto_batch, block_model_bytes, hbm_bytes_limit, vanilla_model_bytes)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(run, device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    run()
    _sync(device)
    return time.perf_counter() - t0


def _dtype(dtype_str: str) -> torch.dtype:
    return torch.bfloat16 if dtype_str == "bfloat16" else torch.float32


def measure_block(model_name, batch, prefill, decode, dtype_str, n_rep,
                  profile_dir=None, device="cuda"):
    """(batch, seconds of each timed ``generate_blocks`` run) of the block
    model ``model_name`` at random parameters, greedy."""
    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.inference import generate as gen
    from block_transformer_tpu_torch.models import block_transformer as bt

    dtype = _dtype(dtype_str)
    cfg = get_config(model_name)
    if batch == "auto":
        batch = auto_batch(lambda b: block_model_bytes(cfg, b, prefill, decode))
        print(f"auto batch -> {batch}", file=sys.stderr)
    batch = int(batch)
    params = bt.init_block_transformer_params(0, cfg, dtype=dtype,
                                              device=device)
    L = cfg.block_length
    N = prefill // L
    max_blocks = (prefill + decode) // L
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(1, 50254, size=(batch, N, L)),
                          dtype=torch.int32, device=device)
    att = torch.ones((batch, N, L), dtype=torch.int32, device=device)
    bam = torch.ones((batch, N), dtype=torch.int32, device=device)

    def run():
        gen.generate_blocks(params, cfg, ids, att, bam, max_blocks=max_blocks,
                            greedy=True, device=device)

    run()  # warm-up
    times = []
    for i in range(n_rep):
        if profile_dir and i == 0:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                times.append(_timed(run, device))
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "generation.json"))
        else:
            times.append(_timed(run, device))
    return batch, times


def measure_vanilla(name, batch, prefill, decode, dtype_str, n_rep,
                    device="cuda"):
    """(batch, seconds of each timed run) of the vanilla baseline ``name``:
    a prefill of ``prefill`` tokens, then ``decode`` greedy steps."""
    from block_transformer_tpu_torch.config import get_vanilla_config
    from block_transformer_tpu_torch.models import neox, vanilla

    dtype = _dtype(dtype_str)
    cfg = get_vanilla_config(name)
    if batch == "auto":
        batch = auto_batch(
            lambda b: vanilla_model_bytes(cfg, b, prefill, decode))
        print(f"auto batch (vanilla) -> {batch}", file=sys.stderr)
    batch = int(batch)
    params = vanilla.init_vanilla_params(0, cfg, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(1, 50254, size=(batch, prefill)),
                          dtype=torch.int32, device=device)

    @torch.no_grad()
    def run():
        cache = neox.KVCache.create(cfg, batch, prefill + decode, dtype=dtype,
                                    device=device)
        logits, cache = vanilla.vanilla_prefill(params, cfg, ids, cache)
        tok = logits.argmax(-1).to(torch.int32)
        for _ in range(decode):
            logits, cache = vanilla.vanilla_decode_step(params, cfg, tok,
                                                        cache)
            tok = logits.argmax(-1).to(torch.int32)
        return tok

    run()
    times = [_timed(run, device) for _ in range(n_rep)]
    return batch, times


def main(argv=None) -> dict:
    """Measure, append the row to the CSV and return it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="block_main_b4_5",
                    help="block_main_* name or vanilla_* name")
    ap.add_argument("--batch", default="auto")
    ap.add_argument("--prefill", type=int, default=1)
    ap.add_argument("--decode", type=int, default=2048)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--n_rep", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default="results")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    os.makedirs(os.path.join(args.out, args.model), exist_ok=True)
    profile_dir = (os.path.join(args.out, args.model, "trace")
                   if args.profile else None)

    if args.model.startswith("vanilla"):
        batch, times = measure_vanilla(args.model, args.batch, args.prefill,
                                       args.decode, args.dtype, args.n_rep,
                                       device=device)
    else:
        # prefill must cover >= 1 block
        prefill = max(args.prefill, 4)
        batch, times = measure_block(args.model, args.batch, prefill,
                                     args.decode, args.dtype, args.n_rep,
                                     profile_dir, device=device)

    mean_ms = statistics.mean(times) * 1e3
    std_ms = statistics.stdev(times) * 1e3 if len(times) > 1 else 0.0
    row = {
        "model": args.model, "batch": batch, "prefill": args.prefill,
        "decode": args.decode, "dtype": args.dtype,
        "mean_ms": round(mean_ms, 2), "std_ms": round(std_ms, 2),
        "ms_per_sample": round(mean_ms / batch, 4),
        "ms_per_token": round(mean_ms / (batch * args.decode), 5),
        "tokens_per_sec": round(batch * args.decode / (mean_ms / 1e3), 1),
    }
    csv_path = os.path.join(args.out, args.model, "generation_time.csv")
    exists = os.path.isfile(csv_path)
    with open(csv_path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        if not exists:
            w.writeheader()
        w.writerow(row)
    print(row)
    return row


if __name__ == "__main__":
    main()
