"""Time and trace the port's main path on one NVIDIA GPU.

    python -m block_transformer_tpu_torch.profile_generate [--runs 5]

Builds ``block_main_b4_1.2b`` at full width (random bf16 weights from a seed,
INT8 weights, INT8 global KV cache) and generates greedily for B=8 ragged
prompts of 2048 tokens plus 128 new tokens, as ``chip_smoke.py`` does. After
one warm-up run it reports, on the host clock with the device synchronized:

- ``--runs`` timed ``generate_blocks`` runs: median and quartiles of the
  seconds and of the generated tokens per second (prefill included);
- ``--runs`` timed ``prefill_blocks`` runs alone (the decode loop is the
  difference);

then one run under ``torch.profiler`` (CPU and CUDA activity): device time
and launches per kernel name, the device's busy time (union of kernel
intervals) and its idle share of the median untraced run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

from block_transformer_tpu_torch import config
from block_transformer_tpu_torch.inference import generate as gen
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.ops import quant

MODEL = "block_main_b4_1.2b"
BATCH, PROMPT_TOKENS, NEW_TOKENS = 8, 2048, 128


def main_path_model(seed: int = 0, model: str = MODEL):
    """(cfg, params): random bf16 weights on the card, quantized to INT8."""
    cfg = config.get_config(model)
    params = bt.init_block_transformer_params(seed, cfg, dtype=torch.bfloat16,
                                              device="cuda")
    return cfg, quant.quantize_block_transformer(params, bits=8)


def ragged_prompts(cfg, batch: int = BATCH, prompt_tokens: int = PROMPT_TOKENS,
                   seed: int = 0):
    """(ids, attention_mask, block_attention_mask) in block format: random
    tokens, row b left-padded by 4*b blocks."""
    L = cfg.block_length
    N = prompt_tokens // L
    ids = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (batch, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    for b in range(batch):
        ids[b, :4 * b], att[b, :4 * b] = 0, 0
    return ids, att, att.any(-1).astype(np.int32)


def quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "n": len(xs)}


def timed(fn, runs: int):
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_breakdown(fn):
    """Run ``fn`` under torch.profiler; returns (per-kernel {name: [us,
    launches]}, busy microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        per[e.name][0] += us
        per[e.name][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    return dict(per), _busy_us(spans)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate: no CUDA device")
    cfg, params = main_path_model(args.seed)
    ids, att, bam = ragged_prompts(cfg, seed=args.seed)
    N = ids.shape[1]
    max_blocks = N + NEW_TOKENS // cfg.block_length
    dev = [torch.as_tensor(a, device="cuda") for a in (ids, att, bam)]

    def run():
        return gen.generate_blocks(params, cfg, *dev, max_blocks=max_blocks,
                                   kv_cache="int8", device="cuda")

    def prefill():
        return gen.prefill_blocks(params, cfg, *dev,
                                  capacity=-(-max_blocks // 128) * 128,
                                  kv_cache="int8")

    res = run()
    generated = BATCH * (res.n_blocks - N) * cfg.block_length
    total = timed(run, args.runs)
    pre = timed(prefill, args.runs)
    per, busy_us = device_breakdown(run)
    wall = statistics.median(total)
    print(json.dumps({
        "model": MODEL, "batch": BATCH, "prompt_tokens": PROMPT_TOKENS,
        "new_tokens_per_row": NEW_TOKENS, "generated_tokens": generated,
        "generate_s": quartiles(total),
        "tok_per_s": quartiles([generated / t for t in total]),
        "prefill_s": quartiles(pre),
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall}))
    print(f"{'device us':>12} {'launches':>9}  kernel")
    for name, (us, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"{us:12.1f} {n:9d}  {name[:110]}")


if __name__ == "__main__":
    main()
