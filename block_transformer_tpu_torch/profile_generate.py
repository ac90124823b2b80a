"""Time and trace the port's main paths on one NVIDIA GPU.

    python -m block_transformer_tpu_torch.profile_generate [--runs 5]
        [--quantize int8|int4|mixed48] [--kv int8|int4|bf16]
        [--w8a8 on|off] [--fresh_prefill 0|1]
    python -m block_transformer_tpu_torch.profile_generate
        --engine int8|int4|paged|paged-int4
    python -m block_transformer_tpu_torch.profile_generate --vanilla
        [--vanilla_quantize int8|int4]

Builds ``block_main_b4_1.2b`` at full width (random bf16 weights from a seed),
as ``chip_smoke.py`` does, with the weights of ``--quantize``: ``int8``
(default), ``int4`` (group size 128) or ``mixed48`` (block decoder INT8,
token decoder INT4, LM head INT8), as ``bench.py --quantize`` builds them.
Without ``--engine`` it generates greedily with the global KV cache of
``--kv`` (INT8 by default, INT4, or bf16) for B=8 ragged prompts of 2048
tokens plus 128 new tokens; after one warm-up run it reports, on the host
clock with the device synchronized:

- ``--runs`` timed ``generate_blocks`` runs: median and quartiles of the
  seconds and of the generated tokens per second (prefill included);
- ``--runs`` timed ``prefill_blocks`` runs alone (the decode loop is the
  difference), under the KV mode ``generate_blocks`` declares.

``--fresh_prefill 0`` takes the streaming prefill (chunks of 128 blocks
through the cache) instead of the fresh one. ``--w8a8 off`` keeps every INT8
linear on K1 (``ops.linear.w8a8_disabled``), in every mode; by default INT8
linears at prefill-sized M take W8A8 (``ops.linear._use_w8a8``).

With ``--vanilla`` it runs the baseline instead: ``vanilla_410`` (random
bf16 weights, INT8 or INT4 weights, an INT8 KV cache), greedy, for B=8
unpadded prompts of 2048 random tokens: prefill, then 128 decode steps, each
an argmax and a ``vanilla_decode_step`` (``bench.py``'s ``full_generate``
as a host loop); it reports the runs and the prefills alone as above.

With ``--engine`` it serves the smoke's engine traffic instead (16 slots,
24 requests: 8 of 512 prompt tokens and 32 new ones, then 16 of 2048 and
128) through ``ContinuousBatchingEngine`` with the contiguous INT8 or INT4
cache (``int8``, ``int4``) or the paged INT8 or INT4 pool (``paged``,
``paged-int4``): after one warm-up, ``--runs`` timed ``run()`` calls
(seconds, generated tokens per second, dispatches).

Either way it then traces one more run under ``torch.profiler`` (CPU and
CUDA activity): device time and launches per kernel name, the device's busy
time (union of kernel intervals) and its idle share of the median untraced
run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

from block_transformer_tpu_torch import config
from block_transformer_tpu_torch.inference import engine as engine_lib
from block_transformer_tpu_torch.inference import generate as gen
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.models import vanilla
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import quant

MODEL, VANILLA_MODEL = "block_main_b4_1.2b", "vanilla_410"
BATCH, PROMPT_TOKENS, NEW_TOKENS = 8, 2048, 128
GROUP_SIZE = 128          # INT4 rows per scale group (bench.py's default)
# --quantize -> quantize_block_transformer arguments (bench.py _quant_kwargs)
QUANTIZE = {
    "int8": dict(bits=8),
    "int4": dict(bits=4, group_size=GROUP_SIZE),
    "mixed48": dict(bits=8, token_decoder_bits=4, lm_head_bits=8,
                    group_size=GROUP_SIZE),
}


def main_path_model(seed: int = 0, model: str = MODEL,
                    quantize: str = "int8"):
    """(cfg, params): random bf16 weights on the card, quantized as
    ``--quantize``."""
    cfg = config.get_config(model)
    params = bt.init_block_transformer_params(seed, cfg, dtype=torch.bfloat16,
                                              device="cuda")
    return cfg, quant.quantize_block_transformer(params, **QUANTIZE[quantize])


def vanilla_model(seed: int = 0, model: str = VANILLA_MODEL,
                  quantize: str = "int8", dtype=torch.bfloat16,
                  device="cuda"):
    """(cfg, params) of the baseline: random weights quantized to
    ``quantize`` (``int8`` or ``int4``, group size 128), as ``bench.py
    --vanilla_quantize`` builds them."""
    cfg = config.get_vanilla_config(model)
    params = vanilla.init_vanilla_params(seed, cfg, dtype=dtype, device=device)
    bits = {"int8": 8, "int4": 4}[quantize]
    return cfg, quant.quantize_model_params(params, bits,
                                            group_size=GROUP_SIZE)


def vanilla_generate(params, cfg, ids: torch.Tensor, new_tokens: int):
    """Greedy baseline generation with an INT8 KV cache for prompts ids
    [B, P]: prefill, then ``new_tokens`` decode steps. Returns the tokens
    [B, new_tokens + 1] (the prefill's, then one per step)."""
    B, P = ids.shape
    cache = neox.make_kv_cache(cfg, B, P + new_tokens, "int8",
                               device=ids.device)
    logits, cache = vanilla.vanilla_prefill(params, cfg, ids, cache)
    out = torch.empty((B, new_tokens + 1), dtype=torch.int32,
                      device=ids.device)
    out[:, 0] = torch.argmax(logits, -1)
    for i in range(new_tokens):
        logits, cache = vanilla.vanilla_decode_step(params, cfg, out[:, i],
                                                    cache)
        out[:, i + 1] = torch.argmax(logits, -1)
    return out


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


# the engine's traffic: (requests, prompt tokens, new tokens), submitted
# together in this order; 16 slots, so the short requests finish early and
# the last long ones are admitted mid-flight into reused slots
ENGINE_TRAFFIC = ((8, 512, 32), (16, 2048, 128))
ENGINE_KINDS = ("int8", "int4", "paged", "paged-int4")
ENGINE_SLOTS, ENGINE_MAX_BLOCKS = 16, 546
ENGINE_BUCKET_BLOCKS, ENGINE_SYNC_BLOCKS, ENGINE_PAGE_SIZE = 128, 8, 256


def engine_requests(cfg, traffic=ENGINE_TRAFFIC, seed: int = 0):
    """[(prompt token ids, max_new_tokens)] with random tokens in
    [1, vocab)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, cfg.vocab_size, prompt).astype(np.int32), new)
            for count, prompt, new in traffic for _ in range(count)]


def make_engine(params, cfg, kv_cache: str, *, n_slots: int = ENGINE_SLOTS,
                max_blocks: int = ENGINE_MAX_BLOCKS,
                bucket_blocks: int = ENGINE_BUCKET_BLOCKS,
                page_size: int = ENGINE_PAGE_SIZE, device="cuda"):
    """The smoke's engine. A paged pool holds n_slots * n_virt + 1 pages,
    enough for every slot at full length (as ``bench.py`` sizes it)."""
    cap = max_blocks * cfg.n_embedding_tokens
    cap = -(-cap // 128) * 128 if cap >= 128 else cap
    ps = min(page_size, cap)
    n_virt = -(-cap // ps)
    return engine_lib.ContinuousBatchingEngine(
        params, cfg, n_slots=n_slots, max_blocks=max_blocks,
        kv_cache=kv_cache, bucket_blocks=bucket_blocks,
        sync_blocks=ENGINE_SYNC_BLOCKS, page_size=page_size,
        pool_pages=n_slots * n_virt + 1, device=device)


def serve(engine, requests) -> dict:
    """Submit ``requests`` together and run the engine until they are done,
    on the host clock with the device synchronized. Returns the requests,
    the seconds, the seconds of the first admission (the batched prefill of
    the first slots) and the engine's counters and latencies for this run."""
    done0, steps0 = len(engine.completed), engine.stats.steps
    tokens0 = engine.stats.tokens_generated
    for prompt, new in requests:
        engine.submit(prompt, new)
    reqs = list(engine.waiting)
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    engine._admit()
    sync()
    admit_s = time.perf_counter() - t0
    engine.run()
    sync()
    return {"requests": reqs, "seconds": time.perf_counter() - t0,
            "admit_s": admit_s, "dispatches": engine.stats.steps - steps0,
            "tokens": engine.stats.tokens_generated - tokens0,
            "latency": engine.latency_metrics(skip=done0)}


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


# the kernels of csrc/*.cu, as the profiler names them
OWN_KERNELS = ("tc_matmul_kernel", "int8_matmul_kernel", "int4_matmul_kernel",
               "splitk_reduce_kernel",
               "decode_attn_int8_kernel", "decode_attn_kernel",
               "decode_attn_warp_kernel",
               "flash_attn_kernel",
               "flash_attn_tc_kernel",
               "paged_write_kernel", "page_copy_kernel", "paged_attn_kernel",
               "w8a8_quant_kernel", "w8a8_wgmma_kernel")


def print_breakdown(per) -> None:
    """The 25 largest kernel names by device time, then the port's own
    kernels that fell below."""
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    own = [kv for kv in ranked[25:]
           if any(f"(anonymous namespace)::{k}" in kv[0]
                  for k in OWN_KERNELS)]
    print(f"{'device us':>12} {'launches':>9}  kernel")
    for name, (us, n) in ranked[:25] + own:
        print(f"{us:12.1f} {n:9d}  {name[:110]}")
    print(f"{sum(us for us, _ in per.values()):12.1f} "
          f"{sum(n for _, n in per.values()):9d}  (every kernel)")


def profile_engine(kind: str, cfg, params, runs: int, seed: int,
                   w8a8: str = "on") -> None:
    eng = make_engine(params, cfg, kind)
    requests = engine_requests(cfg, seed=seed)
    serve(eng, requests)                           # warm-up
    out = [serve(eng, requests) for _ in range(runs)]
    secs = [r["seconds"] for r in out]
    per, busy_us = device_breakdown(lambda: serve(eng, requests))
    wall = statistics.median(secs)
    print(json.dumps({
        "model": MODEL, "engine": kind, "w8a8": w8a8,
        "n_slots": ENGINE_SLOTS,
        "traffic": ENGINE_TRAFFIC, "max_blocks": ENGINE_MAX_BLOCKS,
        "generated_tokens": [r["tokens"] for r in out],
        "run_s": quartiles(secs),
        "tok_per_s": quartiles([r["tokens"] / r["seconds"] for r in out]),
        "admit_s": quartiles([r["admit_s"] for r in out]),
        "dispatches": [r["dispatches"] for r in out],
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall}))
    print_breakdown(per)


def profile_vanilla(quantize: str, runs: int, seed: int,
                    w8a8: str = "on") -> None:
    cfg, params = vanilla_model(seed, quantize=quantize)
    ids = torch.as_tensor(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (BATCH, PROMPT_TOKENS)), dtype=torch.int32,
        device="cuda")

    def run():
        return vanilla_generate(params, cfg, ids, NEW_TOKENS)

    def prefill():
        cache = neox.make_kv_cache(cfg, BATCH, PROMPT_TOKENS + NEW_TOKENS,
                                   "int8", device="cuda")
        return vanilla.vanilla_prefill(params, cfg, ids, cache)

    run()
    total = timed(run, runs)
    pre = timed(prefill, runs)
    per, busy_us = device_breakdown(run)
    wall = statistics.median(total)
    generated = BATCH * NEW_TOKENS               # bench.py's count
    print(json.dumps({
        "model": VANILLA_MODEL, "quantize": quantize, "kv_cache": "int8",
        "w8a8": w8a8,
        "batch": BATCH, "prompt_tokens": PROMPT_TOKENS,
        "decode_steps": NEW_TOKENS, "generated_tokens": generated,
        "generate_s": quartiles(total),
        "tok_per_s": quartiles([generated / t for t in total]),
        "prefill_s": quartiles(pre),
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall}))
    print_breakdown(per)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize", choices=sorted(QUANTIZE), default="int8",
                    help="weights of the block model")
    ap.add_argument("--kv", choices=("int8", "int4", "bf16"),
                    default="int8", help="global KV cache of generation")
    ap.add_argument("--engine", choices=ENGINE_KINDS, default=None,
                    help="serve the engine traffic with this cache instead "
                         "of generate_blocks")
    ap.add_argument("--vanilla", action="store_true",
                    help=f"run the {VANILLA_MODEL} baseline instead")
    ap.add_argument("--vanilla_quantize", choices=("int8", "int4"),
                    default="int8", help="weights of the baseline")
    ap.add_argument("--w8a8", choices=("on", "off"), default="on",
                    help="W8A8 for INT8 linears at prefill-sized M")
    ap.add_argument("--fresh_prefill", type=int, choices=(0, 1), default=1,
                    help="0: the streaming (chunked) prefill")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate: no CUDA device")
    with (linear_ops.w8a8_disabled() if args.w8a8 == "off"
          else contextlib.nullcontext()):
        profile(args)


def profile(args) -> None:
    if args.vanilla:
        profile_vanilla(args.vanilla_quantize, args.runs, args.seed,
                        args.w8a8)
        return
    cfg, params = main_path_model(args.seed, quantize=args.quantize)
    if args.engine:
        profile_engine(args.engine, cfg, params, args.runs, args.seed,
                       args.w8a8)
        return
    ids, att, bam = ragged_prompts(cfg, seed=args.seed)
    N = ids.shape[1]
    max_blocks = N + NEW_TOKENS // cfg.block_length
    dev = [torch.as_tensor(a, device="cuda") for a in (ids, att, bam)]

    fresh = bool(args.fresh_prefill)

    def run():
        return gen.generate_blocks(params, cfg, *dev, max_blocks=max_blocks,
                                   kv_cache=args.kv, fresh_prefill=fresh,
                                   device="cuda")

    def prefill():
        with linear_ops.kv_mode(args.kv):
            return gen.prefill_blocks(params, cfg, *dev,
                                      capacity=-(-max_blocks // 128) * 128,
                                      kv_cache=args.kv, fresh_prefill=fresh)

    res = run()
    generated = BATCH * (res.n_blocks - N) * cfg.block_length
    total = timed(run, args.runs)
    pre = timed(prefill, args.runs)
    per, busy_us = device_breakdown(run)
    wall = statistics.median(total)
    print(json.dumps({
        "model": MODEL, "quantize": args.quantize, "kv_cache": args.kv,
        "w8a8": args.w8a8, "fresh_prefill": fresh, "batch": BATCH,
        "prompt_tokens": PROMPT_TOKENS,
        "new_tokens_per_row": NEW_TOKENS, "generated_tokens": generated,
        "generate_s": quartiles(total),
        "tok_per_s": quartiles([generated / t for t in total]),
        "prefill_s": quartiles(pre),
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall}))
    print_breakdown(per)


if __name__ == "__main__":
    main()
