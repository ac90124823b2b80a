"""Tracing/profiling utilities (port of
``block_transformer_tpu/utils/profiling.py``, the counterpart of the
reference's CUDA events + torch.profiler machinery, SURVEY.md §5.1).

- ``trace(dir)``: a ``torch.profiler`` trace of the CPU and, where there is
  one, the CUDA card, written to ``<dir>/trace.json`` (Chrome/Perfetto).
- ``timed(fn)``: wall time of calls whose CUDA results are waited for with
  ``torch.cuda.synchronize()`` (the JAX package's ``block_until_ready``).
- ``event_timed(run, device)``: the best of a few timings of ``run()``, by
  CUDA events behind a spin of the card (device time) and by the host
  clock between synchronizations (wall time); the speed probes of
  ``scripts/`` time their host-issued loops with it.
- ``card_label(device)``: the card's name and power limit as ``nvidia-smi``
  gives them, beside every figure taken on it.
- ``device_memory_stats``: ``torch.cuda.memory_stats()`` of the card.
- ``decompose_generation``: per-phase timing of the two-level decode
  (block-decoder vs token-decoder split, the reference's
  ``generate(benchmark=True)`` decomposition — block_transformer.py:345-353)
  measured by running the phases of ``inference/generate.py`` alone.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the ``torch.profiler.profile``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)
    return out


def block_until_ready(result):
    """Wait for every CUDA device holding a tensor of ``result`` (nested
    dicts, lists, tuples); returns ``result``."""
    for d in _devices(result, set()):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return result


def timed(fn: Callable, *args, n_rep: int = 1, **kwargs):
    """Returns (result, mean_seconds) after one untimed call. Waits on
    every output tensor's device."""
    result = block_until_ready(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(n_rep):
        result = block_until_ready(fn(*args, **kwargs))
    return result, (time.perf_counter() - t0) / n_rep


SM_HZ = 1.98e9           # the H100's top SM clock: torch.cuda._sleep's unit


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def event_timed(run: Callable, device, reps: int = 1
                ) -> Tuple[Optional[float], float]:
    """(device s, wall s) of ``run()``: each the best of ``reps`` timed calls
    after one untimed call. Wall: between synchronizations, by the host
    clock. Device (None off the card): CUDA events around a second call
    queued behind a spin of the card twice as long as the first took the
    host to issue, so that the host's launch cost is left out of it, unless
    ``run`` waits for the card before its end or issues more launches than
    the card's launch queue holds: the host then waits out the spin, and
    the events take in its issue gaps from there on."""
    cuda = torch.device(device).type == "cuda"
    run()
    best_dev = best_wall = float("inf")
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        run()
        issue = time.perf_counter() - t0
        _sync(device)
        best_wall = min(best_wall, time.perf_counter() - t0)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(2 * issue * SM_HZ) + 2_000_000)
            start.record()
            run()
            end.record()
            end.synchronize()
            best_dev = min(best_dev, start.elapsed_time(end) / 1e3)
    return (best_dev if cuda else None), best_wall


def card_label(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the card (its first line), or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def device_memory_stats() -> Dict[str, int]:
    """The CUDA caching allocator's counters for device 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_stats reads the CUDA card; none is "
                           "available")
    return dict(torch.cuda.memory_stats(0))


@torch.no_grad()
def decompose_generation(params, cfg, batch: int = 8, n_blocks: int = 32,
                         n_rep: int = 3) -> Dict[str, float]:
    """Time the decode phases separately on the parameters' device:
    block-decoder step, token-decoder block decode (prefix + inner loop),
    embedder re-embed. Returns seconds per phase per block (mirrors the
    reference's benchmark=True printout).

    As in the JAX package, the block-decoder step appends one block to an
    unquantized cache (the embedding table's dtype) of ``n_blocks`` blocks
    that starts empty on every call (all slots valid), so its attention
    reads the block's own slots only."""
    from block_transformer_tpu_torch.inference import generate as gen
    from block_transformer_tpu_torch.models import embedder as emb
    from block_transformer_tpu_torch.models import neox

    table = params["embedder"]["embeddings"]["weight"]
    dev, dtype = table.device, table.dtype
    n = cfg.n_embedding_tokens
    ph = cfg.embedder.projection_hidden_size
    cap = n_blocks * n

    cache = neox.KVCache.create(cfg.block_decoder, batch, cap, dtype=dtype,
                                device=dev)
    kv_valid = torch.ones((batch, cap), dtype=torch.int32, device=dev)
    embeds = torch.zeros((batch, n, ph), dtype=dtype, device=dev)
    new_valid = torch.ones((batch, n), dtype=torch.int32, device=dev)
    tokens = torch.ones((batch, cfg.block_length), dtype=torch.int32,
                        device=dev)

    def bd_step():
        return gen._block_decoder_step(params, cfg, embeds, cache, kv_valid,
                                       new_valid)[0]

    def td_block():
        return gen.decode_block_tokens(params, cfg, embeds)

    def embed():
        return emb.embed_blocks(params["embedder"], cfg.embedder,
                                cfg.block_length, tokens)

    _, t_bd = timed(bd_step, n_rep=n_rep)
    _, t_td = timed(td_block, n_rep=n_rep)
    _, t_emb = timed(embed, n_rep=n_rep)
    total = t_bd + t_td + t_emb
    return {
        "block_decoder_s": t_bd,
        "token_decoder_s": t_td,
        "embedder_s": t_emb,
        "total_per_block_s": total,
        "tokens_per_sec_est": batch * cfg.block_length / total,
    }
