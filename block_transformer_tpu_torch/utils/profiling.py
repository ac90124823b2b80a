"""Tracing/profiling utilities (port of
``block_transformer_tpu/utils/profiling.py``, the counterpart of the
reference's CUDA events + torch.profiler machinery, SURVEY.md §5.1).

- ``trace(dir)``: a ``torch.profiler`` trace of the CPU and, where there is
  one, the CUDA card, written to ``<dir>/trace.json`` (Chrome/Perfetto).
- ``timed(fn)``: wall time of calls whose CUDA results are waited for with
  ``torch.cuda.synchronize()`` (the JAX package's ``block_until_ready``).
- ``device_memory_stats``: ``torch.cuda.memory_stats()`` of the card.
- ``decompose_generation``: per-phase timing of the two-level decode
  (block-decoder vs token-decoder split, the reference's
  ``generate(benchmark=True)`` decomposition — block_transformer.py:345-353)
  measured by running the phases of ``inference/generate.py`` alone.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

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
