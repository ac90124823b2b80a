"""Stage-level race: the token decoder's decode step under INT8 against
mixed48 weights (port of ``scripts/mixed48_stage_probe.py``).

``block_main_b4_1.2b`` at random weights (seed 0, bf16), quantized INT8
(``bits=8``) and mixed48 (block decoder and LM head INT8, token decoder
INT4 g128), at ``--batch`` 128, prompt 2048 and 128 new tokens, the block
decoder's cache ``--kv`` (INT4 by default). The token stage streams the
token decoder's weights a block step, so INT4 there should cut its time
toward half. The three stages are timed by ``_two_level_decomposition``,
the port's own copy of the JAX benchmark's (``bench.py``
``_two_level_decomposition``; the port does not import ``bench``).

Runs on the card unless ``--cpu``. The JAX script's TPU figures are not
carried over.

    python -m block_transformer_tpu_torch.scripts.mixed48_stage_probe \\
        [--batch 128] [--kv int4]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from block_transformer_tpu_torch.utils import profiling


ITERS = 32      # the JAX benchmark's iterations a stage (its default)


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
    synchronizations, as the JAX benchmark's (``prefill_ms``,
    ``token_decoder_ms_per_block_step``, ``block_decoder_ms_per_block_step``)
    and, on the card, by CUDA events around the same calls (the same keys
    with ``device_`` before them: the stages' span on the card, host gaps
    included). Every stage output passes ``profiling.block_until_ready``."""
    from block_transformer_tpu_torch.inference import generate as gen
    from block_transformer_tpu_torch.models import neox

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
        """(device s or None, wall s) of ``stage``, synced through
        ``profiling.block_until_ready``."""
        return profiling.event_timed(
            lambda: profiling.block_until_ready(stage()), device, reps,
            spin=False)

    out = {}
    with torch.no_grad():
        times = {"prefill": timed(prefill_stage, 3), "token": timed(
            token_stage), "fill": timed(cache_only), "block": timed(
            block_stage)}
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


def main(argv=None) -> dict:
    """Decompose under INT8 and mixed48 weights; returns {name: the
    decomposition}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--kv", default="int4")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions) instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.models import block_transformer as bt
    from block_transformer_tpu_torch.ops import quant
    from block_transformer_tpu_torch.scripts import quality_run as qr

    device = qr.device_of(args)
    qr.log_device("mixed48_stage_probe", device)
    cfg = get_config("block_main_b4_1.2b")
    dtype = torch.bfloat16
    base = bt.init_block_transformer_params(0, cfg, dtype=dtype,
                                            device=device)
    report = {}
    for name, kwargs in [
            ("int8", {"bits": 8}),
            ("mixed48", {"bits": 8, "token_decoder_bits": 4,
                         "lm_head_bits": 8, "group_size": 128})]:
        params = quant.quantize_block_transformer(base, **kwargs)
        d = _two_level_decomposition(params, cfg, args.batch, 2048, 128,
                                     dtype, args.kv)
        report[name] = d
        print(f"{name:8s} token {d['token_decoder_ms_per_block_step']:.2f} "
              f"ms/block-step   block "
              f"{d['block_decoder_ms_per_block_step']:.2f} ms/block-step"
              + ("" if "device_prefill_ms" not in d else
                 f"   (device: token "
                 f"{d['device_token_decoder_ms_per_block_step']:.2f}, block "
                 f"{d['device_block_decoder_ms_per_block_step']:.2f})"),
              flush=True)
        del params
    report["card"] = profiling.card_label(device)
    return report


if __name__ == "__main__":
    main()
