"""W8A8-at-decode-M quality gate (port of ``scripts/w8a8_decode_gate.py``).

W8A8 at M >= 384 (``ops.linear.w8a8_min_m(384)``, the JAX script's
``BT_W8A8_M_MIN=384``) quantizes the activations per row on the decode and
engine-prefill paths, not only at prefill M. This gate decodes the same
prompts through the trained ``block_main_b4_5`` checkpoint (byte vocab,
INT8 weights + INT8 KV, the headline serving configuration) at batch 384,
so that decode M reaches the W8A8 window, once with W8A8 at M >= 384 and
once with it off (``w8a8_disabled()``, the JAX script's
``BT_W8A8_M_MIN=10**9``), and reports:

  - greedy token agreement (bar: >= the 97.7% INT4-KV precedent);
  - the fp32 model's teacher-forced mean log-likelihood of EACH variant's
    continuation (``decode_gate.fp32_scorer``).

It is ``decode_gate``'s ``--w8a8`` row against its INT8 row, reported in
this script's layout. The JAX script decodes each variant in a subprocess
(its ``WORKER``) so that an environment variable can set W8A8; here both
run in this process on one device (the card unless ``--cpu``). W8A8 runs on
the card only: on the CPU both variants decode the same tokens. ``--lr`` and
``--steps`` are taken and ignored (the checkpoint's parameters are restored
alone).

    python -m block_transformer_tpu_torch.scripts.w8a8_decode_gate \\
        --model_dir results/quality/block_main_b4_5
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from block_transformer_tpu_torch.scripts import decode_gate
from block_transformer_tpu_torch.scripts.quality_run import (
    add_ignored_optimizer_flags)

W8A8_OFF = 10 ** 9      # the JAX script's "off" floor: w8a8_disabled() here


def _model(spec):
    """(config, fp32 parameters) of ``spec``'s checkpoint on its device."""
    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.scripts import quality_run as qr
    cfg = get_config("block_main_b4_5", vocab_size=qr.VOCAB,
                     max_length=spec["max_length"])
    params, _ = qr.load_params(spec["model_dir"], spec["device"])
    return cfg, params


def run_variant(spec, m_min):
    """Greedy INT8-weight, INT8-KV continuations [B, gen_tokens] of
    ``spec["prompts"]``: W8A8 at M >= ``m_min``, or off at ``W8A8_OFF``
    (the JAX script's worker; here in this process)."""
    from block_transformer_tpu_torch.ops import quant
    cfg, params = _model(spec)
    q8 = quant.quantize_block_transformer(params, bits=8)
    return decode_gate.run_variant(
        q8, cfg, np.asarray(spec["prompts"], np.int32), "int8",
        spec["gen_tokens"], None if m_min >= W8A8_OFF else m_min)


def main(argv=None) -> dict:
    """Decode both variants and score them; returns the report written to
    ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_dir",
                    default="results/quality10k/block_main_b4_5")
    ap.add_argument("--corpus", default="results/corpus/pybytes_holdout")
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--prompt_len", type=int, default=256)
    ap.add_argument("--gen_tokens", type=int, default=64)
    ap.add_argument("--max_length", type=int, default=1024)
    add_ignored_optimizer_flags(ap, steps=10000)
    ap.add_argument("--out", default="results/w8a8_decode_gate.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.scripts import quality_run as qr
    device = qr.device_of(args)
    qr.log_device("w8a8_decode_gate", device)
    prompts = decode_gate.sample_prompts(args.corpus, args.batch,
                                         args.prompt_len, 3)
    spec = {"model_dir": args.model_dir, "max_length": args.max_length,
            "gen_tokens": args.gen_tokens, "prompts": prompts,
            "device": device}
    toks_off = run_variant(spec, W8A8_OFF)
    toks_on = run_variant(spec, decode_gate.W8A8_DECODE_M)

    agreement = float((toks_on == toks_off).mean())
    # first disagreement position per row (how early divergence starts)
    diff = toks_on != toks_off
    first = np.where(diff.any(1), diff.argmax(1), toks_on.shape[1])
    report = {
        "batch": args.batch, "gen_tokens": args.gen_tokens,
        "greedy_agreement": agreement,
        "rows_identical": float((~diff.any(1)).mean()),
        "first_divergence_token_mean": float(first.mean()),
        "pass_977": agreement >= 0.977,
    }

    # fp32-model scoring of both variants' continuations
    cfg, params = _model(spec)
    score = decode_gate.fp32_scorer(params, cfg, prompts, args.gen_tokens)
    for name, toks in (("w8a8_on", toks_on), ("w8a8_off", toks_off)):
        report[f"fp32_mean_logprob_{name}"] = score(toks)
    report["fp32_logprob_delta"] = (report["fp32_mean_logprob_w8a8_on"]
                                    - report["fp32_mean_logprob_w8a8_off"])

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
