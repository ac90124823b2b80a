"""INT4 quality gate with GPTQ calibration (port of
``scripts/gptq_gate.py``).

Re-derives the INT4 ladder with GPTQ error-compensated rounding
(``ops/gptq.py``) calibrated on training-corpus samples, evaluates held-out
teacher-forced ppl for each configuration beside the round-to-nearest
(RTN) reference rows, and writes the gate table. The packed format is
RTN's, so a passing configuration serves through K4 / K1 unchanged.
Calibration, quantization and evaluation run on the card unless ``--cpu``
is given.

    python -m block_transformer_tpu_torch.scripts.gptq_gate \\
        --model_dir results/quality/block_main_b4_5 \\
        --corpus results/corpus/pybytes --out results/gptq_gate.json
"""

from __future__ import annotations

import argparse
import json
import os
import time

from block_transformer_tpu_torch.scripts.quality_run import (
    add_ignored_optimizer_flags)


def main(argv=None) -> dict:
    """Run the ladder; returns the report written to ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_dir", default="results/quality/block_main_b4_5")
    ap.add_argument("--corpus", default="results/corpus/pybytes")
    ap.add_argument("--out", default="results/gptq_gate.json")
    ap.add_argument("--max_length", type=int, default=1024)
    add_ignored_optimizer_flags(ap, steps=10000)
    ap.add_argument("--calib_samples", type=int, default=64)
    ap.add_argument("--calib_batch", type=int, default=8)
    ap.add_argument("--eval_samples", type=int, default=256)
    ap.add_argument("--eval_batch", type=int, default=16)
    ap.add_argument("--damp", type=float, default=0.01)
    ap.add_argument("--act_order", action="store_true",
                    help="process rows by descending Hessian diagonal "
                    "(static group scales; packed layout unchanged)")
    ap.add_argument("--skip_rtn", action="store_true",
                    help="skip the RTN reference rows")
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of GPTQ config names to run")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.ops import gptq, quant
    from block_transformer_tpu_torch.scripts import quality_run as qr

    device = qr.device_of(args)
    qr.log_device("gptq_gate", device)
    cfg = get_config("block_main_b4_5", vocab_size=qr.VOCAB,
                     max_length=args.max_length)
    params, step = qr.load_params(args.model_dir, device)
    print(f"[gptq_gate] loaded checkpoint step {step}")

    calib = qr.calibration_batches(args.corpus, cfg, args.max_length,
                                   args.calib_samples, args.calib_batch)
    print(f"[gptq_gate] {len(calib)} calibration batches "
          f"x {args.calib_batch} samples")

    holdout = qr.load_corpus(args.corpus + "_holdout")
    ds_hold = qr.make_dataset(holdout, args.max_length, cfg.block_length,
                              seed=7)

    def ppl(tree):
        return qr.heldout_ppl_block(tree, cfg, ds_hold, args.eval_samples,
                                    args.eval_batch)

    t0 = time.time()
    results = {"checkpoint_step": step, "model_dir": args.model_dir,
               "calib_samples": args.calib_samples, "damp": args.damp,
               "configs": {}}
    fp = ppl(params)
    results["fp32_ppl"] = fp
    print(f"[gptq_gate] fp32 ppl {fp:.4f} ({time.time()-t0:.0f}s)")

    def add(name, tree):
        p = ppl(tree)
        d = 100 * (p - fp) / fp
        results["configs"][name] = {
            "ppl": p, "delta_pct": d,
            "gate": "PASS" if abs(d) <= 0.5 else "FAIL"}
        print(f"[gptq_gate] {name}: ppl {p:.4f} ({d:+.3f}%) "
              f"{results['configs'][name]['gate']} ({time.time()-t0:.0f}s)")

    if not args.skip_rtn:
        # RTN reference points (re-measured on the same eval slice)
        add("rtn_int4_g128",
            quant.quantize_block_transformer(params, bits=4, group_size=128))
        add("rtn_int4_g32_head8",
            quant.quantize_block_transformer(params, bits=4, lm_head_bits=8,
                                             group_size=32))

    # the GPTQ ladder; g128 is K4's native group
    only = set(args.configs.split(",")) if args.configs else None

    def g(name, **kw):
        if only is not None and name not in only:
            return
        t1 = time.time()
        tree = gptq.gptq_quantize_block_transformer(
            params, cfg, calib, damp=args.damp, act_order=args.act_order,
            device=device, **kw)
        print(f"[gptq_gate] {name} quantized in {time.time()-t1:.0f}s")
        add(name, tree)

    g("gptq_int4_g128", bits=4, group_size=128)
    g("gptq_int4_g128_head8", bits=4, group_size=128, lm_head_bits=8)
    g("gptq_int4_g32_head8", bits=4, group_size=32, lm_head_bits=8)
    g("gptq_mixed48", bits=8, token_decoder_bits=4, lm_head_bits=8,
      group_size=128)
    g("gptq_int8", bits=8)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[gptq_gate] done -> {args.out}")
    return results


if __name__ == "__main__":
    main()
