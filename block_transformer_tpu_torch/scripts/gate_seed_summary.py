"""Aggregate multi-seed decode-gate reports into mean +/- sigma verdicts
(port of ``scripts/gate_seed_summary.py``; JSON in, JSON out, no device).

Each input is one ``decode_gate`` report run with a disjoint
``--prompt_seed``; rows are matched by variant name and summarized as
mean/std/min/max of ``fp32_logprob_delta_pct``, with a verdict:

  PASS        mean + sigma <= bar   (passes with margin)
  FAIL        mean - sigma >  bar   (fails with margin)
  BORDERLINE  bar inside mean +/- sigma: the measurement cannot
              distinguish pass from fail; defaults must not hinge on it

    python -m block_transformer_tpu_torch.scripts.gate_seed_summary \\
        results/decode_gate_s3.json results/decode_gate_s17.json \\
        results/decode_gate_s29.json --out results/decode_gate_seeds.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> dict:
    """Summarize the reports; returns the summary written to ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("reports", nargs="+")
    ap.add_argument("--bar_pct", type=float, default=0.5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    runs = []
    for p in args.reports:
        with open(p) as f:
            runs.append((p, json.load(f)))

    variants = {}
    seeds = []
    for path, rep in runs:
        seeds.append(rep.get("prompt_seed"))
        for name, row in rep.get("variants", {}).items():
            if "fp32_logprob_delta_pct" in row:
                variants.setdefault(name, []).append(
                    (path, row["fp32_logprob_delta_pct"]))

    bar = args.bar_pct
    out = {"bar_pct": bar, "seeds": seeds, "n_reports": len(runs),
           "variants": {}}
    print(f"{'variant':28s} {'n':>2s} {'mean%':>8s} {'std%':>7s} "
          f"{'min..max%':>16s}  verdict")
    for name in sorted(variants):
        vals = np.array([v for _, v in variants[name]], np.float64)
        mean = float(vals.mean())
        std = float(vals.std(ddof=1) if len(vals) > 1 else 0.0)
        if mean + std <= bar:
            verdict = "PASS"
        elif mean - std > bar:
            verdict = "FAIL"
        else:
            verdict = "BORDERLINE"
        if len(vals) == 1:
            # single run: no error bars; the verdict is the point
            # estimate's and must not flip defaults on its own
            verdict += "(n=1)"
        out["variants"][name] = {
            "n": len(vals), "mean_pct": mean, "std_pct": std,
            "min_pct": float(vals.min()), "max_pct": float(vals.max()),
            "values": [round(float(v), 4) for v in vals],
            "verdict": verdict,
        }
        print(f"{name:28s} {len(vals):2d} {mean:8.3f} {std:7.3f} "
              f"{vals.min():7.3f}..{vals.max():6.3f}  {verdict}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
