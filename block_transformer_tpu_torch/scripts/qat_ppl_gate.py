"""Held-out ppl gate for QAT-finetuned checkpoints (port of
``scripts/qat_ppl_gate.py``).

After QAT finetuning (``qat_finetune``) and real RTN quantization of the
adapted weights, where does held-out ppl land against the ORIGINAL
checkpoint's fp32 ppl? It also reports the QAT master weights' own fp32
ppl. The JAX script runs on the CPU; this one runs on the card unless
``--cpu`` is given.

    python -m block_transformer_tpu_torch.scripts.qat_ppl_gate \\
        --qat_dir results/qat_mixed48 \\
        --baseline_dir results/quality/block_main_b4_5 \\
        --out results/qat_ppl_mixed48.json
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    """Evaluate the four trees; returns the report written to ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--qat_dir", default="results/qat_mixed48",
                    help="qat_finetune --out_dir (contains QAT.json + "
                    "<model>/checkpoint-*)")
    ap.add_argument("--baseline_dir",
                    default="results/quality/block_main_b4_5")
    ap.add_argument("--corpus", default="results/corpus/pybytes")
    ap.add_argument("--model", default="block_main_b4_5")
    ap.add_argument("--max_length", type=int, default=1024)
    ap.add_argument("--eval_samples", type=int, default=256)
    ap.add_argument("--eval_batch", type=int, default=16)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.ops import quant
    from block_transformer_tpu_torch.scripts import quality_run as qr

    device = qr.device_of(args)
    qr.log_device("qat_ppl", device)
    with open(os.path.join(args.qat_dir, "QAT.json")) as f:
        meta = json.load(f)
    cfg = get_config(args.model, vocab_size=qr.VOCAB,
                     max_length=args.max_length)
    ds_hold = qr.make_dataset(qr.load_corpus(args.corpus + "_holdout"),
                              args.max_length, cfg.block_length, seed=7)

    def ppl(tree):
        return qr.heldout_ppl_block(tree, cfg, ds_hold, args.eval_samples,
                                    args.eval_batch)

    base_params, base_step = qr.load_params(args.baseline_dir, device)
    qat_params, qat_step = qr.load_params(
        os.path.join(args.qat_dir, args.model), device)

    fp_base = ppl(base_params)
    print(f"[qat_ppl] baseline fp32 (step {base_step}): {fp_base:.4f}")
    fp_qat = ppl(qat_params)
    print(f"[qat_ppl] QAT master fp32 (+{qat_step} steps): {fp_qat:.4f} "
          f"({100*(fp_qat-fp_base)/fp_base:+.3f}% vs baseline)")
    q_qat = ppl(quant.quantize_block_transformer(
        qat_params, **meta["recipe_kwargs"]))
    q_base = ppl(quant.quantize_block_transformer(
        base_params, **meta["recipe_kwargs"]))

    d_qat = 100 * (q_qat - fp_base) / fp_base
    d_base = 100 * (q_base - fp_base) / fp_base
    report = {
        "recipe": meta["recipe"], "qat_steps": qat_step,
        "baseline_fp32_ppl": fp_base,
        "qat_master_fp32_ppl": fp_qat,
        "qat_master_delta_pct": 100 * (fp_qat - fp_base) / fp_base,
        "quantized_baseline_ppl": q_base,
        "quantized_baseline_delta_pct": d_base,
        "quantized_qat_ppl": q_qat,
        "quantized_qat_delta_pct": d_qat,
        "gate": "PASS" if abs(d_qat) <= 0.5 else "FAIL",
    }
    print(f"[qat_ppl] RTN({meta['recipe']}) of baseline: {q_base:.4f} "
          f"({d_base:+.3f}%)")
    print(f"[qat_ppl] RTN({meta['recipe']}) of QAT:      {q_qat:.4f} "
          f"({d_qat:+.3f}%) -> {report['gate']}")
    out = args.out or os.path.join("results",
                                   f"qat_ppl_{meta['recipe']}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[qat_ppl] -> {out}")
    return report


if __name__ == "__main__":
    main()
