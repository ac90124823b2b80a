"""ONE decode-path quality gate for every quantization (port of
``scripts/decode_gate.py``).

The gate, applied uniformly: decode greedily under the quantized
configuration, then teacher-force the fp32 model over the generated
continuation and compare its mean token logprob against the reference
(fp32 weights + bf16 KV) decode's continuations:

    GATE: |logprob_variant - logprob_ref| / |logprob_ref| <= 0.5%

Greedy agreement, rows identical and first divergence are reported as
diagnostics (trajectory stability); they do not gate.

Variants (same prompts, same checkpoint):
  fp32_bf16kv    fp32 weights + bf16 KV    (control: equals the reference
                 unless --variant_model_dir is given)
  int8kv         fp32 weights + INT8 KV
  int4kv         fp32 weights + INT4 KV
  int8w_int8kv   INT8 weights + INT8 KV
  int8w_int4kv   INT8 weights + INT4 KV
  mixed48_int4kv mixed48 weights + INT4 KV
  mixed48_int8kv mixed48 weights + INT8 KV
  int4w_int8kv   whole-model INT4 g128 + INT8 KV
  gptq_mixed48_int4kv  GPTQ mixed48 + INT4 KV    (--gptq)
  gptq_mixed48_int8kv  GPTQ mixed48 + INT8 KV    (--gptq)
  w8a8_int8w_int8kv    INT8 weights + INT8 KV, W8A8 at M >= 384 (--w8a8)
  w8a8_int8w_int4kv    INT8 weights + INT4 KV, W8A8 at M >= 384 (--w8a8)

W8A8 is off for the reference and every row (``ops.linear.w8a8_disabled``,
the JAX script's ``BT_W8A8_M_MIN=10**9``) but the two ``--w8a8`` rows,
which take ``w8a8_min_m(384)`` (its ``BT_W8A8_M_MIN=384``); at the default
batch of 384 decode M reaches that window. On the CPU no linear takes
W8A8, as the JAX rows were TPU-only. The JAX script decodes each variant in
a subprocess so that an environment variable can set W8A8; here every
variant runs in this process, under those contexts, on one device (the card
unless ``--cpu``), the scorer too. A failing variant raises.
``--only name1,name2 --merge`` appends rows to an existing report whose
reference logprob agrees within 1e-4.

    python -m block_transformer_tpu_torch.scripts.decode_gate \\
        --model_dir results/quality/block_main_b4_5 --w8a8 --gptq \\
        --out results/decode_gate.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from block_transformer_tpu_torch.scripts.quality_run import (
    add_ignored_optimizer_flags, load_params)

W8A8_DECODE_M = 384     # the --w8a8 rows' floor (JAX: BT_W8A8_M_MIN=384)


def sample_prompts(corpus_prefix: str, batch: int, prompt_len: int,
                   seed: int) -> np.ndarray:
    """[batch, prompt_len] int32 prompts from the holdout corpus: a random
    window of a random document long enough, drawn with numpy's
    ``default_rng(seed)`` as the JAX script draws them."""
    from block_transformer_tpu_torch.data.mmap_dataset import (
        MMapIndexedDataset)
    data, lengths, starts = MMapIndexedDataset(corpus_prefix).token_view()
    rng = np.random.default_rng(seed)
    prompts = []
    while len(prompts) < batch:
        i = int(rng.integers(len(lengths)))
        if lengths[i] < prompt_len + 1:
            continue
        st = int(rng.integers(0, lengths[i] - prompt_len))
        s = int(starts[i])
        prompts.append(np.asarray(data[s + st:s + st + prompt_len],
                                  np.int32))
    return np.stack(prompts)


def run_variant(params, cfg, prompts: np.ndarray, kv_cache: str,
                gen_tokens: int, w8a8_min_m=None) -> np.ndarray:
    """Greedy continuations [B, gen_tokens rounded to blocks] of ``prompts``
    under ``params`` and ``kv_cache``, on the parameters' device; W8A8 off,
    or at M >= ``w8a8_min_m``."""
    from block_transformer_tpu_torch.eval.adapters import params_device
    from block_transformer_tpu_torch.inference import generate as gen
    from block_transformer_tpu_torch.ops import linear as linear_ops
    d = gen.preprocess_inputs(cfg, prompts)
    B, N, L = d["input_ids"].shape
    max_blocks = N + gen_tokens // L
    w8a8 = (linear_ops.w8a8_disabled() if w8a8_min_m is None
            else linear_ops.w8a8_min_m(w8a8_min_m))
    with w8a8:
        res = gen.generate_blocks(params, cfg, d["input_ids"],
                                  d["attention_mask"],
                                  d["block_attention_mask"],
                                  max_blocks=max_blocks, greedy=True,
                                  kv_cache=kv_cache,
                                  device=params_device(params))
    return res.tokens.reshape(B, -1)[:, N * L:max_blocks * L].cpu().numpy()


def fp32_scorer(params, cfg, prompts: np.ndarray, gen_tokens: int):
    """``score(toks) -> float``: the mean token logprob the fp32 model
    ``params`` gives the first ``gen_tokens`` of each row's continuation
    ``toks``, teacher-forced after its prompt, on the parameters' device."""
    from block_transformer_tpu_torch.eval.adapters import params_device
    from block_transformer_tpu_torch.models import block_transformer as bt
    L = cfg.block_length
    pl_len = prompts.shape[1]
    device = params_device(params)

    @torch.no_grad()
    def score(toks: np.ndarray) -> float:
        full = torch.as_tensor(
            np.concatenate([prompts, toks[:, :gen_tokens]], 1),
            dtype=torch.int32, device=device)
        B = full.shape[0]
        N = full.shape[1] // L
        ids = full.reshape(B, N, L)
        out = bt.block_transformer_forward(
            params, cfg, ids, torch.ones_like(ids),
            torch.ones((B, N), dtype=torch.int32, device=device))
        logits = out.logits.reshape(B, (N - 1) * L, -1)
        lp = torch.log_softmax(logits.float(), -1)
        tok_lp = lp.gather(-1, full[:, L:, None].long())[..., 0]
        return float(tok_lp[:, pl_len - L:].mean())

    return score


def main(argv=None) -> dict:
    """Decode and score every variant; returns the report written to
    ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="block_main_b4_5",
                    help="named block config of the checkpoint")
    ap.add_argument("--model_dir", default="results/quality/block_main_b4_5")
    ap.add_argument("--variant_model_dir", default=None,
                    help="build the QUANTIZED variant trees from this "
                    "checkpoint while the reference decode + fp32 scorer "
                    "stay on --model_dir (the deployment question for a QAT "
                    "checkpoint)")
    ap.add_argument("--corpus", default="results/corpus/pybytes_holdout")
    ap.add_argument("--train_corpus", default="results/corpus/pybytes",
                    help="GPTQ calibration corpus (--gptq)")
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--prompt_len", type=int, default=256)
    ap.add_argument("--gen_tokens", type=int, default=64)
    ap.add_argument("--max_length", type=int, default=1024)
    add_ignored_optimizer_flags(ap, steps=10000)
    ap.add_argument("--w8a8", action="store_true",
                    help="include the two W8A8-decode rows (W8A8 runs on "
                    "the card only)")
    ap.add_argument("--gptq", action="store_true",
                    help="include the two GPTQ-mixed48 rows")
    ap.add_argument("--bar_pct", type=float, default=0.5)
    ap.add_argument("--prompt_seed", type=int, default=3,
                    help="holdout prompt-sampling seed: repeat the gate with "
                    "disjoint seeds to put error bars on borderline "
                    "verdicts (gate_seed_summary)")
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names to run (others "
                    "skipped); with --merge this appends rows to an "
                    "existing report")
    ap.add_argument("--merge", action="store_true",
                    help="load an existing --out report and update only "
                    "the variants run this invocation")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default="results/decode_gate.json")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.ops import quant
    from block_transformer_tpu_torch.scripts import quality_run as qr

    device = qr.device_of(args)
    qr.log_device("decode_gate", device)
    cfg = get_config(args.model, vocab_size=qr.VOCAB,
                     max_length=args.max_length)
    params, step = load_params(args.model_dir, device)
    print(f"[decode_gate] checkpoint step {step}")
    vparams = params
    if args.variant_model_dir:
        vparams, vstep = load_params(args.variant_model_dir, device)
        print(f"[decode_gate] variant checkpoint step {vstep} "
              f"({args.variant_model_dir})")

    prompts = sample_prompts(args.corpus, args.batch, args.prompt_len,
                             args.prompt_seed)

    q8 = quant.quantize_block_transformer(vparams, bits=8)
    qmix = quant.quantize_block_transformer(vparams, bits=8,
                                            token_decoder_bits=4,
                                            lm_head_bits=8, group_size=128)
    # name, tree, kv_cache, W8A8 floor (None: off)
    variants = [
        ("fp32_bf16kv", vparams, "bf16", None),
        ("int8kv", vparams, "int8", None),
        ("int4kv", vparams, "int4", None),
        ("int8w_int8kv", q8, "int8", None),
        ("int8w_int4kv", q8, "int4", None),
        ("mixed48_int4kv", qmix, "int4", None),
        ("mixed48_int8kv", qmix, "int8", None),
        ("int4w_int8kv",
         quant.quantize_block_transformer(vparams, bits=4, group_size=128),
         "int8", None),
    ]
    if args.gptq:
        from block_transformer_tpu_torch.ops import gptq
        calib = qr.calibration_batches(args.train_corpus, cfg,
                                       args.max_length, 64, 8)
        qg = gptq.gptq_quantize_block_transformer(
            vparams, cfg, calib, bits=8, token_decoder_bits=4, lm_head_bits=8,
            group_size=128, act_order=True, device=device)
        variants.append(("gptq_mixed48_int4kv", qg, "int4", None))
        variants.append(("gptq_mixed48_int8kv", qg, "int8", None))
    if args.w8a8:
        variants.append(("w8a8_int8w_int8kv", q8, "int8", W8A8_DECODE_M))
        # the max-throughput combination (W8A8 decode + INT4 KV)
        variants.append(("w8a8_int8w_int4kv", q8, "int4", W8A8_DECODE_M))
    if args.only:
        keep = {v.strip() for v in args.only.split(",")}
        unknown = keep - {n for n, *_ in variants}
        if unknown:
            ap.error(f"unknown variants: {sorted(unknown)}")
        variants = [v for v in variants if v[0] in keep]

    # reference decode: fp32 weights + bf16 KV
    toks_ref = run_variant(params, cfg, prompts, "bf16", args.gen_tokens)
    print("[decode_gate] reference decoded")
    fp32_lp = fp32_scorer(params, cfg, prompts, args.gen_tokens)
    lp_ref = fp32_lp(toks_ref)
    report = {"checkpoint_step": step, "batch": args.batch,
              "prompt_seed": args.prompt_seed,
              "prompt_len": args.prompt_len, "gen_tokens": args.gen_tokens,
              "gate": f"|fp32_logprob_delta| <= {args.bar_pct}% relative",
              "fp32_mean_logprob_ref": lp_ref, "variants": {}}
    if args.merge and os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        # same protocol check: the merged rows must share the reference
        if not abs(prev["fp32_mean_logprob_ref"] - lp_ref) < 1e-4:
            raise ValueError("existing report's reference decode differs - "
                             "refusing to merge")
        report["variants"].update(prev.get("variants", {}))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for name, tree, kv, floor in variants:
        toks = run_variant(tree, cfg, prompts, kv, args.gen_tokens, floor)
        lp = fp32_lp(toks)
        delta_pct = 100 * abs(lp - lp_ref) / abs(lp_ref)
        diff = toks != toks_ref
        first = np.where(diff.any(1), diff.argmax(1), toks.shape[1])
        report["variants"][name] = v = {
            "fp32_mean_logprob": lp,
            "fp32_logprob_delta_pct": delta_pct,
            "gate": "PASS" if delta_pct <= args.bar_pct else "FAIL",
            # diagnostics (trajectory stability, NOT the gate)
            "greedy_agreement": float((~diff).mean()),
            "rows_identical": float((~diff.any(1)).mean()),
            "first_divergence_token_mean": float(first.mean()),
        }
        print(f"[decode_gate] {name}: lp {lp:.4f} "
              f"({v['fp32_logprob_delta_pct']:+.3f}% vs ref) {v['gate']}  "
              f"[agreement {v['greedy_agreement']:.3f}]", flush=True)
        with open(args.out, "w") as f:     # incremental
            json.dump(report, f, indent=1)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[decode_gate] -> {args.out}")
    return report


if __name__ == "__main__":
    main()
