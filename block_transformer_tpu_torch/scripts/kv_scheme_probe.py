"""Which INT4 KV quantization scheme can pass the decode gate? (port of
``scripts/kv_scheme_probe.py``).

Symmetric per-(position, head) INT4 KV fails the decode gate (|delta| <=
0.5% of the fp32 logprob) where INT8 passes. Before wiring a better scheme
through every cache and dequantization site, this probe measures candidate
schemes cheaply by FAKE-QUANTIZING K/V at the ``layer_qkv`` output (a
quantize -> dequantize round trip into the bf16 cache path): numerically
the write-time quantization a quantized cache applies, without needing
zero-points or groups anywhere else.

The patch replaces the module-level ``models/neox.layer_qkv``, which every
stack looks up at each call (``neox._stack``, ``_prefill_fresh``): the
prefill's and every decode step's K/V of the block decoder and the token
decoder pass through it, as every call by name does in the JAX package.
Everything runs on the card unless ``--cpu`` is given.

Schemes probed (all per (position, head) unless noted):
  sym8       symmetric int8, one scale per D values   (sanity ~= int8kv row)
  sym4       symmetric int4                           (sanity ~= int4kv row)
  asym4      asymmetric int4 (scale + zero-point)
  sym4_g32   symmetric int4, scales over D-groups of 32
  asym4_g32  asymmetric int4, D-groups of 32
  k8v4       K sym8 + V sym4 (K is the attention-logit-critical half)
  k4v8       K sym4 + V sym8

    python -m block_transformer_tpu_torch.scripts.kv_scheme_probe \\
        --out results/kv_scheme_probe.json
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from block_transformer_tpu_torch.ops.quant import _div


def fake_quant(x, bits, asym, group):
    """Quantize -> dequantize round trip along the last axis in groups,
    bit for bit the JAX script's (float32 math, round half to even, IEEE
    divisions on every device), back in ``x``'s dtype."""
    orig_dtype = x.dtype
    xf = x.float()
    shp = xf.shape
    D = shp[-1]
    g = group or D
    xg = xf.reshape(shp[:-1] + (D // g, g))
    qmax = float(2 ** (bits - 1) - 1)
    if asym:
        lo = xg.amin(-1, keepdim=True)
        hi = xg.amax(-1, keepdim=True)
        scale = _div(torch.clamp(hi - lo, min=1e-8), float(2 ** bits - 1))
        q = torch.clamp(torch.round((xg - lo) / scale), 0, 2 ** bits - 1)
        out = q * scale + lo
    else:
        a = xg.abs().amax(-1, keepdim=True)
        scale = _div(torch.clamp(a, min=1e-8), qmax)
        q = torch.clamp(torch.round(xg / scale), -qmax, qmax)
        out = q * scale
    return out.reshape(shp).to(orig_dtype)


SCHEMES = {
    # name: (k_cfg, v_cfg) with cfg = (bits, asym, group) or None = bf16
    "bf16": (None, None),
    "sym8": ((8, False, None), (8, False, None)),
    "sym4": ((4, False, None), (4, False, None)),
    "asym4": ((4, True, None), (4, True, None)),
    "sym4_g32": ((4, False, 32), (4, False, 32)),
    "asym4_g32": ((4, True, 32), (4, True, 32)),
    "k8v4": ((8, False, None), (4, False, None)),
    "k4v8": ((4, False, None), (8, False, None)),
}


def main(argv=None) -> dict:
    """Decode under each scheme and score; returns the report written to
    ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_dir", default="results/quality/block_main_b4_5")
    ap.add_argument("--corpus", default="results/corpus/pybytes_holdout")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--prompt_len", type=int, default=256)
    ap.add_argument("--gen_tokens", type=int, default=48)
    ap.add_argument("--max_length", type=int, default=1024)
    ap.add_argument("--schemes", default=",".join(SCHEMES))
    ap.add_argument("--out", default="results/kv_scheme_probe.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    schemes = args.schemes.split(",")
    if schemes[0] != "bf16" or not set(schemes) <= set(SCHEMES):
        ap.error(f"--schemes: bf16 first (it is the reference), then any of "
                 f"{sorted(SCHEMES)}; got {args.schemes}")

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.models import neox
    from block_transformer_tpu_torch.scripts.decode_gate import (
        fp32_scorer, run_variant, sample_prompts)
    from block_transformer_tpu_torch.scripts.quality_run import load_params

    device = "cpu" if args.cpu else "cuda"
    cfg = get_config("block_main_b4_5", vocab_size=512,
                     max_length=args.max_length)
    params, step = load_params(args.model_dir, device)
    print(f"[kv_scheme_probe] checkpoint step {step}")

    prompts = sample_prompts(args.corpus, args.batch, args.prompt_len, 3)
    orig_layer_qkv = neox.layer_qkv

    def decode(scheme):
        k_cfg, v_cfg = SCHEMES[scheme]

        def patched(p, x, *, cfg, cos, sin, positions):
            q, k, v = orig_layer_qkv(p, x, cfg=cfg, cos=cos, sin=sin,
                                     positions=positions)
            if k_cfg is not None:
                k = fake_quant(k, *k_cfg)
            if v_cfg is not None:
                v = fake_quant(v, *v_cfg)
            return q, k, v

        neox.layer_qkv = patched
        try:
            # greedy, the bf16 global cache (float32 weights: no W8A8)
            return run_variant(params, cfg, prompts, "bf16", args.gen_tokens)
        finally:
            neox.layer_qkv = orig_layer_qkv

    # fp32 scorer (teacher-forced under the UNQUANTIZED model)
    fp32_lp = fp32_scorer(params, cfg, prompts, args.gen_tokens)

    report = {"checkpoint_step": step, "batch": args.batch,
              "prompt_len": args.prompt_len, "gen_tokens": args.gen_tokens,
              "note": "fake-quant probe; deltas are comparable to "
                      "each other and to the decode_gate ordering, not "
                      "bit-exact with the real int4 cache path",
              "schemes": {}}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    toks_ref = decode("bf16")
    lp_ref = report["fp32_mean_logprob_ref"] = fp32_lp(toks_ref)
    print(f"[kv_scheme_probe] bf16 ref lp {lp_ref:.4f}", flush=True)
    for scheme in schemes[1:]:
        toks = decode(scheme)
        lp = fp32_lp(toks)
        delta = 100 * abs(lp - lp_ref) / abs(lp_ref)
        agree = float((toks == toks_ref).mean())
        report["schemes"][scheme] = {
            "fp32_mean_logprob": lp,
            "fp32_logprob_delta_pct": delta,
            "gate_0.5pct": "PASS" if delta <= 0.5 else "FAIL",
            "greedy_agreement": agree,
        }
        print(f"[kv_scheme_probe] {scheme}: lp {lp:.4f} ({delta:+.3f}%) "
              f"{'PASS' if delta <= 0.5 else 'FAIL'} [agree {agree:.3f}]",
              flush=True)
        with open(args.out, "w") as f:     # incremental
            json.dump(report, f, indent=1)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[kv_scheme_probe] wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
