"""KV-cache quality check on the trained 5M quality model (port of
``scripts/kv_quality_cpu.py``: the ``_cpu`` suffix is the JAX script's,
kept so that one file finds the other; this one runs on the card unless
``--cpu`` is given).

Runs only ``quality_run``'s decode-agreement phase: greedy token match of
INT8 / INT4 KV caches and of INT8 and mixed48 weights against the bf16-KV
fp32 decode. Writes ``<out>/kv_agreement_cpu.json`` (the JAX file name).

    python -m block_transformer_tpu_torch.scripts.kv_quality_cpu \\
        --out results/quality --corpus results/corpus/pybytes
"""

from __future__ import annotations

import argparse
import json
import os

from block_transformer_tpu_torch.scripts.quality_run import (
    add_ignored_optimizer_flags)


def main(argv=None) -> dict:
    """Returns the agreement dict written to the report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/quality")
    ap.add_argument("--corpus", default="results/corpus/pybytes")
    ap.add_argument("--max_length", type=int, default=1024)
    add_ignored_optimizer_flags(ap, steps=3000)
    ap.add_argument("--int4_group", type=int, default=128)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.ops import quant
    from block_transformer_tpu_torch.scripts import quality_run as qr

    device = qr.device_of(args)
    qr.log_device("kvq", device)
    cfg = get_config("block_main_b4_5", vocab_size=qr.VOCAB,
                     max_length=args.max_length)
    params, step = qr.load_params(os.path.join(args.out, "block_main_b4_5"),
                                  device)
    print(f"[kvq] loaded block@{step}")

    q8 = quant.quantize_block_transformer(params, bits=8)
    qmix = quant.quantize_block_transformer(params, bits=8,
                                            token_decoder_bits=4,
                                            lm_head_bits=8,
                                            group_size=args.int4_group)
    holdout = qr.load_corpus(args.corpus + "_holdout")
    d = qr.decode_agreement(params, q8, cfg, holdout, params_mixed=qmix)
    print(json.dumps(d, indent=1))
    with open(os.path.join(args.out, "kv_agreement_cpu.json"), "w") as f:
        json.dump(d, f, indent=1)
    return d


if __name__ == "__main__":
    main()
