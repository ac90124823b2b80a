"""Long-context evals on the trained 5M quality model (port of
``scripts/longctx_quality_cpu.py``: the ``_cpu`` suffix is the JAX
script's, kept so that one file finds the other; this one runs on the card
unless ``--cpu`` is given).

  1. positionwise loss over 1024-token held-out chunks (block vs vanilla),
     the reference's pg19 loss-by-position instrument
     (``eval/longctx.loss_by_position_over_chunks``) on trained weights;
  2. the needle suite from the bundled haystack, scored with the byte
     tokenizer (a 5M byte model is far below needle capability: the run
     proves the pipeline on trained weights; accuracy is as measured).

The JAX script reads fixed paths; here they are arguments with the same
defaults under ``results/``. Writes ``<out>/longctx.json``.

    python -m block_transformer_tpu_torch.scripts.longctx_quality_cpu \\
        --out results/quality --corpus results/corpus/pybytes
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

HAYSTACK = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets", "needle_haystack.txt")


def main(argv=None) -> dict:
    """Returns the report written to ``<out>/longctx.json``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/quality",
                    help="quality_run --out (block_main_b4_5/ and "
                    "vanilla_31/ checkpoints)")
    ap.add_argument("--corpus", default="results/corpus/pybytes")
    ap.add_argument("--context_length", type=int, default=1024)
    ap.add_argument("--haystack", default=HAYSTACK)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import (get_config,
                                                    get_vanilla_config)
    from block_transformer_tpu_torch.eval import longctx
    from block_transformer_tpu_torch.inference import generate as gen
    from block_transformer_tpu_torch.models import block_transformer as bt
    from block_transformer_tpu_torch.models import vanilla as vmod
    from block_transformer_tpu_torch.scripts import quality_run as qr

    device = qr.device_of(args)
    qr.log_device("longctx", device)
    C = args.context_length
    cfg = get_config("block_main_b4_5", vocab_size=qr.VOCAB, max_length=C)
    vcfg = get_vanilla_config("vanilla_31", vocab_size=qr.VOCAB,
                              max_position_embeddings=C)
    bp, _ = qr.load_params(os.path.join(args.out, "block_main_b4_5"), device)
    vp, _ = qr.load_params(os.path.join(args.out, "vanilla_31"), device)

    hold = qr.load_corpus(args.corpus + "_holdout")
    docs = [np.asarray(hold.token_data[int(s):int(s) + int(l)])
            for s, l in zip(hold.document_indices, hold.document_lengths)
            if l >= C][:24]

    L = cfg.block_length

    @torch.no_grad()
    def block_logits(chunk):
        d = gen.preprocess_inputs(cfg, chunk)   # host-side numpy reshape
        return bt.block_transformer_forward(
            bp, cfg, *(torch.as_tensor(d[k], device=device) for k in (
                "input_ids", "attention_mask", "block_attention_mask"))
        ).logits

    @torch.no_grad()
    def van_logits(chunk):
        ids = torch.as_tensor(chunk, device=device)
        return vmod.vanilla_forward(vp, vcfg, ids, torch.ones_like(ids))

    blk_pos, n1 = longctx.loss_by_position_over_chunks(
        block_logits, docs, C, batch_size=4, block_length=L)
    van_pos, _ = longctx.loss_by_position_over_chunks(
        van_logits, docs, C, batch_size=4)

    # needle: generation through the real decode path at tiny scale
    with open(args.haystack) as f:
        hay = f.read()

    tok = qr.ByteTokenizer()
    samples = longctx.generate_needle_suite(hay, tok, context_length=C,
                                            depths=(0, 50, 100),
                                            n_templates=2, seed=3)
    gens = []
    for s in samples:
        ids = np.asarray(tok.encode(s["prompt"]), np.int32)[None]
        outg = gen.generate(bp, cfg, ids, max_length=ids.shape[1] + 12,
                            device=device)
        gens.append(qr.tokens_to_text(np.asarray(outg[0, ids.shape[1]:])))
    needle = longctx.score_needle_results(samples, gens)

    res = {
        "context_length": C,
        "n_chunks": int(n1),
        "block_loss_first_64_mean": float(np.mean(blk_pos[:64])),
        "block_loss_last_64_mean": float(np.mean(blk_pos[-64:])),
        "vanilla_loss_first_64_mean": float(np.mean(van_pos[:64])),
        "vanilla_loss_last_64_mean": float(np.mean(van_pos[-64:])),
        "block_pos_loss_every_64": [float(x) for x in blk_pos[::64]],
        "vanilla_pos_loss_every_64": [float(x) for x in van_pos[::64]],
        "needle": needle,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "longctx.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
