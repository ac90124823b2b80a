"""Long-context evaluation entry point (port of ``scripts/eval_longctx.py``):
PG19-style positionwise perplexity and needle-in-a-haystack (reference
§2.6: util/perplexity.py, needle/needle.py).

    python -m block_transformer_tpu_torch.eval_longctx ppl \\
        --model block_main_b4_5 --random --context 2048 --synthetic-docs 4
    python -m block_transformer_tpu_torch.eval_longctx needle \\
        --model block_main_b4_5 --random --context 1024 \\
        --haystack assets/needle_haystack.txt --tokenizer byte [--cpu]

It runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def load_params(args, cfg, device):
    import torch
    from block_transformer_tpu_torch.models import block_transformer as bt
    if args.random:
        return bt.init_block_transformer_params(0, cfg, dtype=torch.bfloat16,
                                                device=device)
    from block_transformer_tpu_torch.utils import torch_import
    return torch_import.load_checkpoint(args.ckpt, cfg, dtype=torch.bfloat16,
                                        device=device)


def main(argv=None):
    """Parse ``argv`` (default: the command line), evaluate, and return the
    result dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["ppl", "needle"])
    ap.add_argument("--model", default="block_main_b4_5")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--random", action="store_true")
    ap.add_argument("--context", type=int, default=2048)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--synthetic-docs", type=int, default=0,
                    help="use N synthetic token docs (smoke)")
    ap.add_argument("--docs", default=None, help="jsonl with {'text': ...}")
    ap.add_argument("--haystack", default=None, help="text file for needle")
    ap.add_argument("--depths", default="0,25,50,75,100")
    ap.add_argument("--tokenizer", default="pythia")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="evaluate on the CPU instead of the card")
    args = ap.parse_args(argv)

    import torch
    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.eval import longctx
    from block_transformer_tpu_torch.models import block_transformer as bt

    device = "cpu" if args.cpu else "cuda"
    cfg = get_config(args.model)
    params = load_params(args, cfg, device)
    L = cfg.block_length

    if args.mode == "ppl":
        if args.synthetic_docs:
            rng = np.random.default_rng(0)
            docs = [rng.integers(1, cfg.vocab_size - 50,
                                 size=args.context * 2 + 17)
                    for _ in range(args.synthetic_docs)]
        else:
            from block_transformer_tpu_torch.data.tokenizer import (
                load_tokenizer)
            tok = load_tokenizer(args.tokenizer)
            with open(args.docs) as f:
                docs = [np.asarray(tok.encode(json.loads(l)["text"]))
                        for l in f]

        @torch.no_grad()
        def block_fn(batch):
            ids = torch.from_numpy(batch).to(device)
            B, C = ids.shape
            ids = ids.reshape(B, C // L, L)
            att = torch.ones_like(ids)
            bam = torch.ones(ids.shape[:2], dtype=torch.int32, device=device)
            return bt.block_transformer_forward(params, cfg, ids, att,
                                                bam).logits

        loss, n = longctx.loss_by_position_over_chunks(
            block_fn, docs, args.context, batch_size=args.batch_size,
            block_length=L)
        result = {"context_length": args.context, "n_chunks": int(n),
                  "mean_loss": float(loss.mean()),
                  "loss_by_position": loss.tolist()}
        print(json.dumps({k: v for k, v in result.items()
                          if k != "loss_by_position"}))
    else:
        from block_transformer_tpu_torch.data.tokenizer import load_tokenizer
        from block_transformer_tpu_torch.inference import generate as gen
        tok = load_tokenizer(args.tokenizer)
        if args.haystack:
            with open(args.haystack) as f:
                hay = f.read()
        else:
            hay = "word " * 4000
        depths = [float(d) for d in args.depths.split(",")]
        samples = longctx.generate_needle_suite(hay, tok, args.context,
                                                depths=depths)
        gens = []
        for s in samples:
            ids = np.asarray(tok.encode(s["prompt"]))[None]
            out = gen.generate(params, cfg, ids,
                               max_length=ids.shape[1] + 16, device=device)
            gens.append(tok.decode(out[0, ids.shape[1]:].tolist()))
        result = {"scores_by_depth": longctx.score_needle_results(samples,
                                                                   gens)}
        print(json.dumps(result))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
