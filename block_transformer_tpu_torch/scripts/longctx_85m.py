"""Long-context instruments at the reference's 8192-token regime on a
non-toy checkpoint (port of ``scripts/longctx_85m.py``).

  1. positionwise loss over ``--context`` (default 8192) token chunks, the
     reference's PG19 loss-by-position instrument (util/perplexity.py,
     context length 8192), for the trained block checkpoint and (with
     ``--vanilla_dir``) its trained vanilla pairing;
  2. the needle-in-a-haystack suite at the same context, with the
     reference's accuracy-by-depth output (needle/needle.py) over the depth
     grid.

The checkpoints are byte-level models trained at 1024 tokens, so 8192 is
an 8x position extrapolation; the loss-by-position curve shows how the
architecture degrades there. The parameters are restored alone
(``utils/checkpoint.restore_params``) and cast to bf16; the forward and the
needle's generation (the bf16 global cache) run on the card unless
``--cpu`` is given.

    python -m block_transformer_tpu_torch.scripts.longctx_85m \\
        --model block_main_b4_85 \\
        --model_dir results/scale85/block_main_b4_85 \\
        --vanilla vanilla_70 --vanilla_dir results/scale85/vanilla_70 \\
        --context 8192 --out results/longctx_85m.json
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def load_ckpt_params(model_dir, tmpl_fn, lr, steps, device="cuda"):
    """(parameters of the latest checkpoint in ``model_dir``, its step) on
    ``device``. ``tmpl_fn``, ``lr`` and ``steps`` are what the JAX script
    rebuilds the saved state's template from (the parameter tree and the
    optimizer that wrote it); the port restores the parameter tree alone,
    whatever optimizer made it, so they are accepted and unused."""
    from block_transformer_tpu_torch.utils import checkpoint as ckpt
    step = ckpt.find_latest_checkpoint(model_dir)
    if not step:
        raise FileNotFoundError(f"no checkpoint-<step> in {model_dir}")
    return ckpt.restore_params(model_dir, step, device=device), step


def _bf16(tree):
    from block_transformer_tpu_torch.train import optimizer as opt
    return opt.tree_map(lambda x: x.to(torch.bfloat16)
                        if x.is_floating_point() else x, tree)


def main(argv=None) -> dict:
    """Returns the report written to ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="block_main_b4_85")
    ap.add_argument("--model_dir", default="results/scale85/block_main_b4_85")
    ap.add_argument("--steps", type=int, default=5000,
                    help="the JAX script's restore template; unused here")
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="the JAX script's restore template; unused here")
    ap.add_argument("--vanilla", default=None,
                    help="vanilla pairing config name (e.g. vanilla_70)")
    ap.add_argument("--vanilla_dir", default=None)
    ap.add_argument("--vanilla_steps", type=int, default=2500,
                    help="the JAX script's restore template; unused here")
    ap.add_argument("--vanilla_lr", type=float, default=3e-4,
                    help="the JAX script's restore template; unused here")
    ap.add_argument("--context", type=int, default=8192)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--corpus", default="results/corpus/pybytes_holdout")
    ap.add_argument("--max_docs", type=int, default=16)
    ap.add_argument("--depths", default="0,10,20,30,40,50,60,70,80,90,100")
    ap.add_argument("--needle_templates", type=int, default=2)
    ap.add_argument("--haystack", default="assets/needle_haystack.txt")
    ap.add_argument("--skip_needle", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default="results/longctx_85m.json")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import (get_config,
                                                    get_vanilla_config)
    from block_transformer_tpu_torch.eval import longctx
    from block_transformer_tpu_torch.inference import generate as gen
    from block_transformer_tpu_torch.models import block_transformer as bt
    from block_transformer_tpu_torch.scripts import quality_run as qr

    device = "cpu" if args.cpu else "cuda"
    C = args.context
    cfg = get_config(args.model, vocab_size=qr.VOCAB, max_length=C)
    bp, bstep = load_ckpt_params(
        args.model_dir,
        lambda: bt.init_block_transformer_params(0, cfg, device=device),
        args.lr, args.steps, device=device)
    bp = _bf16(bp)
    print(f"[longctx] block checkpoint step {bstep}")

    hold = qr.load_corpus(args.corpus)
    docs = [np.asarray(hold.token_data[int(s):int(s) + int(l)])
            for s, l in zip(hold.document_indices, hold.document_lengths)
            if l >= C + 1][:args.max_docs]
    # byte docs shorter than 8k+1 are common; concatenate the tail to
    # synthesize book-length streams if the per-doc filter found too few
    # (the reference concatenates PG19 books the same way per window)
    if len(docs) < 4:
        all_tok = np.concatenate(
            [np.asarray(hold.token_data[int(s):int(s) + int(l)])
             for s, l in zip(hold.document_indices, hold.document_lengths)])
        n = len(all_tok) // (C + 1)
        docs = [all_tok[i * (C + 1):(i + 1) * (C + 1)]
                for i in range(min(n, args.max_docs))]
    print(f"[longctx] {len(docs)} docs of >= {C + 1} tokens")

    L = cfg.block_length
    res = {"context_length": C, "model": args.model,
           "checkpoint_step": int(bstep), "trained_length": 1024,
           "extrapolation_factor": C / 1024}

    t0 = time.time()

    @torch.no_grad()
    def block_logits(chunk):
        d = gen.preprocess_inputs(cfg, chunk)
        ids, att, bam = (torch.as_tensor(d[k], device=device) for k in (
            "input_ids", "attention_mask", "block_attention_mask"))
        return bt.block_transformer_forward(bp, cfg, ids, att, bam).logits

    blk_pos, n1 = longctx.loss_by_position_over_chunks(
        block_logits, docs, C, batch_size=args.batch_size, block_length=L)
    res["n_chunks"] = int(n1)
    res["block_pos_loss_every_256"] = [float(x) for x in blk_pos[::256]]
    res["block_loss_first_256_mean"] = float(np.mean(blk_pos[:256]))
    res["block_loss_last_256_mean"] = float(np.mean(blk_pos[-256:]))
    # in-trained-range vs extrapolated halves
    res["block_loss_first_1024_mean"] = float(np.mean(blk_pos[:1024]))
    res["block_loss_beyond_1024_mean"] = float(np.mean(blk_pos[1024:]))
    print(f"[longctx] block positionwise done in {time.time()-t0:.0f}s: "
          f"first256 {res['block_loss_first_256_mean']:.4f} "
          f"last256 {res['block_loss_last_256_mean']:.4f}")

    if args.vanilla and args.vanilla_dir:
        from block_transformer_tpu_torch.models import vanilla as vmod
        vcfg = get_vanilla_config(args.vanilla, vocab_size=qr.VOCAB,
                                  max_position_embeddings=C)
        vp, vstep = load_ckpt_params(
            args.vanilla_dir,
            lambda: vmod.init_vanilla_params(0, vcfg, device=device),
            args.vanilla_lr, args.vanilla_steps, device=device)
        vp = _bf16(vp)
        print(f"[longctx] vanilla checkpoint step {vstep}")

        @torch.no_grad()
        def van_logits(chunk):
            ids = torch.as_tensor(chunk, device=device)
            return vmod.vanilla_forward(vp, vcfg, ids, torch.ones_like(ids))

        t0 = time.time()
        van_pos, _ = longctx.loss_by_position_over_chunks(
            van_logits, docs, C, batch_size=1)
        res["vanilla"] = args.vanilla
        res["vanilla_checkpoint_step"] = int(vstep)
        res["vanilla_pos_loss_every_256"] = [float(x) for x in van_pos[::256]]
        res["vanilla_loss_first_256_mean"] = float(np.mean(van_pos[:256]))
        res["vanilla_loss_last_256_mean"] = float(np.mean(van_pos[-256:]))
        res["vanilla_loss_first_1024_mean"] = float(np.mean(van_pos[:1024]))
        res["vanilla_loss_beyond_1024_mean"] = float(np.mean(van_pos[1024:]))
        print(f"[longctx] vanilla positionwise done in {time.time()-t0:.0f}s")

    if not args.skip_needle:
        with open(args.haystack) as f:
            hay = f.read()
        # the byte tokenizer, whose decode is the JAX script's
        # tokens_to_text
        tok = qr.ByteTokenizer()
        depths = [float(d) for d in args.depths.split(",")]
        samples = longctx.generate_needle_suite(
            hay, tok, context_length=C, depths=depths,
            n_templates=args.needle_templates, seed=3)
        t0 = time.time()
        gens = []
        for s in samples:
            ids = np.asarray(tok.encode(s["prompt"]), np.int32)[None]
            outg = gen.generate(bp, cfg, ids, max_length=ids.shape[1] + 16,
                                device=device)
            gens.append(qr.tokens_to_text(np.asarray(outg[0, ids.shape[1]:])))
        res["needle_accuracy_by_depth"] = longctx.score_needle_results(
            samples, gens)
        res["needle_samples"] = len(samples)
        print(f"[longctx] needle done in {time.time()-t0:.0f}s: "
              f"{res['needle_accuracy_by_depth']}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"[longctx] -> {args.out}")
    return res


if __name__ == "__main__":
    main()
