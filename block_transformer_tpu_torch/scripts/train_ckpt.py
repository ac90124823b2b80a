"""Train any named block config on the byte corpus with checkpoints (port of
``scripts/train_ckpt.py``).

Trains through the port's Trainer (``torch.save`` checkpoints every
``steps / n_checkpoints`` steps and at the end, resume from the latest,
``metrics.jsonl``), so the quality gates can be measured past the 5M model,
e.g. at ``block_main_b4_85``. ``--vanilla`` trains a vanilla config (the
GPT-NeoX baseline) instead. Parameters are float32; everything runs on the
card unless ``--cpu`` is given.

    python -m block_transformer_tpu_torch.scripts.train_ckpt \\
        --model block_main_b4_85 --steps 5000 --batch 32 --out results/scale85
"""

from __future__ import annotations

import argparse
import os
import re
import time


def main(argv=None) -> dict:
    """Train (resuming from ``<out>/<model>``); returns the run's summary:
    its directory, the checkpoint steps on disk, the block trainer's
    checkpoint log and the seconds the run took."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="block_main_b4_85")
    ap.add_argument("--corpus", default="results/corpus/pybytes")
    ap.add_argument("--out", default="results/scale85")
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max_length", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="85M default 3e-4 (the 5M byte runs used 6e-4; "
                    "larger models ride lower peaks)")
    ap.add_argument("--n_checkpoints", type=int, default=5)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--vanilla", action="store_true",
                    help="--model names a vanilla config (vanilla_31/70/"
                    "160/410): train the GPTNeoX baseline instead — e.g. "
                    "the 85M block checkpoint's pairing (vanilla_70) for "
                    "the long-context positionwise-ppl comparison")
    ap.add_argument("--micro_batch", type=int, default=None,
                    help="micro batch (grad accum); vanilla full-sequence "
                    "attention residuals need a small one (default 16 "
                    "with --vanilla)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import (get_config,
                                                    get_vanilla_config)
    from block_transformer_tpu_torch.scripts import quality_run as qr
    from block_transformer_tpu_torch.train.trainer import (Trainer,
                                                           TrainerConfig,
                                                           synchronize)

    device = "cpu" if args.cpu else "cuda"
    out = os.path.join(args.out, args.model)
    tkw = {}
    if args.vanilla:
        cfg = get_vanilla_config(args.model, vocab_size=args.vocab,
                                 max_position_embeddings=args.max_length)
        block_length = 1
        tkw["micro_batch_size"] = args.micro_batch or min(16, args.batch)
    else:
        cfg = get_config(args.model, vocab_size=args.vocab,
                         max_length=args.max_length)
        block_length = cfg.block_length
        if args.micro_batch:
            tkw["micro_batch_size"] = args.micro_batch
    tcfg = TrainerConfig(output_dir=out, learning_rate=args.lr,
                         num_train_steps=args.steps,
                         num_warmup_steps=max(100, args.steps // 20),
                         total_batch_size=args.batch,
                         max_length=args.max_length,
                         save_steps=max(1, args.steps // args.n_checkpoints),
                         logging_steps=25, param_dtype="float32", **tkw)
    ds = qr.make_dataset(qr.load_corpus(args.corpus), args.max_length,
                         block_length)
    print(f"[train_ckpt] {args.model} for {args.steps} steps "
          f"(b{args.batch} x {args.max_length}) -> {out} on {device}")
    t0 = time.perf_counter()
    if args.vanilla:
        from block_transformer_tpu_torch.train.vanilla_trainer import (
            VanillaTrainer)
        trainer = VanillaTrainer(cfg, tcfg, ds, device=device)
    else:
        trainer = Trainer(cfg, tcfg, ds, device=device)
    trainer.train(resume=True)
    synchronize(device)
    dt = time.perf_counter() - t0
    print(f"[train_ckpt] done in {dt:.0f}s")
    steps = sorted(int(m.group(1)) for n in os.listdir(out)
                   if (m := re.fullmatch(r"checkpoint-(\d+)", n)))
    return {"model": args.model, "out": out, "steps": args.steps,
            "checkpoint_steps": steps,
            # the block Trainer's saves and restores with their seconds
            "checkpoint_log": getattr(trainer, "checkpoint_log", None),
            "train_s": dt}


if __name__ == "__main__":
    main()
