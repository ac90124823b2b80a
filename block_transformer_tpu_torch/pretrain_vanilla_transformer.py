"""Vanilla GPT-NeoX pretraining entry point (port of
``scripts/pretrain_vanilla_transformer.py``, the analogue of the
reference's pretrain_vanilla_transformer.py) for the baseline family
(vanilla_31 .. vanilla_410):

    python -m block_transformer_tpu_torch.pretrain_vanilla_transformer \\
        --model vanilla_31 --synthetic 5000 --steps 50 --max_length 128 \\
        --batch_size 8 [--cpu]

It trains on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse

from block_transformer_tpu_torch.pretrain_block_transformer import (
    synthetic_corpus)


def main(argv=None):
    """Parse ``argv`` (default: the command line), train, and return the
    ``VanillaTrainer``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vanilla_31")
    ap.add_argument("--config", default=None,
                    help="reference-schema vanilla_*.yaml (overrides --model)")
    ap.add_argument("--pile", default=None)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--max_length", type=int, default=2048)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_vanilla_config
    from block_transformer_tpu_torch.data.packing import (PackedDataset,
                                                          TokenizedCorpus)
    from block_transformer_tpu_torch.train.trainer import TrainerConfig
    from block_transformer_tpu_torch.train.vanilla_trainer import (
        VanillaTrainer)

    if args.config:
        from block_transformer_tpu_torch.config_yaml import (
            load_vanilla_config_yaml)
        cfg = load_vanilla_config_yaml(args.config)
    else:
        cfg = get_vanilla_config(args.model)
    if args.pile:
        from block_transformer_tpu_torch.data.mmap_dataset import (
            MMapIndexedDataset)
        corpus = TokenizedCorpus(*MMapIndexedDataset(args.pile).token_view())
    else:
        corpus = synthetic_corpus(args.synthetic, cfg.vocab_size, 400)
    # vanilla mode: EOS-joined packing, no block padding
    ds = PackedDataset(corpus, args.max_length, eos_token=0, block_length=None)

    tcfg = TrainerConfig(
        output_dir=args.output_dir or f"results/{args.model}",
        learning_rate=args.lr, num_train_steps=args.steps,
        stop_steps=args.steps, num_warmup_steps=max(1, args.steps // 10),
        total_batch_size=args.batch_size, max_length=args.max_length,
        save_steps=max(1, args.steps), logging_steps=10)
    trainer = VanillaTrainer(cfg, tcfg, ds,
                             device="cpu" if args.cpu else "cuda")
    state = trainer.train(resume=args.resume)
    print(f"finished at step {state.step}; checkpoints in {tcfg.output_dir}")
    return trainer


if __name__ == "__main__":
    main()
