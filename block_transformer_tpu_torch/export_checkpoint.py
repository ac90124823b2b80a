"""Export a trained checkpoint to the reference's per-component HF layout
(port of ``scripts/export_checkpoint.py``, the analogue of
pretrain_block_transformer.py:145-155's final save).

    python -m block_transformer_tpu_torch.export_checkpoint \\
        --model block_main_b4_5 --run_dir results/block_main_b4_5 \\
        --out exports/b4_5_hf [--cpu]

The parameters are restored onto the card unless ``--cpu`` is given; the
files are written from the host.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Parse ``argv`` (default: the command line), export, and return the
    output directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="block_main_b4_5")
    ap.add_argument("--run_dir", required=True,
                    help="trainer output dir containing checkpoint-<step>")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--vocab_size", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="restore on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.utils import checkpoint as ckpt
    from block_transformer_tpu_torch.utils import torch_export

    overrides = {"vocab_size": args.vocab_size} if args.vocab_size else {}
    cfg = get_config(args.model, **overrides)
    step = args.step or ckpt.find_latest_checkpoint(args.run_dir)
    if not step:
        ap.error(f"no checkpoints under {args.run_dir}")
    params = ckpt.restore_params(args.run_dir, step,
                                 device="cpu" if args.cpu else "cuda")
    out = torch_export.export_block_transformer(params, cfg, args.out)
    print(f"exported checkpoint-{step} -> {out} (embedder/ block_decoder/ "
          f"token_decoder/ HF layout)")
    return out


if __name__ == "__main__":
    main()
