"""Zero-shot evaluation entry point (port of ``scripts/eval_zero_shot_task.py``,
the analogue of the reference's eval_zero_shot_task.py): load a checkpoint
(the reference's safetensors layout or the port's own
``checkpoint-<step>``), wrap it in the block (pad/nopad) adapter, run the
task suite, print a table + JSON.

    python -m block_transformer_tpu_torch.eval_zero_shot_task \\
        --model block_main_b4_5 --ckpt results/block_main_b4_5/final \\
        --tasks lambada_openai,hellaswag
    python -m block_transformer_tpu_torch.eval_zero_shot_task \\
        --model block_main_b4_5 --random --byte_corpus PREFIX [--cpu]

It evaluates on the card unless ``--cpu`` is given. The named HF tasks read
their datasets from the local ``datasets`` cache.
"""

from __future__ import annotations

import argparse
import json
import os
import re


def _load_params(cfg, path, device):
    """Load a checkpoint from either layout: reference safetensors trees or
    the port's train-state dirs (checkpoint-<step>)."""
    import torch
    base = os.path.basename(os.path.normpath(path))
    m = re.fullmatch(r"checkpoint-(\d+)", base)
    if m and not os.path.exists(os.path.join(path, "model.safetensors")):
        from block_transformer_tpu_torch.utils import checkpoint as ckpt
        return ckpt.restore_params(os.path.dirname(os.path.normpath(path)),
                                   int(m.group(1)), device=device)
    from block_transformer_tpu_torch.utils import torch_import
    return torch_import.load_checkpoint(path, cfg, dtype=torch.float32,
                                        device=device)


def _evaluate_params(args, cfg, params, tokenizer, tasks):
    from block_transformer_tpu_torch.eval import adapters, harness
    if args.quantize:
        from block_transformer_tpu_torch.ops import quant
        params = quant.quantize_block_transformer(
            params, bits=8 if args.quantize == "int8" else 4)
    lm = adapters.BlockTransformerLM(params, cfg, tokenizer,
                                     max_length=args.max_length,
                                     batch_size=args.batch_size,
                                     nopad=args.nopad)
    return harness.evaluate(lm, tasks, limit=args.limit, verbose=True)


def main(argv=None):
    """Parse ``argv`` (default: the command line), evaluate, and return the
    results dict (the last checkpoint's, with ``--sweep``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="block_main_b4_5")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--sweep", default=None, metavar="RUN_DIR",
                    help="evaluate every checkpoint-<step> under RUN_DIR "
                         "(reference eval_zero_shot_task.py:310-391)")
    ap.add_argument("--start_step", type=int, default=0)
    ap.add_argument("--step_interval", type=int, default=1,
                    help="keep steps where step %% interval == 0")
    ap.add_argument("--random", action="store_true",
                    help="random init (smoke runs)")
    ap.add_argument("--tasks", default="lambada_openai,wikitext,hellaswag,"
                    "arc_easy,sciq")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_length", type=int, default=2048)
    ap.add_argument("--nopad", action="store_true",
                    help="use the no-left-pad adapter (old checkpoints)")
    ap.add_argument("--quantize", choices=["int8", "int4"], default=None)
    ap.add_argument("--tokenizer", default="pythia")
    ap.add_argument("--byte_corpus", default=None, metavar="PREFIX",
                    help="use byte-level tasks built from this local "
                         "holdout corpus (implies --tokenizer byte)")
    ap.add_argument("--vocab_size", type=int, default=None,
                    help="override model vocab (e.g. byte-corpus runs)")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--cpu", action="store_true",
                    help="evaluate on the CPU instead of the card")
    args = ap.parse_args(argv)

    import torch
    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.data.tokenizer import load_tokenizer
    from block_transformer_tpu_torch.eval import harness, tasks as task_mod
    from block_transformer_tpu_torch.models import block_transformer as bt

    device = "cpu" if args.cpu else "cuda"
    overrides = {}
    if args.vocab_size:
        overrides["vocab_size"] = args.vocab_size
    cfg = get_config(args.model, **overrides)
    if args.byte_corpus:
        from block_transformer_tpu_torch.eval import byte_tasks as bta
        tokenizer = load_tokenizer("byte")
        tasks = bta.byte_tasks_from_prefix(args.byte_corpus)
    else:
        tokenizer = load_tokenizer(args.tokenizer)
        tasks = task_mod.get_tasks(args.tasks.split(","))

    if args.sweep:
        # multi-checkpoint regression sweep: glob, step-filter, per-step log
        steps = []
        for name in sorted(os.listdir(args.sweep)):
            m = re.fullmatch(r"checkpoint-(\d+)", name)
            if m:
                s = int(m.group(1))
                if s >= args.start_step and s % args.step_interval == 0:
                    steps.append(s)
        if not steps:
            ap.error(f"no matching checkpoint-<step> dirs under {args.sweep}")
        log_path = args.out or os.path.join(args.sweep, "eval_sweep.jsonl")
        from block_transformer_tpu_torch.utils import checkpoint as ckpt
        results = None
        for s in sorted(steps):
            params = ckpt.restore_params(args.sweep, s, device=device)
            results = _evaluate_params(args, cfg, params, tokenizer, tasks)
            rec = {"step": s, **{t: m for t, m in results["results"].items()}}
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"--- step {s} ---")
            print(harness.make_table(results))
        print(f"sweep written to {log_path}")
        return results

    if args.random:
        params = bt.init_block_transformer_params(0, cfg, dtype=torch.float32,
                                                  device=device)
    elif args.ckpt:
        params = _load_params(cfg, args.ckpt, device)
    else:
        ap.error("--ckpt, --sweep or --random required")

    results = _evaluate_params(args, cfg, params, tokenizer, tasks)
    print(harness.make_table(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
