"""Quantization-aware finetuning (port of ``scripts/qat_finetune.py``).

Finetune a checkpoint with the deployment quantization grid IN the loss
(straight-through fake quant, ``ops/quant.fake_quant_block_transformer``,
the grid of ``quantize_block_transformer``) so the weights migrate onto
representable points; plain RTN quantization of the adapted weights is
then the optimized model.

Recipes mirror the serving configs (``ops/quant.RECIPES``):
  mixed48   block INT8 + token INT4 g128 + head INT8
  int4g128  whole-model INT4 at g128
  int8      whole-model INT8 (control; should stay at ~0 delta)

``--distill`` trains the fake-quant student against the source
checkpoint's fp32 logits (KL) instead of the data cross-entropy; the
teacher is a frozen copy of the source parameters (its own tensors: the
train step updates the student's in place) run without gradients. It runs
on the card unless ``--cpu`` is given, and writes a port checkpoint
(``<out_dir>/<model>/checkpoint-<steps>``) and ``<out_dir>/QAT.json``.

    python -m block_transformer_tpu_torch.scripts.qat_finetune \\
        --model_dir results/quality/block_main_b4_5 --recipe mixed48 \\
        --distill --steps 1000 --out_dir results/qat_mixed48
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import numpy as np
import torch

from block_transformer_tpu_torch.ops.quant import RECIPES


def kd_loss_fn(cfg, transform, teacher):
    """loss_fn(params, batch) -> (loss, {"loss"}): the KL of the fake-quant
    student's logits from the frozen teacher's, averaged over the labelled
    positions (the JAX script's ``kd_loss``)."""
    from block_transformer_tpu_torch.models import block_transformer as bt

    def loss_fn(p, batch):
        ids, am, bam = (batch["input_ids"], batch["attention_mask"],
                        batch["block_attention_mask"])
        ls = bt.block_transformer_forward(transform(p), cfg, ids, am, bam,
                                          remat=True).logits
        with torch.no_grad():
            lt = bt.block_transformer_forward(teacher, cfg, ids, am,
                                              bam).logits
        kl = torch.sum(torch.softmax(lt, -1)
                       * (torch.log_softmax(lt, -1)
                          - torch.log_softmax(ls, -1)), -1)
        # logits cover blocks 1..N-1; labels carry -100 on padding
        w = (batch["labels"][:, 1:, :] != -100).float()
        loss = torch.sum(kl * w) / torch.clamp(torch.sum(w), min=1.0)
        return loss, {"loss": loss}

    return loss_fn


def make_step_fn(cfg, tx, recipe: str, teacher=None):
    """step_fn(state, batch) -> (state, metrics): one fake-quant train step
    of ``recipe``, on the data cross-entropy, or, with ``teacher`` (a
    frozen parameter tree), on the KL from its logits."""
    from block_transformer_tpu_torch.ops import quant
    from block_transformer_tpu_torch.train import train_step as ts
    transform = functools.partial(quant.fake_quant_block_transformer,
                                  **RECIPES[recipe])
    if teacher is None:
        return ts.make_train_step(cfg, tx, remat=True,
                                  param_transform=transform)
    grad_fn, apply_fn, zeros_fn = ts.make_grad_and_apply(
        kd_loss_fn(cfg, transform, teacher), tx)

    def step_fn(state, batch):
        acc, metrics = grad_fn(state.params, batch, zeros_fn(state.params))
        return apply_fn(state, acc, 1.0)[0], metrics

    return step_fn


def main(argv=None) -> dict:
    """Finetune and save; returns the ``QAT.json`` record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="block_main_b4_5")
    ap.add_argument("--model_dir", default="results/quality/block_main_b4_5")
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="mixed48")
    ap.add_argument("--corpus", default="results/corpus/pybytes")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max_length", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-4,
                    help="finetune peak lr (QAT only nudges weights onto "
                    "the grid)")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--distill", action="store_true",
                    help="train against the source checkpoint's fp32 logits "
                    "(KL) instead of the data CE")
    ap.add_argument("--out_dir", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    out_dir = args.out_dir or f"results/qat_{args.recipe}"

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.data.packing import (make_train_batch,
                                                          to_device)
    from block_transformer_tpu_torch.scripts import quality_run as qr
    from block_transformer_tpu_torch.train import optimizer as opt_mod
    from block_transformer_tpu_torch.train import train_step as ts
    from block_transformer_tpu_torch.utils import checkpoint as ckpt

    device = qr.device_of(args)
    qr.log_device("qat", device)
    cfg = get_config(args.model, vocab_size=args.vocab,
                     max_length=args.max_length)
    params, src_step = qr.load_params(args.model_dir, device)
    print(f"[qat] source checkpoint step {src_step} ({args.model_dir})")

    tx, _ = opt_mod.make_optimizer(peak_lr=args.lr,
                                   warmup_steps=max(20, args.steps // 20),
                                   total_steps=args.steps, weight_decay=0.1,
                                   b1=0.9, b2=0.95)
    teacher = None
    if args.distill:
        teacher = opt_mod.tree_map(lambda t: t.detach().clone(), params)
    state = ts.TrainState(params, tx.init(params), 0)
    step_fn = make_step_fn(cfg, tx, args.recipe, teacher)

    L = cfg.block_length
    ds = qr.make_dataset(qr.load_corpus(args.corpus), args.max_length, L,
                         seed=11)

    def batch_at(i):
        idxs = (np.arange(args.batch) + i * args.batch) % len(ds)
        return to_device(make_train_batch(ds, idxs, L), device)

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        state, metrics = step_fn(state, batch_at(i))
        if (i + 1) % 100 == 0 or i == 0:
            losses.append(float(metrics["loss"]))
            if i == 0:
                print(f"[qat] first step {time.time()-t0:.1f}s")
            print(f"[qat] step {i+1}: fake-quant loss {losses[-1]:.4f}",
                  flush=True)
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0

    model_dir = os.path.join(out_dir, args.model)
    path = ckpt.save_checkpoint(model_dir, args.steps, state)
    meta = {"recipe": args.recipe, "recipe_kwargs": RECIPES[args.recipe],
            "distill": bool(args.distill),
            "source": args.model_dir, "source_step": src_step,
            "steps": args.steps, "lr": args.lr, "batch": args.batch,
            "train_s": dt, "losses_per_100": losses}
    with open(os.path.join(out_dir, "QAT.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"[qat] saved {path} ({dt:.0f}s); deploy with "
          f"quantize_block_transformer(params, **{RECIPES[args.recipe]})")
    return meta


if __name__ == "__main__":
    main()
