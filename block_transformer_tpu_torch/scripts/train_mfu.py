"""Training step time and model FLOPs utilization at a given config (port of
``scripts/train_mfu.py``).

Runs N real optimizer steps (the Trainer's step:
``train/train_step.make_train_step``, remat on, AdamW) on synthetic or
mmap-corpus batches and reports the best and mean seconds a step and the
MFU. Training FLOPs use the standard 6 * N_params * T approximation (fwd
2NT + bwd 4NT) plus the attention term for both trunks, line for line the
JAX script's accounting. The MFU divides by the card's bf16 peak
(``utils/roofline.PEAK_BF16_FLOPS``, the H100's 989 TFLOP/s); the
parameters and the step run in float32, as in the JAX script, so the
figure is a share of a peak the step does not aim at. Each step is timed
between device synchronizations; the loss is read after.

    python -m block_transformer_tpu_torch.scripts.train_mfu \\
        --model block_main_b4_85 --batch 16 --max_length 1024 --steps 30
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    """Returns the report (printed, and written to ``--out`` if given)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="block_main_b4_85")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max_length", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--vocab", type=int, default=512,
                    help="byte-corpus vocab (matches the quality models); "
                    "pass 50304 for the reference tokenizer shape")
    ap.add_argument("--corpus", default="results/corpus/pybytes",
                    help="mmap corpus for real batches ('' = synthetic)")
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.data import packing
    from block_transformer_tpu_torch.models import block_transformer as bt
    from block_transformer_tpu_torch.train import optimizer as opt_mod
    from block_transformer_tpu_torch.train import train_step as ts
    from block_transformer_tpu_torch.train.trainer import synchronize
    from block_transformer_tpu_torch.utils import roofline

    device = "cpu" if args.cpu else "cuda"
    cfg = get_config(args.model, vocab_size=args.vocab,
                     max_length=args.max_length)
    print(f"[train_mfu] device: {device}"
          + (f" ({torch.cuda.get_device_name(0)})" if device == "cuda"
             else ""))

    tx, _ = opt_mod.make_optimizer(peak_lr=args.lr, warmup_steps=100,
                                   total_steps=max(args.steps, 1000),
                                   weight_decay=0.1, b1=0.9, b2=0.95)
    state = ts.create_train_state(0, cfg, tx, device=device)
    n_params = int(bt.count_params(state.params))
    step_fn = ts.make_train_step(cfg, tx, remat=True)

    # --- batches -----------------------------------------------------------
    L = cfg.block_length
    N = args.max_length // L
    if args.corpus and os.path.exists(args.corpus + ".bin"):
        from block_transformer_tpu_torch.scripts import quality_run as qr
        ds = qr.make_dataset(qr.load_corpus(args.corpus), args.max_length, L)

        def batch_at(i):
            idxs = (np.arange(args.batch) + i * args.batch) % len(ds)
            return packing.to_device(packing.make_train_batch(ds, idxs, L),
                                     device)
    else:
        rng = np.random.default_rng(0)

        def batch_at(i):
            ids = torch.as_tensor(rng.integers(
                1, args.vocab - 2, size=(args.batch, N, L)).astype(np.int32),
                device=device)
            return {"input_ids": ids,
                    "attention_mask": torch.ones_like(ids),
                    "block_attention_mask": torch.ones(
                        (args.batch, N), dtype=torch.int32, device=device),
                    "labels": ids}

    # --- timed steps -------------------------------------------------------
    t0 = time.time()
    for i in range(args.warmup):
        state, metrics = step_fn(state, batch_at(i))
    synchronize(device)
    print(f"[train_mfu] warmup {time.time()-t0:.0f}s")
    times, losses = [], []
    for i in range(args.steps):
        b = batch_at(args.warmup + i)
        synchronize(device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        synchronize(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))

    # --- FLOP accounting ---------------------------------------------------
    T = args.batch * args.max_length          # tokens per step
    bd, td = cfg.block_decoder, cfg.token_decoder.neox
    n_emb = cfg.n_embedding_tokens
    # attention: 4*h*s_ctx FLOPs/pos/layer fwd; bwd 2x. Block decoder runs
    # at block granularity (S/L positions, ctx S/L*n); token decoder at
    # token granularity with ctx <= n_exp + L.
    s_blk = N * n_emb
    attn_bd = 4 * bd.num_layers * bd.hidden_size * s_blk / 2    # avg causal
    attn_td = 4 * td.num_layers * td.hidden_size * (cfg.n_expanded_emb + L) / 2
    flops_fwd = (2 * n_params * T
                 + attn_bd * args.batch * s_blk
                 + attn_td * args.batch * (N - 1) * (cfg.n_expanded_emb + L))
    flops_step = 3 * flops_fwd                # fwd + 2x bwd
    best, mean = float(np.min(times)), float(np.mean(times))
    mfu_best = flops_step / best / roofline.PEAK_BF16_FLOPS
    report = {
        "model": args.model, "batch": args.batch,
        "max_length": args.max_length, "n_params": n_params,
        "steps": args.steps, "s_per_step_best": best,
        "s_per_step_mean": mean,
        "tokens_per_sec": T / mean,
        "flops_per_step": flops_step,
        "train_mfu_best": mfu_best,
        "train_mfu_mean": flops_step / mean / roofline.PEAK_BF16_FLOPS,
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_decreasing": losses[-1] < losses[0],
    }
    print(json.dumps(report, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
