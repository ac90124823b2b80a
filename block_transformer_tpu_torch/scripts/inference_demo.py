"""Batch-decoding speed demo (port of ``scripts/inference_demo.py``, the
analogue of the reference's inference_demo.py): load a checkpoint (or
random parameters), decode a batch, report the first sample's tokens, the
peak device memory and tokens/sec.

The model runs in bf16 with the bf16 global cache, on the card unless
``--cpu`` is given (the JAX script reads ``--cpu`` from ``sys.argv`` or
``BT_CPU`` at import; here ``--cpu`` is a flag like any other). A first run
warms up (the kernels are built there); the second is timed, between
device synchronizations, with the peak memory counter reset before it.

    python -m block_transformer_tpu_torch.scripts.inference_demo \\
        --model block_main_b4_5 --batch 32 --max_length 256 \\
        [--ckpt results/block_main_b4_5]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    """Returns the report: the printed figures, and the generated tokens
    ``[batch, n_blocks * block_length]`` (prompt included) as ``tokens``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="block_main_b4_5")
    ap.add_argument("--ckpt", default=None,
                    help="reference-format checkpoint dir (safetensors)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--prompt_len", type=int, default=8)
    ap.add_argument("--max_length", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.inference import generate as gen
    from block_transformer_tpu_torch.models import block_transformer as bt

    device = "cpu" if args.cpu else "cuda"
    cfg = get_config(args.model)
    if args.ckpt:
        from block_transformer_tpu_torch.utils import torch_import
        params = torch_import.load_checkpoint(args.ckpt, cfg,
                                              dtype=torch.bfloat16,
                                              device=device)
        print(f"loaded checkpoint from {args.ckpt}")
    else:
        params = bt.init_block_transformer_params(0, cfg, dtype=torch.bfloat16,
                                                  device=device)
        print("using randomly initialized weights")
    n_params = bt.count_params(params)
    print(f"parameters: {n_params/1e6:.1f}M")

    rng = np.random.default_rng(0)
    L = cfg.block_length
    prompt_len = max(L, (args.prompt_len // L) * L)
    prompts = rng.integers(1, cfg.vocab_size - 50,
                           size=(args.batch, prompt_len))
    N = prompt_len // L
    ids = torch.as_tensor(prompts.reshape(args.batch, N, L),
                          dtype=torch.int32, device=device)
    att = torch.ones_like(ids)
    bam = torch.ones((args.batch, N), dtype=torch.int32, device=device)
    max_blocks = args.max_length // L

    greedy = args.temperature <= 0.0

    def run(generator=None):
        return gen.generate_blocks(params, cfg, ids, att, bam,
                                   max_blocks=max_blocks, greedy=greedy,
                                   temperature=max(args.temperature, 1e-6),
                                   generator=generator, device=device)

    run()                                   # warm-up (and kernel builds)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run(torch.Generator(device=device).manual_seed(1))
    if on_card:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    n_blocks = int(res.n_blocks)
    toks = res.tokens[:, :n_blocks].reshape(args.batch, -1).cpu().numpy()
    new_tokens = (n_blocks * L - prompt_len) * args.batch
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"first sample tokens: {toks[0].tolist()[:64]} ...")
    print(f"max memory in use:   {peak/2**30:.2f} GiB")
    print(f"generation time:     {dt:.3f} s")
    print(f"tokens/sec/sample:   {new_tokens / args.batch / dt:.1f}")
    print(f"tokens/sec:          {new_tokens / dt:.1f}")
    return {"model": args.model, "batch": args.batch,
            "prompt_len": prompt_len, "n_params": n_params,
            "n_blocks": n_blocks, "new_tokens": new_tokens,
            "peak_bytes": peak, "generation_s": dt,
            "tokens_per_sec_per_sample": new_tokens / args.batch / dt,
            "tokens_per_sec": new_tokens / dt, "tokens": toks}


if __name__ == "__main__":
    main()
