"""Throughput benchmark: the C++ threaded packer against the vectorized numpy
path (port of ``scripts/bench_packer.py``). Host code only: no device.

The port packs with the closed-form numpy mapping (``data/packing.py``
``PackedDataset``) and the C++ threaded fast path (``csrc/packer.cpp``
through ``data/native.py``). Both give the same batches
(``tests/test_torch_data.py``; checked here on the first batch as well);
this script measures packed tokens a second on a synthetic corpus shaped
like the Pile (lognormal document lengths, mean ~1.1k tokens).

    python -m block_transformer_tpu_torch.scripts.bench_packer \\
        [--n_docs 200000] [--max_length 2048]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> dict:
    """Returns {"n_docs", "tokens", "samples", "tok_per_s": {route: rate},
    "equal", "speedup" (with both routes)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_docs", type=int, default=200_000)
    ap.add_argument("--max_length", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n_batches", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.data import native
    from block_transformer_tpu_torch.data.packing import (PackedDataset,
                                                          TokenizedCorpus)

    rng = np.random.default_rng(0)
    lengths = np.clip(rng.lognormal(6.5, 1.0, args.n_docs), 8,
                      60_000).astype(np.int64)
    starts = np.zeros(args.n_docs + 1, np.int64)
    np.cumsum(lengths, out=starts[1:])
    total = int(starts[-1])
    data = rng.integers(1, 50254, size=total).astype(np.uint16)
    corpus = TokenizedCorpus(data, lengths, starts)
    ds = PackedDataset(corpus, args.max_length, eos_token=0, pad_token=0,
                       block_length=4)
    print(f"[packer] corpus: {args.n_docs} docs, {total/1e6:.1f}M tokens; "
          f"{len(ds)} samples of {args.max_length}")

    idx_batches = [np.arange(i * args.batch, (i + 1) * args.batch)
                   % len(ds) for i in range(args.n_batches)]
    n_tok = args.batch * args.max_length * args.n_batches

    results, first = {}, {}
    for name, use_native in [("numpy", False), ("cpp", True)]:
        if use_native and native.get_packer() is None:
            print("[packer] no C++ toolchain; skipping native")
            continue
        first[name] = ds.get_batch(idx_batches[0], use_native=use_native)
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for idxs in idx_batches:
                ds.get_batch(idxs, use_native=use_native)
            times.append(time.perf_counter() - t0)
        dt = min(times)
        results[name] = n_tok / dt
        print(f"[packer] {name:6s}: {n_tok/dt/1e6:8.1f}M tok/s "
              f"({dt*1e3:.0f} ms for {n_tok/1e6:.1f}M packed tokens, "
              f"best of {args.reps}; route {ds.last_route})")
    report = {"n_docs": args.n_docs, "tokens": total, "samples": len(ds),
              "tok_per_s": results}
    if len(results) == 2:
        report["equal"] = all(np.array_equal(first["cpp"][k],
                                             first["numpy"][k])
                              for k in first["numpy"])
        report["speedup"] = results["cpp"] / results["numpy"]
        print(f"[packer] speedup cpp/numpy: {report['speedup']:.2f}x; "
              f"batches equal: {report['equal']}")
    return report


if __name__ == "__main__":
    main()
