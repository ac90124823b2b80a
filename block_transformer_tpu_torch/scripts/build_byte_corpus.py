"""Build a byte-level tokenized corpus from local text files (port of
``scripts/build_byte_corpus.py``).

It walks local source trees (by default the running Python's stdlib and
site-packages: structured real text, no download), treats each file as one
document, and tokenizes at byte level with a +OFFSET shift so ids 0/1/2 stay
reserved (0 = eos/pad). Every ``--holdout_every``-th file goes to
``<out>_holdout``, the rest to ``<out>``, both in the indexed ``.bin/.idx``
format of ``data/mmap_dataset.write_mmap_dataset``, which the trainers and
the quality scripts read. It runs on the host only.

    python -m block_transformer_tpu_torch.scripts.build_byte_corpus \\
        --out results/corpus/pybytes --max_mb 200
"""

from __future__ import annotations

import argparse
import os
import pathlib
import site
import sysconfig

import numpy as np

from block_transformer_tpu_torch.data.mmap_dataset import write_mmap_dataset

OFFSET = 3          # byte b -> token b + 3; 0 = eos/pad, 1/2 reserved
VOCAB = 256 + OFFSET  # 259 distinct ids; configs round up (e.g. 512)


def encode_bytes(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8).astype(np.uint16) + OFFSET


def iter_files(roots, exts=(".py", ".md", ".txt", ".rst")):
    for root in roots:
        root = pathlib.Path(root)
        if not root.exists():
            continue
        for p in sorted(root.rglob("*")):
            if p.suffix in exts and p.is_file():
                yield p


def main(argv=None) -> dict:
    """Write the corpus; returns {"out", "train_docs", "train_tokens",
    "holdout_docs", "holdout_tokens"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="output path prefix")
    ap.add_argument("--roots", nargs="*", default=None,
                    help="directories to walk (default: python stdlib + "
                         "site-packages)")
    ap.add_argument("--max_mb", type=float, default=200.0)
    ap.add_argument("--min_bytes", type=int, default=256)
    ap.add_argument("--max_bytes", type=int, default=262144)
    ap.add_argument("--holdout_every", type=int, default=100,
                    help="every Nth file goes to <out>_holdout")
    args = ap.parse_args(argv)

    roots = args.roots or [sysconfig.get_paths()["stdlib"],
                           *site.getsitepackages()]
    budget = int(args.max_mb * 1e6)
    train_docs, holdout_docs = [], []
    total = 0
    for i, p in enumerate(iter_files(roots)):
        try:
            data = p.read_bytes()
        except OSError:
            continue
        if len(data) < args.min_bytes:
            continue
        doc = encode_bytes(data[: args.max_bytes])
        if i % args.holdout_every == args.holdout_every - 1:
            holdout_docs.append(doc)
        else:
            train_docs.append(doc)
            total += len(doc)
        if total >= budget:
            break

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_mmap_dataset(args.out, train_docs, dtype=np.uint16)
    write_mmap_dataset(args.out + "_holdout", holdout_docs, dtype=np.uint16)
    held = sum(len(d) for d in holdout_docs)
    print(f"train: {len(train_docs)} docs, {total/1e6:.1f}M tokens -> "
          f"{args.out}")
    print(f"holdout: {len(holdout_docs)} docs, {held/1e6:.1f}M tokens")
    return {"out": args.out, "train_docs": len(train_docs),
            "train_tokens": total, "holdout_docs": len(holdout_docs),
            "holdout_tokens": held}


if __name__ == "__main__":
    main()
