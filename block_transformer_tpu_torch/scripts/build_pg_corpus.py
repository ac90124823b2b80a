"""Build the pgbytes training corpus for the real-task fixtures (port of
``scripts/build_pg_corpus.py``; offline, host code only).

A byte-level corpus from the reference's Paul Graham essays (task data,
not code), with the holdout rule of ``build_real_task_fixtures``: the
essays are loaded by the same ``load_essays`` (sorted ``*.txt``,
whitespace collapsed, over 2000 characters) and every
``--holdout_every``-th essay by sorted index is left out of training: those
are the eval-only essays the lambada_pg / wikitext_pg fixtures mark
``seen: false``. The shared loader keeps the two holdout sets identical by
construction, and ``--meta`` checks it against the committed fixtures'
``META.json``. The essays are not in the repository: ``--essays`` names a
directory of ``*.txt`` files.

Output: a Megatron .bin/.idx pair at ``--out`` and ``--out``_holdout
(``data/mmap_dataset.write_mmap_dataset``), read by ``quality_run
--corpus``.

    python -m block_transformer_tpu_torch.scripts.build_pg_corpus \\
        --essays results/corpus/PaulGrahamEssays --out results/corpus/pgbytes
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from block_transformer_tpu_torch.scripts.build_real_task_fixtures import (
    load_essays)

OFFSET = 3  # byte b -> token b + 3; 0 = eos/pad (matches quality_run)


def main(argv=None) -> dict:
    """Returns {"train_essays", "train_tokens", "holdout_essays": names}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--essays", default="results/corpus/PaulGrahamEssays",
                    help="directory of the essays' *.txt files")
    ap.add_argument("--out", default="results/corpus/pgbytes")
    ap.add_argument("--holdout_every", type=int, default=10)
    ap.add_argument("--meta", default="assets/real_tasks/META.json",
                    help="cross-check the holdout set against the "
                         "committed fixture META (empty to skip)")
    args = ap.parse_args(argv)

    essays = load_essays(args.essays)
    holdout_idx = set(range(0, len(essays), args.holdout_every))
    holdout_names = sorted(essays[i][0] for i in holdout_idx)
    if args.meta and os.path.exists(args.meta):
        with open(args.meta) as f:
            meta = json.load(f)
        meta_holdout = meta.get("holdout_essays")
        if meta_holdout != holdout_names:
            raise SystemExit(
                f"holdout mismatch vs {args.meta}: corpus would train on "
                f"fixture eval essays.\n fixtures: {meta_holdout}"
                f"\n corpus:   {holdout_names}")

    train_docs, holdout_docs = [], []
    for i, (_name, text) in enumerate(essays):
        doc = np.frombuffer(text.encode("utf-8", "replace"),
                            np.uint8).astype(np.uint16)
        doc = np.minimum(doc, 255) + OFFSET
        (holdout_docs if i in holdout_idx else train_docs).append(doc)

    from block_transformer_tpu_torch.data.mmap_dataset import (
        write_mmap_dataset)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_mmap_dataset(args.out, train_docs, dtype=np.uint16)
    write_mmap_dataset(args.out + "_holdout", holdout_docs, dtype=np.uint16)
    n_tok = sum(len(d) for d in train_docs)
    print(f"train: {len(train_docs)} essays, {n_tok/1e6:.2f}M tokens "
          f"-> {args.out}")
    print(f"holdout (eval-only): {holdout_names}")
    return {"train_essays": len(train_docs), "train_tokens": n_tok,
            "holdout_essays": holdout_names}


if __name__ == "__main__":
    main()
