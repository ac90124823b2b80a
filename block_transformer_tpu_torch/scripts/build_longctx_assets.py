"""Build long-context evaluation assets from local text (port of
``scripts/build_longctx_assets.py``; offline, host code only).

The reference downloads PG19 (pg19/pg19.py) and bundles Paul Graham essays
as the needle haystack (needle/PaulGrahamEssays/); neither may be fetched.
This script makes the same *shapes* of data from text already on the
machine:

- ``books.jsonl``: PG19-style book-length documents ({"text": ...}) made
  by concatenating local prose and documentation files until each reaches
  ``--min_chars``, for ``eval_longctx ppl --docs``;
- ``haystack.txt``: a contiguous prose haystack for the needle samples
  (``eval_longctx needle --haystack``); a default copy is committed at
  ``assets/needle_haystack.txt``.

The default ``--roots`` are this Python's stdlib and site-packages (the
JAX script adds a directory of its own machine's documents), so the output
depends on the machine it runs on; give ``--roots`` for a reproducible
build.

    python -m block_transformer_tpu_torch.scripts.build_longctx_assets \\
        --out results/longctx_assets
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import site
import sysconfig


def gather_text_files(roots, exts=(".rst", ".txt", ".md")):
    """The texts (over 2000 characters) of the files under ``roots`` with
    one of ``exts``, in sorted path order."""
    files = []
    for root in roots:
        for ext in exts:
            files.extend(glob.glob(os.path.join(root, "**", f"*{ext}"),
                                   recursive=True))
    out = []
    for p in sorted(set(files)):
        try:
            with open(p, encoding="utf-8", errors="ignore") as f:
                t = f.read()
        except OSError:
            continue
        if len(t) > 2000:
            out.append(t)
    return out


def main(argv=None) -> dict:
    """Returns {"books", "book_chars", "haystack_chars", "out"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/longctx_assets")
    ap.add_argument("--roots", nargs="*", default=None)
    ap.add_argument("--n_books", type=int, default=8)
    ap.add_argument("--min_chars", type=int, default=120_000)
    ap.add_argument("--haystack_chars", type=int, default=200_000)
    args = ap.parse_args(argv)

    roots = args.roots or [sysconfig.get_paths()["stdlib"],
                           *site.getsitepackages()]
    texts = gather_text_files(roots)
    if not texts:
        raise SystemExit("no local text found under roots")
    os.makedirs(args.out, exist_ok=True)

    # PG19-style "books": concatenate prose files to book length
    books, cur = [], []
    cur_len = 0
    for t in texts:
        cur.append(t)
        cur_len += len(t)
        if cur_len >= args.min_chars:
            books.append("\n\n".join(cur))
            cur, cur_len = [], 0
        if len(books) >= args.n_books:
            break
    with open(os.path.join(args.out, "books.jsonl"), "w") as f:
        for b in books:
            f.write(json.dumps({"text": b}) + "\n")

    hay = "\n\n".join(texts)[: args.haystack_chars]
    with open(os.path.join(args.out, "haystack.txt"), "w") as f:
        f.write(hay)
    book_chars = sum(len(b) for b in books)
    print(f"{len(books)} books ({book_chars/1e6:.1f}M chars) "
          f"+ {len(hay)/1e3:.0f}K-char haystack -> {args.out}")
    return {"books": len(books), "book_chars": book_chars,
            "haystack_chars": len(hay), "out": args.out}


if __name__ == "__main__":
    main()
