"""Offline corpus re-tokenization (port of ``scripts/retokenize_corpus.py``,
the analogue of the reference's T5 reshard tool
util/convert_pythia_tokens_to_t5_shards.py): decode a Megatron .bin/.idx
corpus with one tokenizer, re-encode with another, and write the ``.npy``
shards the T5-family training path loads (``data/retokenized_corpus.py``).
Host code only.

The defaults ``pythia`` and ``t5`` are Hugging Face tokenizers read from
the local files ``data/tokenizer.TOKENIZER_PATHS`` names, which the
repository does not hold; ``byte`` needs no file.

    python -m block_transformer_tpu_torch.scripts.retokenize_corpus \\
        --src results/corpus/pybytes --src_tokenizer byte \\
        --dst_tokenizer byte --out results/corpus/pybytes_t5
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Returns {"docs": documents read, "out": the shard directory}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help=".bin/.idx prefix")
    ap.add_argument("--src_tokenizer", default="pythia")
    ap.add_argument("--dst_tokenizer", default="t5")
    ap.add_argument("--out", required=True)
    ap.add_argument("--shard_docs", type=int, default=1024)
    ap.add_argument("--max_docs", type=int, default=None)
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.data.mmap_dataset import (
        MMapIndexedDataset)
    from block_transformer_tpu_torch.data.packing import TokenizedCorpus
    from block_transformer_tpu_torch.data.retokenized_corpus import (
        convert_corpus)
    from block_transformer_tpu_torch.data.tokenizer import load_tokenizer

    mm = MMapIndexedDataset(args.src)
    data, lengths, starts = mm.token_view()
    if args.max_docs:
        lengths = lengths[:args.max_docs]
        starts = starts[:args.max_docs]
    corpus = TokenizedCorpus(data, lengths, starts)
    src_tok = load_tokenizer(args.src_tokenizer)
    dst_tok = load_tokenizer(args.dst_tokenizer)
    out = convert_corpus(corpus, src_tok, dst_tok, args.out,
                         shard_docs=args.shard_docs)
    print(f"re-tokenized {len(lengths)} docs -> {out}")
    return {"docs": len(lengths), "out": out}


if __name__ == "__main__":
    main()
