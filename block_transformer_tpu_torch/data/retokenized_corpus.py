"""Re-tokenized corpus: convert a tokenized corpus to another tokenizer
(port of ``block_transformer_tpu/data/retokenized_corpus.py``).

Analogue of the reference's T5 data path — the offline reshard
tool ``util/convert_pythia_tokens_to_t5_shards.py`` plus
``custom_dataset/t5_pile_tokenized_corpus.py:14-75`` (decode the source
tokens, re-encode with the target tokenizer, store as ``.npy`` shards,
then load the shards into one contiguous token memmap + document index).
This is what lets the T5-embedder / T5-token-decoder ablation family train
end to end on a corpus that was tokenized for Pythia.

The conversion is tokenizer-agnostic (any pair exposing ``decode``/
``encode``); the byte tokenizer pair exercises the full path in
``tests/test_torch_data.py``.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np

from block_transformer_tpu_torch.data.packing import TokenizedCorpus


def convert_corpus(corpus: TokenizedCorpus, src_tokenizer, dst_tokenizer,
                   out_dir: str, shard_docs: int = 1024,
                   dtype=np.uint16) -> str:
    """Decode every document with ``src_tokenizer`` and re-encode with
    ``dst_tokenizer``; write ``shard_<i>.npy`` (concatenated tokens) +
    ``shard_<i>_lengths.npy`` per ``shard_docs`` documents and an
    ``index.json`` manifest. Returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    n_docs = len(corpus.document_lengths)
    shard_tokens: list = []
    shard_lengths: list = []
    shards = []

    def flush(i):
        if not shard_lengths:
            return
        tok = np.concatenate(shard_tokens).astype(dtype)
        np.save(os.path.join(out_dir, f"shard_{i}.npy"), tok)
        np.save(os.path.join(out_dir, f"shard_{i}_lengths.npy"),
                np.asarray(shard_lengths, np.int64))
        shards.append({"file": f"shard_{i}.npy", "docs": len(shard_lengths),
                       "tokens": int(tok.size)})
        shard_tokens.clear()
        shard_lengths.clear()

    shard_i = 0
    for d in range(n_docs):
        s = int(corpus.document_indices[d])
        l = int(corpus.document_lengths[d])
        text = src_tokenizer.decode(corpus.token_data[s:s + l])
        toks = np.asarray(dst_tokenizer.encode(text), np.int64)
        if toks.size == 0:
            continue
        shard_tokens.append(toks)
        shard_lengths.append(int(toks.size))
        if len(shard_lengths) >= shard_docs:
            flush(shard_i)
            shard_i += 1
    flush(shard_i)
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump({"shards": shards, "dtype": np.dtype(dtype).name}, f)
    return out_dir


def load_retokenized_corpus(out_dir: str) -> TokenizedCorpus:
    """Load shards back into one contiguous corpus (mmap per shard,
    concatenated — t5_pile_tokenized_corpus.py:30-75 semantics)."""
    with open(os.path.join(out_dir, "index.json")) as f:
        manifest = json.load(f)
    datas, lengths = [], []
    for sh in manifest["shards"]:
        datas.append(np.load(os.path.join(out_dir, sh["file"]), mmap_mode="r"))
        lengths.append(np.load(os.path.join(
            out_dir, sh["file"].replace(".npy", "_lengths.npy"))))
    data = np.concatenate(datas) if len(datas) > 1 else datas[0]
    doc_lengths = np.concatenate(lengths)
    starts = np.concatenate([[0], np.cumsum(doc_lengths)[:-1]])
    return TokenizedCorpus(data, doc_lengths.astype(np.int64),
                           starts.astype(np.int64))
