"""Config -> training corpus dispatch (util/dataset.py:23-113 analogue; port
of ``block_transformer_tpu/data/dispatch.py``).

Routes the reference YAML's dataset stanza to a TokenizedCorpus:

- ``pythia_pile``: Megatron idxmap under ``pythia_pile_idxmaps_path``
  (custom_dataset/pythia_pile_tokenized_corpus.py — the deduped-Pile
  memmap every main config trains on),
- ``t5_pile``: re-tokenized shard dir (data/retokenized_corpus.py; the
  reference's T5PileTokenizedCorpus),
- any ``.bin``/``.idx`` prefix or shard dir given directly,
- raw-text HF datasets (wikitext/openwebtext-style): tokenized on the
  fly from the local datasets cache (HF_DATASETS route of
  util/dataset.py:10-15; requires a cached copy — no egress).
"""

from __future__ import annotations

import os

import numpy as np

from block_transformer_tpu_torch.data.packing import TokenizedCorpus

# reference idxmap file prefix under pythia_pile_idxmaps_path
_PILE_PREFIX = "pile_0.87_deduped_text_document"

HF_DATASETS = {
    "wikitext": ("wikitext", "wikitext-103-raw-v1", "text"),
    "wikitext2": ("wikitext", "wikitext-2-raw-v1", "text"),
    "openwebtext": ("openwebtext", None, "text"),
}


def _from_prefix(prefix: str) -> TokenizedCorpus:
    from block_transformer_tpu_torch.data.mmap_dataset import MMapIndexedDataset
    data, lengths, starts = MMapIndexedDataset(prefix).token_view()
    return TokenizedCorpus(data, lengths, starts)


def load_corpus(dataset: str, path: str = None, tokenizer=None,
                split: str = "train", max_docs: int = None
                ) -> TokenizedCorpus:
    """dataset: 'pythia_pile' | 't5_pile' | HF name | direct path prefix."""
    if dataset == "pythia_pile":
        if not path:
            raise ValueError("pythia_pile requires pythia_pile_idxmaps_path")
        prefix = path if os.path.exists(path + ".bin") else \
            os.path.join(path, _PILE_PREFIX)
        return _from_prefix(prefix)
    if dataset == "t5_pile":
        from block_transformer_tpu_torch.data.retokenized_corpus import (
            load_retokenized_corpus)
        if not path:
            raise ValueError("t5_pile requires the re-tokenized shard dir")
        return load_retokenized_corpus(path)
    if dataset in HF_DATASETS:
        name, config, field = HF_DATASETS[dataset]
        if tokenizer is None:
            raise ValueError(f"{dataset} needs a tokenizer")
        import datasets  # local cache only (no egress)
        dset = datasets.load_dataset(name, config, split=split)
        docs = []
        for i, row in enumerate(dset):
            if max_docs and i >= max_docs:
                break
            text = row[field]
            if not text or not text.strip():
                continue
            docs.append(np.asarray(tokenizer.encode(text), np.int64))
        lengths = np.array([len(d) for d in docs], np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        return TokenizedCorpus(np.concatenate(docs), lengths, starts)
    # direct path: .bin/.idx prefix or re-tokenized shard dir
    if dataset and os.path.exists(dataset + ".bin"):
        return _from_prefix(dataset)
    if dataset and os.path.isdir(dataset) and \
            os.path.exists(os.path.join(dataset, "index.json")):
        from block_transformer_tpu_torch.data.retokenized_corpus import (
            load_retokenized_corpus)
        return load_retokenized_corpus(dataset)
    raise ValueError(f"unknown dataset {dataset!r} (path={path!r})")


def load_corpus_from_yaml(y: dict, tokenizer=None) -> TokenizedCorpus:
    """Reference-YAML stanza (dataset + pythia_pile_idxmaps_path keys)."""
    return load_corpus(y.get("dataset", "pythia_pile"),
                       path=y.get("pythia_pile_idxmaps_path")
                       or y.get("t5_pile_shards_path"),
                       tokenizer=tokenizer)


def load_streaming_dataset(dataset: str, tokenizer, block_length,
                           max_length: int, split: str = "train",
                           **kwargs):
    """The deprecated raw-text STREAMING route (the reference's
    LanguageModelingDataset, custom_dataset/language_modeling_dataset.py):
    packs samples on the fly from an HF raw-text dataset instead of
    pre-tokenizing into a corpus. Prefer ``load_corpus`` +
    ``PackedDataset`` (deterministic random access, the reference's own
    recommendation since March 2024); this route exists for parity and
    for corpora too large to pre-tokenize locally."""
    from block_transformer_tpu_torch.data.streaming import StreamingTextDataset
    if dataset in HF_DATASETS:
        name, config, field = HF_DATASETS[dataset]
        import datasets  # local cache only (no egress)
        dset = datasets.load_dataset(name, config, split=split)
        return StreamingTextDataset(dset, tokenizer, block_length,
                                    max_length, text_field=field, **kwargs)
    raise ValueError(f"streaming route supports HF raw-text datasets "
                     f"({sorted(HF_DATASETS)}), got {dataset!r}")
