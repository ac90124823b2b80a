"""Byte-level harness tasks built from a local held-out corpus.

Where the reference's tracked task datasets
(lambada/hellaswag/wikitext/...) cannot be fetched, these tasks are their
structural analogues over real local text (scripts/build_byte_corpus.py):

- ``pybytes_nextchunk`` — 4-way next-chunk multiple choice
  (hellaswag-shaped: acc / acc_norm),
- ``pybytes_wikitext`` — rolling byte/word perplexity (wikitext-shaped).

They exercise the full adapter -> harness -> metrics pipeline with
learnable statistics, which is what the quality gate (QUALITY.md) and the
multi-checkpoint sweep need.

A copy of ``block_transformer_tpu/eval/byte_tasks.py``: the port keeps its
own, as it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from block_transformer_tpu_torch.eval import harness

OFFSET = 3


def tokens_to_text(toks) -> str:
    return "".join(chr(max(0, int(t) - OFFSET)) for t in toks if t >= OFFSET)


def corpus_texts(corpus, min_chars: int) -> list:
    texts = []
    for i in range(len(corpus.document_lengths)):
        s = int(corpus.document_indices[i])
        l = int(corpus.document_lengths[i])
        if l >= min_chars:
            texts.append(tokens_to_text(corpus.token_data[s:s + l]))
    return texts


def byte_tasks(holdout, n_mc: int = 200, n_ppl: int = 24,
               ctx_chars: int = 384, cont_chars: int = 48, seed: int = 0):
    """holdout: a data.packing.TokenizedCorpus of byte tokens."""
    rng = np.random.default_rng(seed)
    texts = corpus_texts(holdout, ctx_chars + cont_chars + 1)
    mc_docs = []
    for _ in range(n_mc):
        i = int(rng.integers(len(texts)))
        t = texts[i]
        start = int(rng.integers(0, max(1, len(t) - ctx_chars - cont_chars)))
        ctx = t[start:start + ctx_chars]
        gold = t[start + ctx_chars:start + ctx_chars + cont_chars]
        distract = []
        while len(distract) < 3:
            u = texts[int(rng.integers(len(texts)))]
            st = int(rng.integers(0, max(1, len(u) - cont_chars)))
            d = u[st:st + cont_chars]
            if d != gold:
                distract.append(d)
        order = rng.permutation(4)
        choices = [([gold] + distract)[k] for k in order]
        mc_docs.append({"ctx": ctx, "choices": choices,
                        "gold": int(np.argwhere(order == 0)[0][0])})

    class NextChunkMC(harness.MultipleChoiceTask):
        name = "pybytes_nextchunk"

        def docs(self):
            return mc_docs

        def doc_to_text(self, doc):
            return doc["ctx"]

        def doc_to_choices(self, doc):
            return doc["choices"]

        def gold_index(self, doc):
            return doc["gold"]

    ppl_docs = [t[:4096] for t in texts[:n_ppl]]

    class BytePPL(harness.PerplexityTask):
        name = "pybytes_wikitext"

        def docs(self):
            return ppl_docs

        def doc_to_target(self, doc):
            return doc

    return [NextChunkMC(), BytePPL()]


def byte_tasks_from_prefix(prefix: str, **kw):
    """Build byte tasks from an mmap corpus path prefix (the _holdout shard
    written by scripts/build_byte_corpus.py)."""
    from block_transformer_tpu_torch.data.mmap_dataset import MMapIndexedDataset
    from block_transformer_tpu_torch.data.packing import TokenizedCorpus
    mm = MMapIndexedDataset(prefix)
    data, lengths, starts = mm.token_view()
    return byte_tasks(TokenizedCorpus(data, lengths, starts), **kw)
