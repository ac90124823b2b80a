"""Deterministic random-access document packing and block-format training
batches (port of ``block_transformer_tpu/data/packing.py``).

The padded-corpus layout is the reference's ``TokenizedCorpusDataset``
(custom_dataset/tokenized_corpus.py:23-194): per document, a seeded random
left pad of 0..block_length-1 tokens
(``np.random.RandomState(seed).randint(block_length, size=n_docs)``), the
document, one EOS and a right pad to the next block boundary; sample ``i``
is the window ``[i*max_length, (i+1)*max_length)`` of that virtual stream.
Each padded position maps to its content in closed form, so a batch is a
few vectorized numpy ops, or one call of the native packer
(``data/native.py``, ``csrc/packer.cpp``), which computes the same thing.

Token rows ``[..., T]`` become blocks ``[..., N, L]`` with
``block_attention_mask [..., N]`` (a block is live when any of its tokens
is attended), and labels are the token ids with -100 where the attention
mask is 0. numpy in, numpy out, as in the JAX package; ``to_device`` makes
tensors of a batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class TokenizedCorpus:
    """(token_data, document_lengths, document_start_indices) over a flat
    token array (typically a memmap)."""
    token_data: np.ndarray
    document_lengths: np.ndarray     # int64 [n_docs]
    document_indices: np.ndarray     # int64 [n_docs] start offset of each doc

    def __len__(self):
        return len(self.document_lengths)


class PackedDataset:
    """Deterministic random-access packed LM samples.

    Vanilla mode (block_length=None): documents joined by single EOS, no
    padding. Block mode: per-document random left pad + EOS + right pad to
    the block boundary (see the module docstring). ``last_route`` says
    which packer served the last ``get_batch``: "native" or "numpy".
    """

    def __init__(self, corpus: TokenizedCorpus, max_length: int,
                 eos_token: int, pad_token: Optional[int] = None,
                 block_length: Optional[int] = None,
                 random_pad_first_block: bool = True,
                 pad_to_block_boundary: bool = True, seed: int = 42):
        self.corpus = corpus
        self.max_length = max_length
        self.eos_token = eos_token
        self.pad_token = pad_token
        self.block_length = block_length
        self.block_mode = block_length is not None
        self.last_route = None
        if self.block_mode:
            if max_length % block_length != 0:
                raise ValueError("max_length must be divisible by block_length")
            if (random_pad_first_block or pad_to_block_boundary) and pad_token is None:
                raise ValueError("pad_token required in block mode")

        n_docs = len(corpus)
        doc_len = corpus.document_lengths.astype(np.int64)
        if self.block_mode and random_pad_first_block:
            rng = np.random.RandomState(seed)
            self.left_pad = rng.randint(block_length, size=n_docs,
                                        dtype=np.int16).astype(np.int64)
        else:
            self.left_pad = np.zeros(n_docs, np.int64)
        padded = doc_len + self.left_pad + 1  # +1 for EOS
        if self.block_mode and pad_to_block_boundary:
            self.right_pad = (-padded) % block_length
        else:
            self.right_pad = np.zeros(n_docs, np.int64)
        self.padded_doc_lengths = padded + self.right_pad
        cumsum = np.concatenate([[0], np.cumsum(self.padded_doc_lengths)])
        self.padded_total_length = int(cumsum[-1])
        self.padded_doc_starts = cumsum[:-1]

    def __len__(self) -> int:
        return self.padded_total_length // self.max_length

    def positions_to_tokens(self, p: np.ndarray):
        """Padded-corpus positions -> (input_ids, attention_mask)."""
        d = np.searchsorted(self.padded_doc_starts, p, side="right") - 1
        o = p - self.padded_doc_starts[d] - self.left_pad[d]
        doc_len = self.corpus.document_lengths[d]
        in_doc = (o >= 0) & (o < doc_len)
        is_eos = o == doc_len
        gather = np.clip(self.corpus.document_indices[d] + np.clip(o, 0, None),
                         0, len(self.corpus.token_data) - 1)
        toks = np.asarray(self.corpus.token_data[gather], dtype=np.int64)
        pad = self.pad_token if self.pad_token is not None else self.eos_token
        ids = np.where(in_doc, toks, np.where(is_eos, self.eos_token, pad))
        att = (in_doc | is_eos).astype(np.int64)
        return ids, att

    def __getitem__(self, idx: int):
        start = (idx * self.max_length) % self.padded_total_length
        p = start + np.arange(self.max_length, dtype=np.int64)
        ids, att = self.positions_to_tokens(p)
        return {"index": idx, "input_ids": ids, "attention_mask": att}

    def get_batch(self, idxs: np.ndarray, use_native: bool = True):
        """Batch fetch: [B] -> dict of int64 [B, max_length].

        Takes the native packer when ``use_native`` and it builds and
        accepts the token dtype, else the numpy mapping (the same output);
        ``last_route`` records which."""
        idxs = np.asarray(idxs, np.int64)
        starts = (idxs * self.max_length) % self.padded_total_length
        if use_native:
            from block_transformer_tpu_torch.data import native
            out = native.pack_batch_native(self, starts)
            if out is not None:
                ids, att = out
                self.last_route = "native"
                return {"input_ids": ids.astype(np.int64),
                        "attention_mask": att.astype(np.int64)}
        p = starts[:, None] + np.arange(self.max_length, dtype=np.int64)[None]
        ids, att = self.positions_to_tokens(p.reshape(-1))
        self.last_route = "numpy"
        return {"input_ids": ids.reshape(len(idxs), -1),
                "attention_mask": att.reshape(len(idxs), -1)}


def split_blocks(input_ids: np.ndarray, attention_mask: np.ndarray,
                 block_length: int) -> dict:
    """[..., T] -> {"input_ids", "attention_mask": [..., N, L],
    "block_attention_mask": [..., N]} with N = T // block_length."""
    lead = input_ids.shape[:-1]
    N = input_ids.shape[-1] // block_length
    ids = input_ids.reshape(lead + (N, block_length))
    att = attention_mask.reshape(lead + (N, block_length))
    bam = (att != 0).any(axis=-1).astype(att.dtype)
    return {"input_ids": ids, "attention_mask": att,
            "block_attention_mask": bam}


def add_labels(input_ids: np.ndarray, attention_mask: np.ndarray) -> np.ndarray:
    """labels = input_ids, -100 where the token is not attended."""
    return np.where(attention_mask == 0, -100, input_ids)


def make_train_batch_from_rows(input_ids: np.ndarray,
                               attention_mask: np.ndarray,
                               block_length: int) -> dict:
    """Token rows [B, T] -> the train step's batch: ``split_blocks`` plus
    ``labels`` [B, N, L], every array int32."""
    labels = add_labels(input_ids, attention_mask)
    sb = split_blocks(input_ids, attention_mask, block_length)
    N, L = sb["input_ids"].shape[-2:]
    return {"input_ids": sb["input_ids"].astype(np.int32),
            "attention_mask": sb["attention_mask"].astype(np.int32),
            "block_attention_mask": sb["block_attention_mask"].astype(
                np.int32),
            "labels": labels.reshape(labels.shape[0], N, L).astype(np.int32)}


def make_train_batch(ds: PackedDataset, idxs, block_length: int,
                     distribution=None) -> dict:
    """Fetch + blockify + label one training batch.

    ``distribution``: an optional ``data.block_split``
    ``BlockLengthDistribution`` with no fixed ``length``, for variable
    block lengths (util/data_preprocessing.py:123-154): each sample is
    split at per-sample seeded boundaries and right-padded to the
    distribution max; ``n_blocks = ceil(max_length / mean)`` for every
    sample, so the batch shape does not change.
    """
    idxs = np.asarray(idxs)
    b = ds.get_batch(idxs)
    if distribution is None or getattr(distribution, "length", None) is not None:
        return make_train_batch_from_rows(b["input_ids"], b["attention_mask"],
                                          block_length)
    from block_transformer_tpu_torch.data.block_split import (
        split_blocks_variable)
    labels = add_labels(b["input_ids"], b["attention_mask"])
    outs = [split_blocks_variable(
        {"input_ids": b["input_ids"][i], "attention_mask":
         b["attention_mask"][i], "labels": labels[i], "index": int(idxs[i])},
        distribution, ds.pad_token) for i in range(len(idxs))]
    return {k: np.stack([o[k] for o in outs]).astype(np.int32)
            for k in ("input_ids", "attention_mask", "block_attention_mask",
                      "labels")}


def to_device(batch: dict, device="cuda") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
