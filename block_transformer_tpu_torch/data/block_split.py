"""Block splitting with fixed or variable block-length distributions (port
of ``block_transformer_tpu/data/block_split.py``, the same numpy calls, so
the lengths are equal bit for bit).

Numpy re-implementation of util/data_preprocessing.py:48-197: a
``BlockLengthDistribution`` samples per-sample block lengths (seeded by
``seed + sample_index`` for reproducibility, with the same add/remove-1
adjustment loop to exactly fill ``total_length``); samples are split at
those boundaries and each block is right-padded to the distribution max.
``fixed`` is the fast path every main config uses (data/packing.split_blocks
is its reshape-only equivalent).

Note: variable-length sampling uses numpy's Generator rather than
torch.multinomial, so sampled lengths differ from the reference run-to-run
only in RNG stream, not in distribution or adjustment semantics.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np


class BlockLengthDistribution:
    def __init__(self, pmf: np.ndarray, seed: int = 42):
        pmf = np.asarray(pmf, np.float64)
        if pmf[0] != 0:
            raise ValueError("pmf[0] must be 0 (block length 0 not allowed)")
        self.pmf = pmf / pmf.sum()
        self.seed = seed
        self.mean = float(np.dot(self.pmf, np.arange(len(pmf))))
        self.domain = {i for i, p in enumerate(self.pmf) if p != 0}
        self.max = max(self.domain)

    def get_lengths(self, total_length: int,
                    sample_index: Optional[int] = None) -> np.ndarray:
        seed = (self.seed + (sample_index or 0)) % (2 ** 32 - 1)
        rng = np.random.default_rng(seed)
        n_blocks = math.ceil(total_length / self.mean)
        lengths = rng.choice(len(self.pmf), size=n_blocks, p=self.pmf)
        current = lengths.sum()
        tries = 0
        while current != total_length:
            i = rng.integers(0, n_blocks)
            if current < total_length and int(lengths[i]) + 1 in self.domain:
                lengths[i] += 1
                current += 1
            elif current > total_length and int(lengths[i]) - 1 in self.domain:
                lengths[i] -= 1
                current -= 1
            tries += 1
            if tries > 500:
                raise ValueError("block-length adjustment did not converge")
        return lengths.astype(np.int64)


class FixedDistribution(BlockLengthDistribution):
    def __init__(self, length: int = 4, seed: int = 42):
        pmf = np.zeros(length + 1)
        pmf[length] = 1
        super().__init__(pmf, seed)
        self.length = length

    def get_lengths(self, total_length, sample_index=None):
        if total_length % self.length:
            raise ValueError(f"total_length {total_length} not divisible by "
                             f"{self.length}")
        return np.full(total_length // self.length, self.length, np.int64)


class UniformDistribution(BlockLengthDistribution):
    def __init__(self, mean: int = 4, radius: Optional[int] = None,
                 seed: int = 42):
        if radius is None:
            radius = mean - 1
        if mean - radius < 1:
            raise ValueError("radius too large for mean")
        pmf = np.zeros(mean + radius + 1)
        pmf[mean - radius:mean + radius + 1] = 1.0
        super().__init__(pmf, seed)


DISTRIBUTIONS = {"fixed": FixedDistribution, "uniform": UniformDistribution}


def split_blocks_variable(sample: Dict[str, np.ndarray],
                          distribution: BlockLengthDistribution,
                          pad_token_id: int) -> Dict[str, np.ndarray]:
    """sample: {input_ids [T], attention_mask [T], labels? [T], index?} ->
    padded block arrays [n_blocks, dist.max] + block_attention_mask."""
    ids = np.asarray(sample["input_ids"])
    att = np.asarray(sample["attention_mask"])
    T = ids.shape[-1]
    lengths = distribution.get_lengths(T, sample.get("index"))
    n_blocks = len(lengths)
    L = distribution.max
    out_ids = np.full((n_blocks, L), pad_token_id, ids.dtype)
    out_att = np.zeros((n_blocks, L), att.dtype)
    out = {"input_ids": out_ids, "attention_mask": out_att}
    if "labels" in sample:
        out["labels"] = np.full((n_blocks, L), -100,
                                np.asarray(sample["labels"]).dtype)
    pos = 0
    for i, bl in enumerate(lengths):
        out_ids[i, :bl] = ids[pos:pos + bl]
        out_att[i, :bl] = att[pos:pos + bl]
        if "labels" in sample:
            out["labels"][i, :bl] = np.asarray(sample["labels"])[pos:pos + bl]
        pos += bl
    out["block_attention_mask"] = (out_att != 0).any(-1).astype(np.int64)
    return out
