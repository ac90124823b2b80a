"""Block-format training batches (port of the fixed-length path of
``block_transformer_tpu/data/packing.py``: ``split_blocks``, ``add_labels``
and the tail of ``make_train_batch``).

Token arrays ``[..., T]`` become blocks ``[..., N, L]`` with
``block_attention_mask [..., N]`` (a block is live when any of its tokens
is attended), and labels are the token ids with -100 where the attention
mask is 0. numpy in, numpy out, as in the JAX package; ``to_device`` makes
tensors of a batch.
"""

from __future__ import annotations

import numpy as np
import torch


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


def make_train_batch(input_ids: np.ndarray, attention_mask: np.ndarray,
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


def to_device(batch: dict, device="cuda") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
