"""Structured attention masks (port of ``block_transformer_tpu/ops/masks.py``).

A mask is three index vectors: ``allowed[b, q, k] = kv_idx[k] <= q_idx[q]``
and ``kv_valid[b, k] != 0``. The indices are token positions for causal
attention and block indices for the block decoder's block-causal pattern.
Cache slots beyond the write frontier carry indices greater than every
query index, so decode steps mask them through the same comparison.

The hand kernels read the vectors directly and build the mask per tile; the
plain path materializes ``bias()``. The masked value is ``-1e30``, not
``-inf``, exactly as in the JAX package: a query row with no allowed key
then averages its values uniformly instead of producing NaN.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30


class AttnMask(NamedTuple):
    q_idx: torch.Tensor                   # [Q] or [B, Q] int32
    kv_idx: torch.Tensor                  # [K] int32
    kv_valid: Optional[torch.Tensor]      # [B, K] (1 = usable key) or None

    def allowed(self) -> torch.Tensor:
        """[B, Q, K] bool (B=1 when unbatched q_idx and no kv_valid)."""
        q = self.q_idx if self.q_idx.dim() == 2 else self.q_idx[None]
        ok = self.kv_idx[None, None, :] <= q[:, :, None]
        if self.kv_valid is not None:
            ok = ok & (self.kv_valid[:, None, :] != 0)
        return ok

    def bias(self) -> torch.Tensor:
        """Additive f32 [B, 1, Q, K] (0 attendable, NEG_INF masked)."""
        ok = self.allowed()
        zero = torch.zeros((), dtype=torch.float32, device=ok.device)
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=ok.device)
        return torch.where(ok, zero, neg)[:, None]


def _ar(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def causal_mask(q_positions, kv_positions, kv_valid=None) -> AttnMask:
    return AttnMask(q_positions.to(torch.int32), kv_positions.to(torch.int32),
                    kv_valid)


def block_decoder_train_mask(block_attention_mask: torch.Tensor,
                             n_embedding_tokens: int) -> AttnMask:
    B, N = block_attention_mask.shape
    S = N * n_embedding_tokens
    idx = _ar(S, block_attention_mask.device) // n_embedding_tokens
    kv_valid = block_attention_mask.repeat_interleave(n_embedding_tokens, dim=1)
    return AttnMask(idx, idx, kv_valid)


def token_decoder_train_mask(attention_mask: torch.Tensor,
                             n_prefix: int) -> AttnMask:
    B, T = attention_mask.shape
    S = n_prefix + T
    valid = torch.cat([torch.ones((B, n_prefix), dtype=attention_mask.dtype,
                                  device=attention_mask.device),
                       attention_mask], dim=1)
    idx = _ar(S, attention_mask.device)
    return AttnMask(idx, idx, valid)


def decode_mask(cache_length: int, capacity: int, q_len: int, kv_valid=None,
                *, device) -> AttnMask:
    """Queries at absolute positions [cache_length, cache_length+q_len)
    against a fixed-capacity cache (unwritten slots mask out through the
    index comparison)."""
    return AttnMask(cache_length + _ar(q_len, device), _ar(capacity, device),
                    kv_valid)


def block_decode_mask(cache_length: int, capacity: int, q_len: int,
                      block_kv_valid: torch.Tensor,
                      n_embedding_tokens: int = 1) -> AttnMask:
    device = block_kv_valid.device
    q_idx = (cache_length + _ar(q_len, device)) // n_embedding_tokens
    kv_idx = _ar(capacity, device) // n_embedding_tokens
    return AttnMask(q_idx, kv_idx, block_kv_valid)
