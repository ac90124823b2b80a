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
        return _neg_where(self.allowed())


def _ar(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _neg_where(ok: torch.Tensor) -> torch.Tensor:
    """[B, Q, K] bool -> additive f32 [B, 1, Q, K]: 0 where allowed,
    NEG_INF where masked."""
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)[:, None]


# Additive biases, materialized [B, 1, Q, K] float32 (the JAX package's
# bias builders; the port's attention takes the structured masks below)

def causal_bias(q_positions: torch.Tensor, kv_positions: torch.Tensor,
                kv_valid=None) -> torch.Tensor:
    """q_positions [Q] or [B, Q]; kv_positions [K] or [B, K]; kv_valid an
    optional [B, K] (0 keys masked everywhere). f32 [B, 1, Q, K] on the
    positions' device (B = 1 if both are unbatched)."""
    q = q_positions if q_positions.dim() == 2 else q_positions[None]
    k = kv_positions if kv_positions.dim() == 2 else kv_positions[None]
    ok = k[:, None, :] <= q[:, :, None]
    if kv_valid is not None:
        ok = ok & (kv_valid[:, None, :] != 0)
    return _neg_where(ok)


def block_causal_bias(q_block_idx: torch.Tensor, kv_block_idx: torch.Tensor,
                      n_embedding_tokens: int = 1,
                      kv_valid=None) -> torch.Tensor:
    """The block decoder's bias from the block index of each embedding-token
    position (the indices are already at block granularity, so
    ``n_embedding_tokens`` is not used); ``kv_valid`` [B, K] per key."""
    del n_embedding_tokens
    return causal_bias(q_block_idx, kv_block_idx, kv_valid)


def block_decoder_self_attention_bias(block_attention_mask: torch.Tensor,
                                      n_embedding_tokens: int
                                      ) -> torch.Tensor:
    """block_attention_mask [B, N] (1 = real block) -> [B, 1, S, S] with S =
    N * n_embedding_tokens."""
    m = block_decoder_train_mask(block_attention_mask, n_embedding_tokens)
    return causal_bias(m.q_idx, m.kv_idx, m.kv_valid)


def token_decoder_self_attention_bias(attention_mask: torch.Tensor,
                                      n_prefix: int) -> torch.Tensor:
    """attention_mask [B, T] over the tokens after an always-attendable
    prefix of ``n_prefix`` -> [B, 1, n_prefix + T, n_prefix + T]."""
    m = token_decoder_train_mask(attention_mask, n_prefix)
    return causal_bias(m.q_idx, m.kv_idx, m.kv_valid)


def decode_step_bias(cache_length: int, capacity: int, q_len: int,
                     kv_valid=None, batch: int = 1, *,
                     device) -> torch.Tensor:
    """Queries at [cache_length, cache_length + q_len) against a cache of
    ``capacity`` slots, slot k valid iff k < cache_length + q_len (and
    kv_valid [B, capacity] if given) -> [batch, 1, q_len, capacity] on
    ``device``."""
    q_pos = cache_length + _ar(q_len, device)
    k_idx = _ar(capacity, device)
    ok = ((k_idx[None, :] <= q_pos[:, None])
          & (k_idx[None, :] < cache_length + q_len))
    ok = ok[None].expand(batch, q_len, capacity)
    if kv_valid is not None:
        ok = ok & (kv_valid[:, None, :] != 0)
    return _neg_where(ok)


def block_decode_step_bias(cache_length: int, capacity: int, q_len: int,
                           block_kv_valid: torch.Tensor,
                           n_embedding_tokens: int = 1) -> torch.Tensor:
    """``decode_step_bias`` with block-granular causality: block_kv_valid
    [B, capacity] per cached embedding-token slot -> [B, 1, q_len,
    capacity] on its device."""
    device = block_kv_valid.device
    B = block_kv_valid.shape[0]
    q_block = (cache_length + _ar(q_len, device)) // n_embedding_tokens
    k_idx = _ar(capacity, device)
    ok = ((k_idx[None, :] // n_embedding_tokens <= q_block[:, None])
          & (k_idx[None, :] < cache_length + q_len))
    ok = ok[None].expand(B, q_len, capacity) & (
        block_kv_valid[:, None, :] != 0)
    return _neg_where(ok)


# Structured masks (AttnMask)

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
