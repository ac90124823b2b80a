"""Attention (port of ``block_transformer_tpu/ops/attention.py``).

``attention_xla`` is the plain path: float32 scores plus the mask's additive
bias, float32 softmax, probabilities cast to ``q.dtype`` before P.V with a
float32 accumulator, output in ``q.dtype``. ``attention`` sends every query
block with Q >= 8 rows (and a head dim the kernel takes) to the flash
kernel K3, whose wrapper runs its plain version on the CPU; smaller Q (the
token decoder's tiny local-cache attention) stays on ``attention_xla``, as
it stays on XLA in the JAX package.

Under autograd (grad mode on and q, k or v requiring grad) every query
block stays on the plain path, as the JAX package trains with
``attn_impl="xla"``: K3 has no backward, and its wrapper refuses such
inputs. Inference runs under ``torch.no_grad()`` and keeps K3.

``impl`` is the JAX package's attention switch, "xla" or "pallas". The port
has no compiler to hand "xla" to, so the hand kernel serves both: each takes
K3 where it takes the shape (``flash_attention.supported``). Inside
``ops.linear.pallas_disabled()`` both take the plain path on the CPU, as
JAX's "pallas" falls back to XLA there, and raise on the card (nothing in
the port sets that switch).

``attention_xla_chunked`` is the JAX package's online-softmax form of
``attention_xla`` over key tiles. As there, it is opt-in, inside
``chunked_prefill_attention(tile)`` (the JAX package's
``BT_CHUNKED_PREFILL_ATTN=1`` / ``BT_CHUNKED_ATTN_TILE``), and then takes
the queries that would go to ``attention_xla`` with Q >= 64 and
K >= 2 * tile; K3 keeps every query block it takes.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import masks as masks_lib

_CHUNKED_TILE: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "bt_chunked_attn_tile", default=None)


@contextlib.contextmanager
def chunked_prefill_attention(tile: int = 256):
    """Send prefill-shaped ``attention_xla`` calls inside through
    ``attention_xla_chunked`` with key tiles of ``tile``."""
    tok = _CHUNKED_TILE.set(int(tile))
    try:
        yield
    finally:
        _CHUNKED_TILE.reset(tok)


def _scale(q: torch.Tensor) -> torch.Tensor:
    # 1/sqrt(D) in float32 arithmetic, as 1 / jnp.sqrt(jnp.float32(D))
    return 1.0 / torch.tensor(float(q.shape[-1]), device=q.device).sqrt()


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: masks_lib.AttnMask) -> torch.Tensor:
    """q [B, H, Q, D]; k, v [B, H, K, D] -> [B, H, Q, D] in q.dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q)
    scores = scores + mask.bias()
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_xla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: masks_lib.AttnMask,
                          tile: int = 256) -> torch.Tensor:
    """Online-softmax attention over key tiles of ``tile`` (the last one
    padded, its padding masked): the numerics of ``attention_xla``
    reassociated over tiles. q [B, H, Q, D]; k, v [B, H, K, D]."""
    B, H, Q, _ = q.shape
    K = k.shape[2]
    q_idx = mask.q_idx
    if q_idx.dim() == 1:
        q_idx = q_idx[None].expand(B, Q)
    kv_valid = mask.kv_valid
    if kv_valid is None:
        kv_valid = torch.ones((B, K), dtype=torch.int32, device=q.device)
    scale = _scale(q)
    qf = q.float()
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Q), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Q), dtype=torch.float32, device=q.device)
    for t0 in range(0, K, tile):
        sl = slice(t0, min(K, t0 + tile))
        s = torch.matmul(qf, k[:, :, sl].float().transpose(-1, -2)) * scale
        ok = ((mask.kv_idx[sl][None, None, None, :]
               <= q_idx[:, None, :, None])
              & (kv_valid[:, None, None, sl] != 0))
        s = torch.where(ok, s, -1e30)
        if s.shape[-1] < tile:   # the padded tail: masked keys of score -1e30
            s = torch.cat([s, s.new_full((*s.shape[:-1], tile - s.shape[-1]),
                                         -1e30)], dim=-1)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p[..., :sl.stop - t0].to(q.dtype).float(),
                          v[:, :, sl].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _use_chunked(Q: int, K: int) -> bool:
    """Inside ``chunked_prefill_attention``: Q >= 64 rows with at least two
    key tiles (the JAX package's gate)."""
    tile = _CHUNKED_TILE.get()
    return tile is not None and Q >= 64 and K >= 2 * tile


def attention(q, k, v, mask: masks_lib.AttnMask, impl: str = "xla"):
    # imported here: the kernel module imports attention_xla from this one
    from block_transformer_tpu_torch.kernels import build, flash_attention
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if not linear_ops.pallas_allowed():
        linear_ops.refuse_plain_on_card(q)
    elif flash_attention.supported(q, k) and not build.needs_grad(q, k, v):
        return flash_attention.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), mask)
    if _use_chunked(q.shape[2], k.shape[2]):
        return attention_xla_chunked(q, k, v, mask, tile=_CHUNKED_TILE.get())
    return attention_xla(q, k, v, mask)
