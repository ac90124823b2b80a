"""GPT-NeoX (Pythia) stack in PyTorch (port of
``block_transformer_tpu/models/neox.py``).

Partial rotary embeddings (rotate-half on the first ``rotary_pct`` of each
head), parallel attention + MLP residual, exact GeLU, float32 layer norm and
softmax. Parameters keep the JAX tree's layout: layers stacked on a leading
``[L, ...]`` axis, kernels ``[in, out]``, the fused QKV output ordered
``(q|k|v, head, head_dim)``. The JAX layer ``scan`` becomes a loop over layer
indices into the stacked tensors; ``layer_view`` hands each linear to
``apply_linear`` as a ``StackedLinear``, so no weight slice is copied.

KV caches are fixed-capacity ``[L, B, H, cap, D]`` buffers with a Python-int
``length`` (bf16, INT8 or INT4), or the serving engine's paged INT8 or INT4
pool (``PagedKVCache``). An INT4 cache or pool holds its values packed two
to a byte along D (``ops.quant.pack_kv_int4``, uint8 ``[..., D/2]``); its
dtype, uint8, is what tells it from an INT8 one.
Unlike the JAX functions, which return new arrays, the cached forwards here
write the new K/V into the given buffers in place and return a cache tuple
that shares them.

Cache writes go at ``write_pos``: by default ``cache.length`` for every row,
or a ``[B]`` int32 tensor of per-row offsets (the engine's slot frontiers).
A per-row write whose position falls outside the cache is dropped; the JAX
reference clamps it instead, which only ever touches a finished slot.

Cached attention: the bf16 and INT8 caches send decode-shaped queries
(S <= 8) to K2's bf16 and INT8 forms (``kernels/decode_attention.py``); the
INT8 cache writes a per-row single position through K5
(``kernels/paged_attention.py``, the cache viewed as a pool with one page
per row). Longer queries, and every query on the INT4 cache (as in the JAX
package, which has no kernel there), dequantize the layer and go through
``ops.attention.attention``, which sends Q >= 8 to K3; INT4 writes are
plain indexed writes of packed rows. The paged pool attends through K6
(both widths); for single-position decode steps the INT8 pool defers the
write of every layer to one K7 launch after the layer loop, while the INT4
pool, like every longer step, writes each layer first.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from block_transformer_tpu_torch.config import NeoXConfig
from block_transformer_tpu_torch.kernels import decode_attention
from block_transformer_tpu_torch.kernels import paged_attention
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import masks as masks_lib
from block_transformer_tpu_torch.ops.attention import attention
from block_transformer_tpu_torch.ops.quant import (dequantize_kv, kv_bits,
                                                   pack_kv_int4, quantize_kv)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_neox_params(gen: torch.Generator, cfg: NeoXConfig, *,
                     with_embed_in: bool = True, with_lm_head: bool = True,
                     dtype=torch.float32, device="cuda"):
    """Full stack parameters with layers stacked on axis 0; dense weights are
    N(0, initializer_range) drawn from ``gen`` (a generator on ``device``)."""
    L, h, m = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    std = cfg.initializer_range

    def dense(*shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (std * w).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    params = {
        "layers": {
            "ln1": {"scale": ones(L, h), "bias": zeros(L, h)},
            "ln2": {"scale": ones(L, h), "bias": zeros(L, h)},
            "attn": {
                "qkv": {"kernel": dense(L, h, 3 * h), "bias": zeros(L, 3 * h)},
                "out": {"kernel": dense(L, h, h), "bias": zeros(L, h)},
            },
            "mlp": {
                "up": {"kernel": dense(L, h, m), "bias": zeros(L, m)},
                "down": {"kernel": dense(L, m, h), "bias": zeros(L, h)},
            },
        },
        "final_ln": {"scale": ones(h), "bias": zeros(h)},
    }
    if with_embed_in:
        params["embed_in"] = {"weight": dense(cfg.vocab_size, h)}
    if with_lm_head:
        params["embed_out"] = {"kernel": dense(h, cfg.vocab_size)}
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _rope_tables(rotary_dim: int, max_pos: int, theta: float, device: str):
    ar = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (theta ** (ar / rotary_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                  # [max_pos, rotary_dim/2]
    emb = torch.cat([freqs, freqs], dim=-1)           # [max_pos, rotary_dim]
    return emb.cos(), emb.sin()


def rope_tables(cfg: NeoXConfig, max_pos: Optional[int], device):
    return _rope_tables(cfg.rotary_dim, max_pos or cfg.max_position_embeddings,
                        cfg.rope_theta, str(torch.device(device)))


def apply_rope(x: torch.Tensor, cos, sin, positions) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` dims of x [B, H, S, D] by position;
    positions [S] or [B, S]."""
    r = cos.shape[-1]
    x_rot, x_pass = x[..., :r], x[..., r:]
    c = cos[positions].float()
    s = sin[positions].float()
    if c.dim() == 2:            # [S, r] -> broadcast over batch and heads
        c, s = c[None, None], s[None, None]
    else:                       # [B, S, r] -> add the head axis
        c, s = c[:, None], s[:, None]
    xr = x_rot.float()
    x1, x2 = xr.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    x_rot = (xr * c + rotated * s).to(x.dtype)
    return torch.cat([x_rot, x_pass], dim=-1)


class KVCache(NamedTuple):
    """Fixed-capacity cache: k, v [L, B, H, cap, D]; length: valid slots."""
    k: torch.Tensor
    v: torch.Tensor
    length: int

    @staticmethod
    def create(cfg: NeoXConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, device="cuda"):
        shape = (cfg.num_layers, batch, cfg.num_heads, capacity, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device), 0)


class QuantKVCache(NamedTuple):
    """INT8 cache: values int8 [L, B, H, cap, D], or INT4 (``bits=4``):
    uint8 [L, B, H, cap, D/2], packed split-half along D; one float32 scale
    per (layer, batch, head, slot) [L, B, H, cap]."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    length: int

    @staticmethod
    def create(cfg: NeoXConfig, batch: int, capacity: int, *, bits: int = 8,
               device="cuda"):
        shape = (cfg.num_layers, batch, cfg.num_heads, capacity, cfg.head_dim)
        f32 = dict(dtype=torch.float32, device=device)
        return QuantKVCache(_zero_values(shape, bits, device),
                            _zero_values(shape, bits, device),
                            torch.zeros(shape[:-1], **f32),
                            torch.zeros(shape[:-1], **f32), 0)

    @property
    def bits(self) -> int:
        return kv_bits(self.k)


class PagedKVCache(NamedTuple):
    """Paged KV pool: values int8 [L, P, H, page_size, D] (INT4: uint8
    [..., D/2], packed) and float32 scales [L, P, H, page_size] shared by
    every row; ``page_table``
    [B, n_virt] int32 maps each row's virtual pages to pool pages. Page 0
    is the null page: unallocated virtual pages point there and are masked
    by kv_valid. ``length`` is kept for the cache interface only (the
    engine tracks each row's length itself)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    page_table: torch.Tensor
    length: int

    @staticmethod
    def create(cfg: NeoXConfig, batch: int, capacity: int, *, n_pages: int,
               page_size: int = 256, bits: int = 8, device="cuda"):
        if capacity % page_size:
            raise ValueError(f"capacity {capacity} is not a multiple of the "
                             f"page size {page_size}")
        shape = (cfg.num_layers, n_pages, cfg.num_heads, page_size,
                 cfg.head_dim)
        f32 = dict(dtype=torch.float32, device=device)
        return PagedKVCache(
            _zero_values(shape, bits, device),
            _zero_values(shape, bits, device),
            torch.zeros(shape[:-1], **f32), torch.zeros(shape[:-1], **f32),
            torch.zeros((batch, capacity // page_size), dtype=torch.int32,
                        device=device), 0)

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def bits(self) -> int:
        return kv_bits(self.k)


def _zero_values(shape, bits: int, device) -> torch.Tensor:
    """Zero cache values: int8 ``shape`` (bits 8) or packed uint8
    ``shape[:-1] + (D/2,)`` (bits 4)."""
    if bits == 8:
        return torch.zeros(shape, dtype=torch.int8, device=device)
    if bits != 4:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if shape[-1] % 2:
        raise ValueError(f"an INT4 cache needs an even head dim, got "
                         f"{shape[-1]}")
    return torch.zeros((*shape[:-1], shape[-1] // 2), dtype=torch.uint8,
                       device=device)


def make_kv_cache(cfg: NeoXConfig, batch: int, capacity: int, kind: str,
                  dtype=torch.bfloat16, device="cuda"):
    """kind: 'bf16' (a cache in ``dtype``), 'int8' or 'int4'."""
    if kind in ("int8", "int4"):
        return QuantKVCache.create(cfg, batch, capacity,
                                   bits=8 if kind == "int8" else 4,
                                   device=device)
    if kind != "bf16":
        raise ValueError(f"unknown kv cache kind {kind!r} "
                         "(expected bf16/int8/int4)")
    return KVCache.create(cfg, batch, capacity, dtype=dtype, device=device)


def _check_room(cache, S: int, start: int) -> None:
    cap = cache.k.shape[3]
    if start + S > cap:
        raise ValueError(f"cache write [{start}, {start + S}) past capacity "
                         f"{cap}")


def _write_rows(buf: torch.Tensor, i: int, new: torch.Tensor,
                write_pos: torch.Tensor) -> None:
    """Write ``new`` ([B, H, S(, D)]) into ``buf[i]`` ([B, H, cap(, D)]) at
    each row's own offset ``write_pos[b]``, in place, with no host sync.
    Positions outside [0, cap) are dropped: such an entry is aimed at the
    nearest in-range slot and carries the value this call writes there (or
    the value already there), so every duplicate target gets one value."""
    layer = buf[i]
    B, H, S = new.shape[:3]
    cap = layer.shape[2]
    wp = write_pos.to(torch.long)[:, None]
    tgt = (wp + torch.arange(S, device=new.device)).clamp(0, cap - 1)  # [B, S]
    src = tgt - wp                      # the new position written at tgt
    from_new = (src >= 0) & (src < S)
    tail = new.shape[3:]

    def spread(idx):                    # [B, S] -> the gather index of new
        idx = idx[:, None, :].expand(B, H, S)
        return idx.reshape(B, H, S, *(1,) * len(tail)).expand(new.shape)

    vals = torch.where(
        spread(from_new),
        new.to(layer.dtype).gather(2, spread(src.clamp(0, S - 1))),
        layer.gather(2, spread(tgt)))
    layer.scatter_(2, spread(tgt), vals)


def _quantize_pair(k, v, bits: int):
    """(kq, ks, vq, vs): k and v quantized per slot, packed when bits is
    4."""
    kq, ks = quantize_kv(k, bits)
    vq, vs = quantize_kv(v, bits)
    if bits == 4:
        kq, vq = pack_kv_int4(kq), pack_kv_int4(vq)
    return kq, ks, vq, vs


def _write_layer(cache, i: int, write_pos, k, v, rows=None) -> None:
    """Write one layer's new K/V [B, H, S, D] in place at ``write_pos``: an
    int (every row) or a [B] int32 tensor (per row; quantized per slot for
    a QuantKVCache, and packed for an INT4 one). A per-row single-position
    write into the INT8 cache goes through K5, with ``rows = arange(B)`` as
    its page ids; INT4 writes are plain indexed writes, as in JAX."""
    if isinstance(cache, QuantKVCache):
        kq, ks, vq, vs = _quantize_pair(k, v, cache.bits)
        new = ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
               (cache.v_scale, vs))
    else:
        new = ((cache.k, k), (cache.v, v))
    if isinstance(write_pos, int):
        sl = slice(write_pos, write_pos + k.shape[2])
        for buf, val in new:
            buf[i, :, :, sl] = val.to(buf.dtype)
    elif (isinstance(cache, QuantKVCache) and cache.bits == 8
          and k.shape[2] == 1):
        paged_attention.paged_write_int8(
            cache.k, cache.k_scale, cache.v, cache.v_scale, i, rows,
            write_pos, kq[:, :, 0].contiguous(), ks[:, :, 0].contiguous(),
            vq[:, :, 0].contiguous(), vs[:, :, 0].contiguous())
    else:
        for buf, val in new:
            _write_rows(buf, i, val, write_pos)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def layer_qkv(p, x, *, cfg: NeoXConfig, cos, sin, positions):
    """LN1 + fused QKV + RoPE. Returns (q, k, v), each [B, H, S, D]."""
    B, S, H, D = x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim
    attn_in = layer_norm(x, p["ln1"], cfg.layer_norm_eps)
    qkv = linear_ops.apply_linear(attn_in, p["attn"]["qkv"])     # [B, S, 3h]
    qkv = qkv.reshape(B, S, 3, H, D).permute(2, 0, 3, 1, 4)      # [3, B, H, S, D]
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    return q, k, v


def layer_finish(p, x, attn_heads, *, cfg: NeoXConfig):
    """Output projection + MLP + residual(s). attn_heads: [B, H, S, D]."""
    B, S = x.shape[0], x.shape[1]
    dense = linear_ops.apply_linear

    def mlp(h):
        up = F.gelu(dense(layer_norm(h, p["ln2"], cfg.layer_norm_eps),
                          p["mlp"]["up"]), approximate="none")
        return dense(up, p["mlp"]["down"])

    attn_out = dense(attn_heads.transpose(1, 2).reshape(B, S, -1),
                     p["attn"]["out"])
    if cfg.use_parallel_residual:
        return x + attn_out + mlp(x)
    x = x + attn_out
    return x + mlp(x)


def layer_view(layers, i: int):
    """Per-layer view of the stacked ``layers`` tree: linear nodes become
    ``StackedLinear(node, i)``, other leaves the view ``leaf[i]``."""
    def walk(node):
        if isinstance(node, dict):
            if any(k.startswith("kernel") for k in node):
                return linear_ops.StackedLinear(node, i)
            return {k: walk(v) for k, v in node.items()}
        return node[i]

    return walk(layers)


def neox_stack(params, x: torch.Tensor, *, cfg: NeoXConfig,
               mask: masks_lib.AttnMask, positions: torch.Tensor,
               cache=None, write_pos=None, remat: bool = False):
    """Run the stack over hidden states x [B, S, h]; with a cache, the new
    K/V are written at ``write_pos``: ``cache.length`` by default, an int,
    or a [B] int32 tensor of per-row offsets. Returns (final-normed hidden
    states, updated cache or None).

    ``remat`` (no cache: the training forward) checkpoints each layer, as
    the JAX package's ``jax.checkpoint`` of the layer body: the backward
    recomputes the layer instead of keeping its activations. No op draws
    random numbers, so the values are unchanged."""
    max_pos = cfg.max_position_embeddings
    if cache is not None:
        cap = cache.k.shape[3]
        if isinstance(cache, PagedKVCache):     # a row's virtual capacity
            cap *= cache.page_table.shape[1]
        max_pos = max(max_pos, cap)
        if write_pos is None:
            write_pos = cache.length
    cos, sin = rope_tables(cfg, max_pos, x.device)
    if isinstance(cache, PagedKVCache):
        return _paged_stack(params, x, cfg=cfg, mask=mask, positions=positions,
                            cache=cache, write_pos=write_pos, cos=cos,
                            sin=sin)
    layers = params["layers"]
    if cache is None:
        def layer(h, i):
            p = layer_view(layers, i)
            q, k, v = layer_qkv(p, h, cfg=cfg, cos=cos, sin=sin,
                                positions=positions)
            return layer_finish(p, h, attention(q, k, v, mask), cfg=cfg)

        h = x
        for i in range(cfg.num_layers):
            h = (checkpoint(layer, h, i, use_reentrant=False) if remat
                 else layer(h, i))
        return layer_norm(h, params["final_ln"], cfg.layer_norm_eps), None
    if isinstance(write_pos, int):
        _check_room(cache, x.shape[1], write_pos)
    B, S = x.shape[:2]
    rows = (torch.arange(B, dtype=torch.int32, device=x.device)
            if torch.is_tensor(write_pos) else None)
    h = x
    for i in range(cfg.num_layers):
        p = layer_view(layers, i)
        q, k, v = layer_qkv(p, h, cfg=cfg, cos=cos, sin=sin,
                            positions=positions)
        if isinstance(cache, QuantKVCache):
            _write_layer(cache, i, write_pos, k, v, rows)
            if cache.bits == 8 and S <= decode_attention.MAX_S:
                attn = decode_attention.decode_attention_int8_stacked(
                    q.contiguous(), cache.k, cache.k_scale, cache.v,
                    cache.v_scale, i, mask)
            else:
                attn = attention(q, dequantize_kv(cache.k[i], cache.k_scale[i],
                                                  q.dtype),
                                 dequantize_kv(cache.v[i], cache.v_scale[i],
                                               q.dtype), mask)
        else:
            _write_layer(cache, i, write_pos, k, v)
            if S <= decode_attention.MAX_S:
                attn = decode_attention.decode_attention_stacked(
                    q.contiguous(), cache.k, cache.v, i, mask)
            else:
                attn = attention(q, cache.k[i].to(q.dtype),
                                 cache.v[i].to(q.dtype), mask)
        h = layer_finish(p, h, attn, cfg=cfg)
    cache = cache._replace(length=cache.length + S)
    return layer_norm(h, params["final_ln"], cfg.layer_norm_eps), cache


def _paged_stack(params, x, *, cfg: NeoXConfig, mask, positions,
                 cache: PagedKVCache, write_pos, cos, sin):
    """The stack over the paged pool. Position ``write_pos[b] + s`` of row b
    goes to page ``page_table[b, pos // ps]`` at ``pos % ps`` (page -1,
    dropped by the writes, past the row's virtual pages).

    A single-position step (the engine's decode) on the INT8 pool writes
    nothing inside the layer loop: each layer attends through K6 to the
    pool, whose stale frontier slot ``mask.q_idx - 1`` masks, plus its own
    just-quantized K/V dequantized as the ``fresh`` term, and one K7 launch
    after the loop writes every layer's K/V. Longer steps, and every step
    on the INT4 pool (the JAX package defers INT8 writes only), write each
    layer first with a plain indexed write of quantized (packed) rows, then
    attend through K6 with the mask as it is."""
    B, S = x.shape[:2]
    ps, pt = cache.page_size, cache.page_table
    n_virt = pt.shape[1]
    if isinstance(write_pos, int):
        write_pos = torch.full((B,), write_pos, dtype=torch.int32,
                               device=x.device)
    vp = write_pos[:, None] + torch.arange(S, dtype=torch.int32,
                                           device=x.device)      # [B, S]
    vpage = torch.div(vp, ps, rounding_mode="floor")
    in_table = (vpage >= 0) & (vpage < n_virt)
    page = torch.where(in_table, pt.gather(1, vpage.clamp(0, n_virt - 1)),
                       -1).to(torch.int32)
    off = (vp - vpage * ps).to(torch.int32)
    layers = params["layers"]
    pools = (cache.k, cache.k_scale, cache.v, cache.v_scale)
    h = x
    if S == 1 and cache.bits == 8:
        L, H, D = cfg.num_layers, cfg.num_heads, cfg.head_dim
        step_q = torch.empty((2, L, B, H, D), dtype=torch.int8,
                             device=x.device)
        step_s = torch.empty((2, L, B, H), dtype=torch.float32,
                             device=x.device)
        mask_d = mask._replace(q_idx=mask.q_idx - 1)
        for i in range(L):
            p = layer_view(layers, i)
            q, k, v = layer_qkv(p, h, cfg=cfg, cos=cos, sin=sin,
                                positions=positions)
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            step_q[0, i], step_s[0, i] = kq[:, :, 0], ks[:, :, 0]
            step_q[1, i], step_s[1, i] = vq[:, :, 0], vs[:, :, 0]
            # the fresh pair is dequantized, so it carries the quantization
            # error a pool read would
            kf = step_q[0, i].float() * step_s[0, i][..., None]
            vf = step_q[1, i].float() * step_s[1, i][..., None]
            attn = paged_attention.paged_decode_attention_int8(
                q.contiguous(), cache.k, cache.k_scale, cache.v,
                cache.v_scale, i, pt, mask_d, fresh=(kf, vf)).to(q.dtype)
            h = layer_finish(p, h, attn, cfg=cfg)
        paged_attention.paged_write_layers_int8(
            *pools, page[:, 0].contiguous(), off[:, 0].contiguous(),
            step_q[0], step_s[0], step_q[1], step_s[1])
    else:
        ok = (page >= 0) & (off < ps)
        pg, of = page[ok].long(), off[ok].long()
        for i in range(cfg.num_layers):
            p = layer_view(layers, i)
            q, k, v = layer_qkv(p, h, cfg=cfg, cos=cos, sin=sin,
                                positions=positions)
            kq, ks, vq, vs = _quantize_pair(k, v, cache.bits)
            # [B, H, S(, D)] -> the (b, s) pairs in range, [n, H(, D)]
            cache.k[i, pg, :, of] = kq.transpose(1, 2)[ok]
            cache.v[i, pg, :, of] = vq.transpose(1, 2)[ok]
            cache.k_scale[i, pg, :, of] = ks.transpose(1, 2)[ok]
            cache.v_scale[i, pg, :, of] = vs.transpose(1, 2)[ok]
            attn = paged_attention.paged_decode_attention_int8(
                q.contiguous(), cache.k, cache.k_scale, cache.v,
                cache.v_scale, i, pt, mask).to(q.dtype)
            h = layer_finish(p, h, attn, cfg=cfg)
    cache = cache._replace(length=cache.length + S)
    return layer_norm(h, params["final_ln"], cfg.layer_norm_eps), cache


def fresh_attn_tiles(mask: masks_lib.AttnMask, S: int, q_tile: int):
    """Attention for the fresh prefill: ``q_tile`` query rows at a time
    against the full fresh K/V. The last tile may be shorter (the kernels
    take any Q), so no padding rows are made."""
    if mask.q_idx.dim() != 1:
        raise ValueError("fresh prefill expects an unbatched q_idx")
    tq = min(q_tile, S)

    def attn_tiles(q, k, v):
        if tq == S:
            return attention(q, k, v, mask)
        out = torch.empty_like(q)
        for t0 in range(0, S, tq):
            sl = slice(t0, min(S, t0 + tq))
            m_t = masks_lib.AttnMask(mask.q_idx[sl], mask.kv_idx,
                                     mask.kv_valid)
            out[:, :, sl] = attention(q[:, :, sl], k, v, m_t)
        return out

    return attn_tiles


def neox_prefill_fresh(params, x: torch.Tensor, *, cfg: NeoXConfig,
                       mask: masks_lib.AttnMask, positions: torch.Tensor,
                       cache, q_tile: int = 512):
    """Prefill an EMPTY cache in one pass: each layer's attention reads the
    K/V it just computed, unquantized, while the cache (bf16 or INT8) is
    only written. ``mask`` covers the whole [S, S] prompt. Returns (hidden
    [B, S, h] final-normed, the cache with length = S)."""
    B, S, _ = x.shape
    _check_room(cache, S, 0)
    cos, sin = rope_tables(cfg, max(cfg.max_position_embeddings,
                                    cache.k.shape[3]), x.device)
    layers = params["layers"]
    attn_tiles = fresh_attn_tiles(mask, S, q_tile)
    h = x
    for i in range(cfg.num_layers):
        p = layer_view(layers, i)
        q, k, v = layer_qkv(p, h, cfg=cfg, cos=cos, sin=sin,
                            positions=positions)
        _write_layer(cache, i, 0, k, v)
        h = layer_finish(p, h, attn_tiles(q, k, v), cfg=cfg)
    h = layer_norm(h, params["final_ln"], cfg.layer_norm_eps)
    return h, cache._replace(length=S)


def embed_tokens(params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_in"]["weight"][input_ids]


def lm_logits(params, hidden: torch.Tensor) -> torch.Tensor:
    """Untied LM head: [.., h] -> [.., vocab], computed in hidden's dtype,
    then cast to float32."""
    return linear_ops.apply_linear(hidden, params["embed_out"]).float()
