"""K2: decode attention over a stacked KV cache (replaces the Pallas kernel
``block_transformer_tpu/ops/decode_attention.py`` ``_decode_attn`` in both
its forms: INT8, entry ``decode_attention_int8_stacked``, and unquantized,
entry ``decode_attention_stacked``).

q ``[B, H, S, D]`` with S <= 8 against one layer of the stacked int8 cache
``[L, B, H, cap, D]`` with float32 per-slot scales ``[L, B, H, cap]``: the
scores are ``q . k_q * k_scale / sqrt(D)``, the probabilities are multiplied
by ``v_scale`` before the product with ``v_q``, and the softmax is float32.
The CUDA kernel (``csrc/decode_attention.cu``) reads the int8 cache once and
never dequantizes it in memory; it gets the layer's base pointers, so no
slice of the cache is copied. It splits the capacity over blocks as the
pure function ``plan`` says and merges the splits in the same launch,
through a per-stream scratch buffer (``build.scratch``).

The unquantized form takes a bf16 or float32 cache ``[L, B, H, cap, D]``
of the query's dtype, with no scales: scores ``q . k / sqrt(D)``, a float32
softmax, and the probabilities rounded to the cache's (the query's) dtype
before the product with ``v``, as the Pallas kernel (``p.astype(cdt)``) and
``attention_xla`` do. Which of its two kernels runs is the pure function
``route``: the warp route (``"warp"``: one warp per (b, h), for caches of
at most ``WARP_MAX_CAP`` slots, the token decoder's local cache) or the
split route (``"split"``: the same ``plan`` and in-launch merge as the INT8
form, its tiles staged through a ring of ``cp.async`` copies).

Neither form copies the mask: ``mask_args`` hands the kernel the mask's own
int32 vectors (``q_idx`` as [S] or [B, S], ``kv_valid`` absent when every
slot is valid) and converts only a vector that is not int32 or not
contiguous.

Each plain version (the INT8 one dequantizes the layer's cache to
``q.dtype``) runs ``attention_xla``, which is what the JAX package does for
these shapes off the TPU. A wrapper runs its plain version for CPU tensors
and launches its kernel for CUDA tensors; ``<wrapper>.launches`` counts the
launches of each form apart, and ``decode_attention_stacked.route_launches``
the unquantized form's by route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from block_transformer_tpu_torch.kernels import build
from block_transformer_tpu_torch.ops import masks as masks_lib
from block_transformer_tpu_torch.ops.attention import attention_xla

MAX_S = 8
HEAD_DIMS = (32, 64, 128)
TILE = 32           # slots of a tile of the split route
BLOCKS_PER_SM = 4   # blocks of 4 warps the split aims for on every SM
WARP_MAX_CAP = 32   # the warp route's largest cache: one slot a lane
WARP_DTYPES = (torch.bfloat16, torch.float32)


def route(cap: int, S: int, D: int, dtype) -> str:
    """Which K2 kernel serves a ``cap``-slot cache of ``dtype`` (int8 for
    the INT8 form) for S query rows of head dim D: ``"warp"`` for a bf16 or
    float32 cache of at most WARP_MAX_CAP slots, ``"split"`` otherwise.
    Raises for a shape neither takes."""
    if not 1 <= S <= MAX_S or D not in HEAD_DIMS or cap < 1:
        raise ValueError(f"decode attention: no kernel for S={S}, D={D}, "
                         f"cap={cap}")
    if dtype == torch.int8:
        return "split"
    if dtype not in WARP_DTYPES:
        raise TypeError(f"decode attention: no kernel for a {dtype} cache")
    return "warp" if cap <= WARP_MAX_CAP else "split"


class MaskArgs(NamedTuple):
    """The mask as the kernels read it."""
    q_idx: torch.Tensor                 # [S] or [B, S] int32, contiguous
    q_stride: int                       # 0 for [S], S for [B, S]
    kv_idx: torch.Tensor                # [cap] int32, contiguous
    kv_valid: Optional[torch.Tensor]    # [B, cap] int32, or None: all valid


def _int32(t: torch.Tensor, device) -> torch.Tensor:
    if t.dtype == torch.int32 and t.is_contiguous() and t.device == device:
        return t
    return t.to(device=device, dtype=torch.int32).contiguous()


def mask_args(mask: masks_lib.AttnMask, B: int, S: int, cap: int,
              device) -> MaskArgs:
    """The mask's own vectors when they are int32, contiguous and on
    ``device``; a converted copy of any that is not."""
    q_idx = _int32(mask.q_idx, device)
    kv_idx = _int32(mask.kv_idx, device)
    kv_valid = (None if mask.kv_valid is None
                else _int32(mask.kv_valid, device))
    shapes = (tuple(q_idx.shape), tuple(kv_idx.shape),
              None if kv_valid is None else tuple(kv_valid.shape))
    if (shapes[0] not in ((S,), (B, S)) or shapes[1] != (cap,)
            or shapes[2] not in (None, (B, cap))):
        raise ValueError(f"decode attention mask: q_idx, kv_idx, kv_valid "
                         f"{shapes} do not fit B={B} S={S} cap={cap}")
    return MaskArgs(q_idx, 0 if q_idx.dim() == 1 else S, kv_idx, kv_valid)


def decode_attention_int8_stacked_plain(q, k_q, k_s, v_q, v_s, layer: int,
                                        mask: masks_lib.AttnMask):
    k = (k_q[layer].float() * k_s[layer][..., None]).to(q.dtype)
    v = (v_q[layer].float() * v_s[layer][..., None]).to(q.dtype)
    return attention_xla(q, k, v, mask)


def decode_attention_stacked_plain(q, k, v, layer: int,
                                   mask: masks_lib.AttnMask):
    return attention_xla(q, k[layer].to(q.dtype), v[layer].to(q.dtype), mask)


@functools.cache
def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.load("decode_attention"), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class Plan(NamedTuple):
    """How K2 launches: the capacity cut into ``splits`` runs of
    ``slots_per_split`` slots (whole 32-slot tiles), one block each per
    (b, h)."""
    splits: int
    slots_per_split: int


@functools.lru_cache(maxsize=1024)
def plan(B: int, H: int, cap: int, sms: int) -> Plan:
    """The split of a ``cap``-slot cache for B x H (batch row, head) pairs on
    a card with ``sms`` SMs. One block per pair when B*H alone puts
    BLOCKS_PER_SM blocks on every SM; else the slots are cut into the
    fewest runs of whole tiles that reach that many blocks, or one tile a
    split when the cache has fewer tiles. Neither S nor D changes it: a
    block's loads are in flight together whatever their width."""
    tiles = -(-cap // TILE)
    want = -(-BLOCKS_PER_SM * sms // (B * H))
    per = -(-tiles // want)
    return Plan(-(-tiles // per), per * TILE)


def scratch_floats(p: Plan, B: int, H: int, S: int, D: int) -> int:
    """float32 partials the merge needs: (acc[S][D], max, sum) per split
    and (b, h); 0 without a split."""
    return B * H * p.splits * S * (D + 2) if p.splits > 1 else 0


def decode_attention_int8_stacked(q: torch.Tensor, k_q: torch.Tensor,
                                  k_s: torch.Tensor, v_q: torch.Tensor,
                                  v_s: torch.Tensor, layer: int,
                                  mask: masks_lib.AttnMask) -> torch.Tensor:
    """q [B, H, S, D] (S <= 8); k_q/v_q int8 [L, B, H, cap, D]; k_s/v_s f32
    [L, B, H, cap]; mask at cache granularity -> [B, H, S, D] in q.dtype."""
    build.no_backward("decode_attention_int8", q, k_s, v_s)
    if not q.is_cuda:
        return decode_attention_int8_stacked_plain(q, k_q, k_s, v_q, v_s,
                                                   layer, mask)
    B, H, S, D = q.shape
    L, cap = k_q.shape[0], k_q.shape[3]
    if (tuple(k_q.shape) != (L, B, H, cap, D) or v_q.shape != k_q.shape
            or tuple(k_s.shape) != (L, B, H, cap) or v_s.shape != k_s.shape
            or not 1 <= S <= MAX_S or D not in HEAD_DIMS
            or not 0 <= layer < L):
        raise ValueError(f"decode_attention_int8: q {tuple(q.shape)}, cache "
                         f"{tuple(k_q.shape)}, scales {tuple(k_s.shape)}, "
                         f"layer {layer}")
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or k_q.dtype != torch.int8 or v_q.dtype != torch.int8
            or k_s.dtype != torch.float32 or v_s.dtype != torch.float32):
        raise TypeError("decode_attention_int8: q f32/bf16, int8 cache and "
                        "f32 scales expected")
    for t in (q, k_q, k_s, v_q, v_s):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode_attention_int8: operands must be "
                             "contiguous and on one device")
    if (k_q.data_ptr() | v_q.data_ptr()) % 16:   # 16-byte key-row loads
        raise ValueError("decode_attention_int8: the int8 caches must be "
                         "16-byte aligned")
    slots = B * H * cap                 # of one layer
    out = _launch("bt_decode_attention_int8", q, mask, cap, (
        k_q.data_ptr() + layer * slots * D, k_s.data_ptr() + layer * slots * 4,
        v_q.data_ptr() + layer * slots * D,
        v_s.data_ptr() + layer * slots * 4))
    decode_attention_int8_stacked.launches += 1
    return out


decode_attention_int8_stacked.launches = 0


def decode_attention_int8(q, k_q, k_s, v_q, v_s,
                          mask: masks_lib.AttnMask) -> torch.Tensor:
    """One-layer form: q [B, H, S, D]; k_q/v_q int8 [B, H, cap, D]; k_s/v_s
    f32 [B, H, cap] -> [B, H, S, D]."""
    return decode_attention_int8_stacked(q, k_q[None], k_s[None], v_q[None],
                                         v_s[None], 0, mask)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, q, mask, cap: int, cache_ptrs) -> torch.Tensor:
    """Launch a K2 form's split route over one layer of the cache
    (``cache_ptrs``: the layer's base pointers, as the C entry takes them),
    split as ``plan`` says; returns the output [B, H, S, D]."""
    B, H, S, D = q.shape
    m = mask_args(mask, B, S, cap, q.device)
    out = torch.empty_like(q)
    dev = q.device.index or 0
    p = plan(B, H, cap, build.sm_count(dev))
    stream = build.raw_stream(dev)
    ws = ctr = None
    if p.splits > 1:
        ws, ctr = build.scratch(dev, stream, scratch_floats(p, B, H, S, D),
                                B * H)
        ws, ctr = ws.data_ptr(), ctr.data_ptr()
    fn = _fn(name, len(cache_ptrs) + 7, 9)
    err = fn(q.data_ptr(), *cache_ptrs, m.q_idx.data_ptr(),
             m.kv_idx.data_ptr(), _ptr(m.kv_valid), out.data_ptr(), ws, ctr,
             B, H, S, D, cap, p.splits, p.slots_per_split, m.q_stride,
             int(q.dtype == torch.bfloat16), stream)
    build.check(err, name)
    return out


def _launch_warp(q, mask, cap: int, k_ptr: int, v_ptr: int) -> torch.Tensor:
    """Launch the unquantized form's warp route (cap <= WARP_MAX_CAP) over
    one layer of the cache."""
    B, H, S, D = q.shape
    m = mask_args(mask, B, S, cap, q.device)
    out = torch.empty_like(q)
    dev = q.device.index or 0
    fn = _fn("bt_decode_attention_warp", 7, 7)
    err = fn(q.data_ptr(), k_ptr, v_ptr, m.q_idx.data_ptr(),
             m.kv_idx.data_ptr(), _ptr(m.kv_valid), out.data_ptr(), B, H, S,
             D, cap, m.q_stride, int(q.dtype == torch.bfloat16),
             build.raw_stream(dev))
    build.check(err, "bt_decode_attention_warp")
    return out


def decode_attention_stacked(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, layer: int,
                             mask: masks_lib.AttnMask) -> torch.Tensor:
    """q [B, H, S, D] (S <= 8); k/v [L, B, H, cap, D] bf16 or float32 (on
    the card: of q's dtype); mask at cache granularity -> [B, H, S, D] in
    q.dtype."""
    build.no_backward("decode_attention", q, k, v)
    if not q.is_cuda:
        return decode_attention_stacked_plain(q, k, v, layer, mask)
    B, H, S, D = q.shape
    L, cap = k.shape[0], k.shape[3]
    if (tuple(k.shape) != (L, B, H, cap, D) or v.shape != k.shape
            or not 1 <= S <= MAX_S or D not in HEAD_DIMS
            or not 0 <= layer < L):
        raise ValueError(f"decode_attention_stacked: q {tuple(q.shape)}, "
                         f"cache {tuple(k.shape)}, layer {layer}")
    if (q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"decode_attention_stacked: q and the cache must both "
                        f"be f32 or bf16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode_attention_stacked: operands must be "
                             "contiguous and on one device")
    if (k.data_ptr() | v.data_ptr()) % 16:    # 16-byte key-row loads
        raise ValueError("decode_attention_stacked: the caches must be "
                         "16-byte aligned")
    layer_bytes = B * H * cap * D * k.element_size()
    ptrs = (k.data_ptr() + layer * layer_bytes,
            v.data_ptr() + layer * layer_bytes)
    r = route(cap, S, D, k.dtype)
    if r == "warp":
        out = _launch_warp(q, mask, cap, *ptrs)
    else:
        out = _launch("bt_decode_attention", q, mask, cap, ptrs)
    decode_attention_stacked.launches += 1
    decode_attention_stacked.route_launches[r] += 1
    return out


decode_attention_stacked.launches = 0
decode_attention_stacked.route_launches = {"warp": 0, "split": 0}
