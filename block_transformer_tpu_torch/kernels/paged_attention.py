"""K5-K8: the paged KV pool (replaces the four Pallas kernels of
``block_transformer_tpu/ops/paged_attention.py``).

The pool holds int8 values ``[L, P, H, ps, D]`` (an INT4 pool: uint8
``[L, P, H, ps, D/2]``, two values a byte, split half along D as
``ops.quant.pack_kv_int4`` packs them) and float32 scales ``[L, P, H, ps]``;
``page_table [B, n_virt]`` maps each batch row's virtual
pages to pool pages, and page 0 is the null page (unallocated virtual
pages point there and are masked). The CUDA kernels are in
``csrc/paged_attention.cu``:

- K5 ``paged_write_int8``: one decode step's K/V of one layer into
  ``pool[layer, page[b], :, off[b]]``. The contiguous INT8 cache
  ``[L, B, H, cap, D]`` is such a pool with ``page = arange(B)``.
- K6 ``paged_decode_attention_int8``: decode attention (S <= 8) through the
  page table, optionally with the current step's not-yet-written ``fresh``
  K/V as one extra softmax term (S == 1). One entry serves both pool
  widths, as the Pallas kernel does: the wrapper picks the kernel's INT8
  or packed-INT4 form by the pool's dtype. The kernel splits the
  ``n_virt * ps`` virtual slots over blocks as K2's ``plan`` splits a
  cache (``kernels/decode_attention.py``) and merges the splits in the
  same launch through ``build.scratch``; it skips the tiles of 32 slots
  that no query row may see.
- K7 ``paged_write_layers_int8``: K5 for every layer in one launch.
- K8 ``paged_page_copy_int8``: admission's page-by-page copy of prefilled
  rows into their pool pages. It copies bytes, so it takes a packed INT4
  pool and packed rows as they are.

K5 and K7 take INT8 pools only, as in the JAX package, where the INT4 pool
is written by XLA scatters.

K5 and K7 fused with ``quantize_kv`` (one kernel with three forms): the
decode step's unquantized K and V go in, and one launch quantizes and
writes them, where the JAX package (and ``paged_write_int8`` /
``paged_write_layers_int8`` here, kept with its signatures) takes the
quantized rows from separate ops:

- ``paged_quantize_write_int8``: K5's write of one layer, into a pool or
  the contiguous INT8 cache (``page=None``), at per-row or one int offset.
- ``paged_quantize_step_int8``: the paged engine's deferred write, a
  layer < L - 1: the step buffers and K6's dequantized ``fresh`` pair.
- ``paged_quantize_write_layers_int8``: the same for the last layer, and
  then K7's write of every layer into the pool, in the same launch.

Each returns the result of its plain version bit for bit (the quantization
divides as IEEE does on both devices, ``ops.quant._div``).

The pools are updated **in place**; the write wrappers return the same four
tensors (the Pallas calls alias them through ``input_output_aliases``).
Every plain version and every kernel drops a write whose target is out of
range: in K5 and K7 ``page`` outside ``[0, P)`` or ``off`` outside
``[0, ps)``, in K8 a ``pt_rows`` entry outside ``[0, P)``. (The Pallas index
maps do not check and the JAX reference clamps such a write instead.) The
Pallas kernels' tiling switches (``_pick_tiles``, ``_pick_layer_tile``,
``BT_PAGED_NBT``/``BT_PAGED_NPP``, sub-tile read-modify-writes) have no
counterpart: a CUDA store writes one slot directly.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors; ``<wrapper>.launches`` counts the launches, and
K6's and K8's ``form_launches`` count them by pool width ("int8",
"int4").
"""

from __future__ import annotations

import ctypes
import functools

import torch

from block_transformer_tpu_torch.kernels import build, decode_attention
from block_transformer_tpu_torch.kernels.flash_attention import index_vectors
from block_transformer_tpu_torch.ops import masks as masks_lib
from block_transformer_tpu_torch.ops.attention import attention_xla
from block_transformer_tpu_torch.ops.quant import (kv_bits, quantize_kv,
                                                   unpack_kv_int4)

MAX_S = 8
HEAD_DIMS = (32, 64, 128)
_INT32_MIN = -2 ** 31


@functools.cache
def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.load("paged_attention"), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_pools(what, k_pool, ks_pool, v_pool, vs_pool, *, int4=False):
    """(L, P, H, ps, D) of the pools, D the head dim: int8 values
    [L, P, H, ps, D] or, where ``int4`` allows it, packed uint8
    [L, P, H, ps, D/2]; float32 scales [L, P, H, ps]."""
    L, P, H, ps, row = k_pool.shape
    if (v_pool.shape != k_pool.shape or tuple(ks_pool.shape) != (L, P, H, ps)
            or vs_pool.shape != ks_pool.shape):
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}, scales "
                         f"{tuple(ks_pool.shape)}, {tuple(vs_pool.shape)}")
    widths = (torch.int8, torch.uint8) if int4 else (torch.int8,)
    if (k_pool.dtype not in widths or v_pool.dtype != k_pool.dtype
            or ks_pool.dtype != torch.float32
            or vs_pool.dtype != torch.float32):
        kinds = "int8 or packed uint8" if int4 else "int8"
        raise TypeError(f"{what}: {kinds} pools and float32 scales expected, "
                        f"got {k_pool.dtype}, {v_pool.dtype}")
    return L, P, H, ps, row * 8 // kv_bits(k_pool)


def _check_operands(what, device, tensors):
    for t in tensors:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous and on one "
                             "device")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_int32(what, *tensors):
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: int32 indices expected, got {t.dtype}")


# ---------------------------------------------------------------------------
# K5 / K7: decode-step writes
# ---------------------------------------------------------------------------

def _in_range(page, off, P: int, ps: int):
    return (page >= 0) & (page < P) & (off >= 0) & (off < ps)


def paged_write_int8_plain(k_pool, ks_pool, v_pool, vs_pool, layer: int,
                           page, off, kq, ks, vq, vs):
    """Masked ``index_put_``: rows with an out-of-range target write
    nothing."""
    ok = _in_range(page, off, k_pool.shape[1], k_pool.shape[3])
    pg, of = page[ok].long(), off[ok].long()
    k_pool[layer, pg, :, of] = kq[ok]
    v_pool[layer, pg, :, of] = vq[ok]
    ks_pool[layer, pg, :, of] = ks[ok].to(ks_pool.dtype)
    vs_pool[layer, pg, :, of] = vs[ok].to(vs_pool.dtype)
    return k_pool, ks_pool, v_pool, vs_pool


def paged_write_layers_int8_plain(k_pool, ks_pool, v_pool, vs_pool, page,
                                  off, kq, ks, vq, vs):
    ok = _in_range(page, off, k_pool.shape[1], k_pool.shape[3])
    lidx = torch.arange(k_pool.shape[0], device=page.device)[:, None]
    pg, of = page[ok].long()[None], off[ok].long()[None]
    k_pool[lidx, pg, :, of] = kq[:, ok]
    v_pool[lidx, pg, :, of] = vq[:, ok]
    ks_pool[lidx, pg, :, of] = ks[:, ok].to(ks_pool.dtype)
    vs_pool[lidx, pg, :, of] = vs[:, ok].to(vs_pool.dtype)
    return k_pool, ks_pool, v_pool, vs_pool


def _launch_write(what, pools, page, off, kq, ks, vq, vs, layers: int):
    """pools: the four pool tensors, or the layer views of them (K5)."""
    k_pool, ks_pool, v_pool, vs_pool = pools
    B = page.shape[0]
    H, ps, D = k_pool.shape[-3], k_pool.shape[-2], k_pool.shape[-1]
    P = k_pool.shape[-4]
    vec = int(D % 16 == 0 and _aligned(k_pool, v_pool, kq, vq))
    err = _fn("bt_paged_write_int8", 10, 7)(
        build.ptr(k_pool), build.ptr(ks_pool), build.ptr(v_pool),
        build.ptr(vs_pool), build.ptr(page), build.ptr(off), build.ptr(kq),
        build.ptr(ks), build.ptr(vq), build.ptr(vs), layers, B, P, H, ps, D,
        vec, build.stream(kq.device))
    build.check(err, what)


def paged_write_int8(k_pool: torch.Tensor, ks_pool: torch.Tensor,
                     v_pool: torch.Tensor, vs_pool: torch.Tensor, layer: int,
                     page: torch.Tensor, off: torch.Tensor, kq: torch.Tensor,
                     ks: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor):
    """One decode step's K/V into layer ``layer`` of the pool, in place.

    Pools int8 [L, P, H, ps, D] / f32 [L, P, H, ps]; page/off int32 [B];
    kq/vq int8 [B, H, D]; ks/vs f32 [B, H]. Returns the four pools."""
    build.no_backward("paged_write_int8", ks_pool, vs_pool, ks, vs)
    if not kq.is_cuda:
        return paged_write_int8_plain(k_pool, ks_pool, v_pool, vs_pool, layer,
                                      page, off, kq, ks, vq, vs)
    L, P, H, ps, D = _check_pools("paged_write_int8", k_pool, ks_pool, v_pool,
                                  vs_pool)
    B = page.shape[0]
    if (tuple(kq.shape) != (B, H, D) or vq.shape != kq.shape
            or tuple(ks.shape) != (B, H) or vs.shape != ks.shape
            or tuple(off.shape) != (B,) or not 0 <= layer < L):
        raise ValueError(f"paged_write_int8: kq {tuple(kq.shape)}, ks "
                         f"{tuple(ks.shape)}, page {tuple(page.shape)}, off "
                         f"{tuple(off.shape)}, pool {tuple(k_pool.shape)}, "
                         f"layer {layer}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 or (
            ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise TypeError("paged_write_int8: int8 values and f32 scales expected")
    _check_int32("paged_write_int8", page, off)
    _check_operands("paged_write_int8", kq.device,
                    (k_pool, ks_pool, v_pool, vs_pool, page, off, kq, ks, vq,
                     vs))
    _launch_write("paged_write_int8",
                  (k_pool[layer], ks_pool[layer], v_pool[layer],
                   vs_pool[layer]), page, off, kq, ks, vq, vs, 1)
    paged_write_int8.launches += 1
    return k_pool, ks_pool, v_pool, vs_pool


paged_write_int8.launches = 0


def paged_write_layers_int8(k_pool: torch.Tensor, ks_pool: torch.Tensor,
                            v_pool: torch.Tensor, vs_pool: torch.Tensor,
                            page: torch.Tensor, off: torch.Tensor,
                            kq: torch.Tensor, ks: torch.Tensor,
                            vq: torch.Tensor, vs: torch.Tensor):
    """One decode step's K/V for ALL layers into the pool, in place: every
    layer of row b goes to ``(page[b], off[b])``.

    kq/vq int8 [L, B, H, D]; ks/vs f32 [L, B, H]; page/off int32 [B].
    Returns the four pools."""
    build.no_backward("paged_write_layers_int8", ks_pool, vs_pool, ks, vs)
    if not kq.is_cuda:
        return paged_write_layers_int8_plain(k_pool, ks_pool, v_pool, vs_pool,
                                             page, off, kq, ks, vq, vs)
    L, P, H, ps, D = _check_pools("paged_write_layers_int8", k_pool, ks_pool,
                                  v_pool, vs_pool)
    B = page.shape[0]
    if (tuple(kq.shape) != (L, B, H, D) or vq.shape != kq.shape
            or tuple(ks.shape) != (L, B, H) or vs.shape != ks.shape
            or tuple(off.shape) != (B,)):
        raise ValueError(f"paged_write_layers_int8: kq {tuple(kq.shape)}, ks "
                         f"{tuple(ks.shape)}, page {tuple(page.shape)}, pool "
                         f"{tuple(k_pool.shape)}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 or (
            ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise TypeError("paged_write_layers_int8: int8 values and f32 scales "
                        "expected")
    _check_int32("paged_write_layers_int8", page, off)
    _check_operands("paged_write_layers_int8", kq.device,
                    (k_pool, ks_pool, v_pool, vs_pool, page, off, kq, ks, vq,
                     vs))
    _launch_write("paged_write_layers_int8", (k_pool, ks_pool, v_pool,
                                              vs_pool),
                  page, off, kq, ks, vq, vs, L)
    paged_write_layers_int8.launches += 1
    return k_pool, ks_pool, v_pool, vs_pool


paged_write_layers_int8.launches = 0


# ---------------------------------------------------------------------------
# K5 / K7 fused with the INT8 KV quantization
# ---------------------------------------------------------------------------

_QW_POOL, _QW_STEP, _QW_STEP_LAYERS = 0, 1, 2
_QW_MAX_D = 256


def _quantize_rows(k, v):
    """quantize_kv of two [B, H, D] step rows: (kq, ks, vq, vs)."""
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return kq, ks, vq, vs


def _dequantized(q, s):
    """The fresh term K6 takes: q * scale in float32 [B, H, D]."""
    return q.float() * s[..., None]


def paged_quantize_write_int8_plain(k_pool, ks_pool, v_pool, vs_pool,
                                    layer: int, page, off, k, v):
    """``quantize_kv`` of k and v, then ``paged_write_int8_plain``; ``page``
    None is the identity table, an int ``off`` one offset for every row."""
    B = k.shape[0]
    if page is None:
        page = torch.arange(B, dtype=torch.int32, device=k.device)
    if isinstance(off, int):
        off = torch.full((B,), off, dtype=torch.int32, device=k.device)
    return paged_write_int8_plain(k_pool, ks_pool, v_pool, vs_pool, layer,
                                  page, off, *_quantize_rows(k, v))


def paged_quantize_step_int8_plain(step_q, step_s, layer: int, k, v):
    """``quantize_kv`` of k and v into ``step_q[:, layer]`` and ``step_s[:,
    layer]``; returns the dequantized pair (kf, vf)."""
    kq, ks, vq, vs = _quantize_rows(k, v)
    step_q[0, layer], step_s[0, layer] = kq, ks
    step_q[1, layer], step_s[1, layer] = vq, vs
    return _dequantized(kq, ks), _dequantized(vq, vs)


def paged_quantize_write_layers_int8_plain(k_pool, ks_pool, v_pool, vs_pool,
                                           page, off, step_q, step_s, k, v):
    """The last layer's ``paged_quantize_step_int8_plain``, then
    ``paged_write_layers_int8_plain`` of every layer's step rows; returns
    the last layer's (kf, vf)."""
    fresh = paged_quantize_step_int8_plain(step_q, step_s,
                                           step_q.shape[1] - 1, k, v)
    paged_write_layers_int8_plain(k_pool, ks_pool, v_pool, vs_pool, page, off,
                                  step_q[0], step_s[0], step_q[1], step_s[1])
    return fresh


def _check_rows(what, k, v, B, H, D):
    """k and v [B, H, D] of one float type on one device, the last dim
    contiguous."""
    if (tuple(k.shape) != (B, H, D) or tuple(v.shape) != (B, H, D)
            or D > _QW_MAX_D):
        raise ValueError(f"{what}: k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"expected [{B}, {H}, {D}] with D <= {_QW_MAX_D}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"{what}: float32 or bf16 k and v expected, got "
                        f"{k.dtype}, {v.dtype}")
    if k.stride(-1) != 1 or v.stride(-1) != 1 or v.device != k.device:
        raise ValueError(f"{what}: k and v must be on one device, their "
                         "last dim contiguous")


def _check_steps(what, step_q, step_s, B, H, D):
    """L of the step buffers step_q int8 [2, L, B, H, D] and step_s f32
    [2, L, B, H]."""
    L = step_q.shape[1]
    if (tuple(step_q.shape) != (2, L, B, H, D)
            or tuple(step_s.shape) != (2, L, B, H)):
        raise ValueError(f"{what}: step buffers {tuple(step_q.shape)}, "
                         f"{tuple(step_s.shape)} for k [{B}, {H}, {D}]")
    if step_q.dtype != torch.int8 or step_s.dtype != torch.float32:
        raise TypeError(f"{what}: int8 step values and f32 step scales "
                        "expected")
    return L


def _launch_quantize_write(what, mode, k, v, *, pools=(None,) * 4,
                           page=None, off=0, steps=(None, None), fresh=None,
                           P=0, ps=0, L=1, layer=0):
    B, H, D = k.shape
    # the kernel's vector form: D / 32 elements a lane, rows aligned to them
    epl = D // 32 if D in HEAD_DIMS else 0
    esize = k.element_size()
    rows_ok = epl > 0 and all(
        t.data_ptr() % (epl * esize) == 0 and t.stride(0) % epl == 0
        and t.stride(1) % epl == 0 for t in (k, v))
    others_ok = _aligned(*(t for t in (*pools, *steps, *(fresh or ()))
                           if t is not None))
    vec = int(rows_ok and others_ok)
    copy16 = int(D % 16 == 0 and others_ok)
    tensor_off = torch.is_tensor(off)
    kf, vf = fresh or (None, None)
    err = _fn("bt_paged_quantize_write_int8", 12, 16)(
        k.data_ptr(), v.data_ptr(),
        *(None if t is None else t.data_ptr() for t in pools),
        None if page is None else page.data_ptr(),
        off.data_ptr() if tensor_off else None,
        *(None if t is None else t.data_ptr() for t in steps),
        None if kf is None else kf.data_ptr(),
        None if vf is None else vf.data_ptr(),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        0 if tensor_off else off, mode, B, H, D, P, ps, L, layer,
        int(k.dtype == torch.bfloat16), vec, copy16,
        build.raw_stream(k.device.index or 0))
    build.check(err, what)


def paged_quantize_write_int8(k_pool: torch.Tensor, ks_pool: torch.Tensor,
                              v_pool: torch.Tensor, vs_pool: torch.Tensor,
                              layer: int, page, off, k: torch.Tensor,
                              v: torch.Tensor):
    """K5 fused with ``quantize_kv``: one decode step's k and v [B, H, D]
    (float32 or bf16, strided, the last dim contiguous) quantized per row
    and written into layer ``layer`` of the pool at ``(page[b], off[b])``,
    in place, in one launch. Pools int8 [L, P, H, ps, D] / f32
    [L, P, H, ps]; ``page`` int32 [B], or None for the contiguous cache
    [L, B, H, cap, D] (row b on page b); ``off`` int32 [B], or one Python
    int for every row. Out-of-range targets are dropped, as in K5. Returns
    the four pools."""
    build.no_backward("paged_quantize_write_int8", k, v)
    if not k.is_cuda:
        return paged_quantize_write_int8_plain(k_pool, ks_pool, v_pool,
                                               vs_pool, layer, page, off, k, v)
    what = "paged_quantize_write_int8"
    L, P, H, ps, D = _check_pools(what, k_pool, ks_pool, v_pool, vs_pool)
    B = k.shape[0]
    _check_rows(what, k, v, B, H, D)
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} of {L}")
    indices = [t for t in (page, off) if torch.is_tensor(t)]
    for t in indices:
        if tuple(t.shape) != (B,):
            raise ValueError(f"{what}: page/off {tuple(t.shape)}, expected "
                             f"[{B}]")
    if page is not None and not torch.is_tensor(page):
        raise TypeError(f"{what}: page must be an int32 tensor or None")
    if not torch.is_tensor(off) and not isinstance(off, int):
        raise TypeError(f"{what}: off must be an int32 tensor or an int")
    _check_int32(what, *indices)
    _check_operands(what, k.device,
                    (k_pool, ks_pool, v_pool, vs_pool, *indices))
    _launch_quantize_write(what, _QW_POOL, k, v,
                           pools=(k_pool, ks_pool, v_pool, vs_pool),
                           page=page, off=off, P=P, ps=ps, L=L, layer=layer)
    paged_quantize_write_int8.launches += 1
    return k_pool, ks_pool, v_pool, vs_pool


paged_quantize_write_int8.launches = 0


def paged_quantize_step_int8(step_q: torch.Tensor, step_s: torch.Tensor,
                             layer: int, k: torch.Tensor, v: torch.Tensor):
    """K7's feed, fused with ``quantize_kv``: layer ``layer``'s k and v
    [B, H, D] quantized into the step buffers ``step_q`` int8 [2, L, B, H,
    D] and ``step_s`` f32 [2, L, B, H] (K at index 0, V at 1), in one
    launch. Returns the dequantized pair (kf, vf) f32 [B, H, D], K6's
    ``fresh`` term."""
    build.no_backward("paged_quantize_step_int8", k, v)
    if not k.is_cuda:
        return paged_quantize_step_int8_plain(step_q, step_s, layer, k, v)
    what = "paged_quantize_step_int8"
    B, H, D = k.shape
    _check_rows(what, k, v, B, H, D)
    L = _check_steps(what, step_q, step_s, B, H, D)
    if not 0 <= layer < L:
        raise ValueError(f"{what}: layer {layer} of {L}")
    _check_operands(what, k.device, (step_q, step_s))
    fresh = (torch.empty((B, H, D), dtype=torch.float32, device=k.device),
             torch.empty((B, H, D), dtype=torch.float32, device=k.device))
    _launch_quantize_write(what, _QW_STEP, k, v, steps=(step_q, step_s),
                           fresh=fresh, L=L, layer=layer)
    paged_quantize_step_int8.launches += 1
    return fresh


paged_quantize_step_int8.launches = 0


def paged_quantize_write_layers_int8(k_pool: torch.Tensor,
                                     ks_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     vs_pool: torch.Tensor,
                                     page: torch.Tensor, off: torch.Tensor,
                                     step_q: torch.Tensor,
                                     step_s: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor):
    """K7 carried by the last layer: ``paged_quantize_step_int8`` of layer
    L - 1, then every layer's step rows into the pool at ``(page[b],
    off[b])``, in place, in one launch (pools as K7's; page/off int32 [B];
    out-of-range targets dropped). Returns the last layer's (kf, vf).

    Call it after the K6 launches of layers < L - 1 and before layer
    L - 1's, which masks the frontier slot and reads (kf, vf) instead:
    that K6 then reads nothing this launch changed."""
    build.no_backward("paged_quantize_write_layers_int8", k, v)
    if not k.is_cuda:
        return paged_quantize_write_layers_int8_plain(
            k_pool, ks_pool, v_pool, vs_pool, page, off, step_q, step_s, k, v)
    what = "paged_quantize_write_layers_int8"
    L, P, H, ps, D = _check_pools(what, k_pool, ks_pool, v_pool, vs_pool)
    B = k.shape[0]
    _check_rows(what, k, v, B, H, D)
    if (_check_steps(what, step_q, step_s, B, H, D) != L
            or tuple(page.shape) != (B,) or tuple(off.shape) != (B,)):
        raise ValueError(f"{what}: step buffers {tuple(step_q.shape)}, page "
                         f"{tuple(page.shape)}, off {tuple(off.shape)}, pool "
                         f"{tuple(k_pool.shape)}")
    _check_int32(what, page, off)
    _check_operands(what, k.device, (k_pool, ks_pool, v_pool, vs_pool, page,
                                     off, step_q, step_s))
    fresh = (torch.empty((B, H, D), dtype=torch.float32, device=k.device),
             torch.empty((B, H, D), dtype=torch.float32, device=k.device))
    _launch_quantize_write(what, _QW_STEP_LAYERS, k, v,
                           pools=(k_pool, ks_pool, v_pool, vs_pool),
                           page=page, off=off, steps=(step_q, step_s),
                           fresh=fresh, P=P, ps=ps, L=L, layer=L - 1)
    paged_quantize_write_layers_int8.launches += 1
    return fresh


paged_quantize_write_layers_int8.launches = 0


# ---------------------------------------------------------------------------
# K6: decode attention through the page table
# ---------------------------------------------------------------------------

def _fresh_pair(fresh, S: int):
    if fresh is None:
        return None
    if S != 1:
        raise ValueError(f"fresh requires S == 1, got S={S}")
    return tuple(fresh)


def paged_decode_attention_int8_plain(q, k_q, k_s, v_q, v_s, layer: int,
                                      page_table, mask: masks_lib.AttnMask, *,
                                      fresh=None):
    """Gather the rows' pages into [B, H, n_virt * ps, D], dequantize, append
    the fresh key/value as one always-allowed column, ``attention_xla``. A
    packed INT4 pool is unpacked first (the layer's pages only)."""
    if kv_bits(k_q) == 4:
        sl = slice(layer, layer + 1)
        return paged_decode_attention_int8_plain(
            q, unpack_kv_int4(k_q[sl]), k_s[sl], unpack_kv_int4(v_q[sl]),
            v_s[sl], 0, page_table, mask, fresh=fresh)
    B, H, S, D = q.shape
    n_virt, ps = page_table.shape[1], k_q.shape[3]
    fresh = _fresh_pair(fresh, S)
    pt = page_table.long()

    def gather(pool, scale):
        x = pool[layer][pt].float() * scale[layer][pt][..., None]
        return x.permute(0, 2, 1, 3, 4).reshape(B, H, n_virt * ps, D).to(
            q.dtype)

    k, v = gather(k_q, k_s), gather(v_q, v_s)
    q_idx, kv_idx, kv_valid = index_vectors(mask, B, S, n_virt * ps, q.device)
    if fresh is not None:
        kf, vf = fresh
        k = torch.cat([k, kf[:, :, None].to(q.dtype)], dim=2)
        v = torch.cat([v, vf[:, :, None].to(q.dtype)], dim=2)
        kv_idx = torch.cat([kv_idx, kv_idx.new_full((1,), _INT32_MIN)])
        kv_valid = torch.cat([kv_valid, kv_valid.new_ones((B, 1))], dim=1)
    return attention_xla(q, k, v, masks_lib.AttnMask(q_idx, kv_idx, kv_valid))


def paged_decode_attention_int8(q: torch.Tensor, k_q: torch.Tensor,
                                k_s: torch.Tensor, v_q: torch.Tensor,
                                v_s: torch.Tensor, layer: int,
                                page_table: torch.Tensor,
                                mask: masks_lib.AttnMask, *,
                                fresh=None) -> torch.Tensor:
    """q [B, H, S, D] (S <= 8); pools int8 [L, P, H, ps, D] or packed
    uint8 [L, P, H, ps, D/2], and f32 [L, P, H, ps]; page_table int32
    [B, n_virt]; mask at the virtual
    positions ([B, n_virt * ps]); fresh: None, or the current step's
    dequantized (kf, vf) f32 [B, H, D] (S == 1; the caller passes
    ``mask.q_idx - 1``). Returns [B, H, S, D] in q.dtype."""
    build.no_backward("paged_decode_attention_int8", q, k_s, v_s,
                      *(fresh or ()))
    if not q.is_cuda:
        return paged_decode_attention_int8_plain(q, k_q, k_s, v_q, v_s, layer,
                                                 page_table, mask, fresh=fresh)
    B, H, S, D = q.shape
    L, P, H2, ps, D2 = _check_pools("paged_decode_attention_int8", k_q, k_s,
                                    v_q, v_s, int4=True)
    n_virt = page_table.shape[1]
    if ((H2, D2) != (H, D) or tuple(page_table.shape) != (B, n_virt)
            or not 1 <= S <= MAX_S or D not in HEAD_DIMS
            or not 0 <= layer < L):
        raise ValueError(f"paged_decode_attention_int8: q {tuple(q.shape)}, "
                         f"pool {tuple(k_q.shape)}, page_table "
                         f"{tuple(page_table.shape)}, layer {layer}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_decode_attention_int8: q dtype {q.dtype}")
    _check_int32("paged_decode_attention_int8", page_table)
    fresh = _fresh_pair(fresh, S)
    operands = [q, k_q, k_s, v_q, v_s, page_table]
    if fresh is not None:
        kf, vf = fresh
        if (tuple(kf.shape) != (B, H, D) or vf.shape != kf.shape
                or kf.dtype != torch.float32 or vf.dtype != torch.float32):
            raise ValueError("paged_decode_attention_int8: fresh must be f32 "
                             f"[B, H, D], got {tuple(kf.shape)} {kf.dtype}")
        operands += [kf, vf]
    _check_operands("paged_decode_attention_int8", q.device, operands)
    if not _aligned(k_q, v_q):
        raise ValueError("paged_decode_attention_int8: pools must be 16-byte "
                         "aligned")
    if P * H * ps >= 2 ** 32:
        raise ValueError("paged_decode_attention_int8: the kernel indexes a "
                         f"layer's slots in 32 bits, pool {tuple(k_q.shape)}")
    K = n_virt * ps
    q_idx, kv_idx, kv_valid = index_vectors(mask, B, S, K, q.device)
    out = torch.empty_like(q)
    dev = q.device.index or 0
    p = decode_attention.plan(B, H, K, build.sm_count(dev))
    stream = build.raw_stream(dev)
    ws = ctr = None
    if p.splits > 1:
        ws, ctr = build.scratch(dev, stream, decode_attention.scratch_floats(
            p, B, H, S, D), B * H)
        ws, ctr = ws.data_ptr(), ctr.data_ptr()
    kf, vf = (t.data_ptr() for t in fresh) if fresh else (None, None)
    err = _fn("bt_paged_decode_attention_int8", 14, 11)(
        q.data_ptr(), k_q[layer].data_ptr(), k_s[layer].data_ptr(),
        v_q[layer].data_ptr(), v_s[layer].data_ptr(), page_table.data_ptr(),
        q_idx.data_ptr(), kv_idx.data_ptr(), kv_valid.data_ptr(), kf, vf,
        out.data_ptr(), ws, ctr, B, H, S, D, P, ps, n_virt, p.splits,
        p.slots_per_split, int(q.dtype == torch.bfloat16),
        int(kv_bits(k_q) == 4), stream)
    build.check(err, "paged_decode_attention_int8")
    paged_decode_attention_int8.launches += 1
    paged_decode_attention_int8.form_launches[f"int{kv_bits(k_q)}"] += 1
    return out


paged_decode_attention_int8.launches = 0
paged_decode_attention_int8.form_launches = {"int8": 0, "int4": 0}


# ---------------------------------------------------------------------------
# K8: admission page copy
# ---------------------------------------------------------------------------

def _pages(rows, nv: int):
    """[L, G, H, nv * ps(, D)] -> [L, G, nv, H, ps(, D)]."""
    L, G, H, cap = rows.shape[:4]
    x = rows.reshape(L, G, H, nv, cap // nv, *rows.shape[4:])
    return x.transpose(2, 3)


def paged_page_copy_int8_plain(k_pool, ks_pool, v_pool, vs_pool, pt_rows,
                               row_k, row_ks, row_v, row_vs):
    """``pool[:, pt_rows] = rows`` cut into pages, dropping out-of-range
    entries of ``pt_rows``."""
    nv = pt_rows.shape[1]
    ok = (pt_rows >= 0) & (pt_rows < k_pool.shape[1])
    idx = pt_rows[ok].long()
    for pool, rows in ((k_pool, row_k), (ks_pool, row_ks), (v_pool, row_v),
                       (vs_pool, row_vs)):
        pool[:, idx] = _pages(rows, nv)[:, ok].to(pool.dtype)
    return k_pool, ks_pool, v_pool, vs_pool


def paged_page_copy_int8(k_pool: torch.Tensor, ks_pool: torch.Tensor,
                         v_pool: torch.Tensor, vs_pool: torch.Tensor,
                         pt_rows: torch.Tensor, row_k: torch.Tensor,
                         row_ks: torch.Tensor, row_v: torch.Tensor,
                         row_vs: torch.Tensor):
    """Copy G prefilled rows (int8 [L, G, H, nv * ps, D] + f32
    [L, G, H, nv * ps]) page by page into ``pool[:, pt_rows[g, j]]``, in
    place. pt_rows int32 [G, nv]. Packed INT4 rows (uint8 [..., D/2]) go
    into a packed pool byte for byte. Returns the four pools."""
    build.no_backward("paged_page_copy_int8", ks_pool, vs_pool, row_ks,
                      row_vs)
    if not k_pool.is_cuda:
        return paged_page_copy_int8_plain(k_pool, ks_pool, v_pool, vs_pool,
                                          pt_rows, row_k, row_ks, row_v,
                                          row_vs)
    L, P, H, ps, _ = _check_pools("paged_page_copy_int8", k_pool, ks_pool,
                                  v_pool, vs_pool, int4=True)
    row = k_pool.shape[-1]              # bytes of a slot's values
    G, nv = pt_rows.shape
    if (tuple(row_k.shape) != (L, G, H, nv * ps, row)
            or row_v.shape != row_k.shape
            or tuple(row_ks.shape) != (L, G, H, nv * ps)
            or row_vs.shape != row_ks.shape):
        raise ValueError(f"paged_page_copy_int8: rows {tuple(row_k.shape)}, "
                         f"{tuple(row_ks.shape)}, pt_rows "
                         f"{tuple(pt_rows.shape)}, pool {tuple(k_pool.shape)}")
    if row_k.dtype != k_pool.dtype or row_v.dtype != k_pool.dtype or (
            row_ks.dtype != torch.float32 or row_vs.dtype != torch.float32):
        raise TypeError("paged_page_copy_int8: rows of the pool's dtype and "
                        "f32 scales expected")
    _check_int32("paged_page_copy_int8", pt_rows)
    _check_operands("paged_page_copy_int8", k_pool.device,
                    (k_pool, ks_pool, v_pool, vs_pool, pt_rows, row_k, row_ks,
                     row_v, row_vs))
    vec = int((ps * row) % 16 == 0
              and _aligned(k_pool, v_pool, row_k, row_v))
    err = _fn("bt_paged_page_copy_int8", 9, 8)(
        build.ptr(k_pool), build.ptr(ks_pool), build.ptr(v_pool),
        build.ptr(vs_pool), build.ptr(pt_rows), build.ptr(row_k),
        build.ptr(row_ks), build.ptr(row_v), build.ptr(row_vs),
        L, G, nv, P, H, ps, row, vec, build.stream(k_pool.device))
    build.check(err, "paged_page_copy_int8")
    paged_page_copy_int8.launches += 1
    paged_page_copy_int8.form_launches[f"int{kv_bits(k_pool)}"] += 1
    return k_pool, ks_pool, v_pool, vs_pool


paged_page_copy_int8.launches = 0
paged_page_copy_int8.form_launches = {"int8": 0, "int4": 0}
