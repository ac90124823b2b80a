"""K1 and K4: INT8 and INT4 weight-only dequant-matmuls (replace the Pallas
kernels of ``block_transformer_tpu/ops/dequant_matmul.py``:
``int8_matmul_stacked`` / ``int8_matmul`` and ``int4_matmul_stacked`` /
``int4_matmul``).

K1: ``out[M, N] = cast_x((x[M, K] @ float(w_q[layer])) * scale[layer])``.
K4: ``out = cast_x(x[:, :K/2] @ (lo * s_lo) + x[:, K/2:] @ (hi * s_hi))``
on split-half packed nibbles (``ops/quant.py``) with group-wise scales.
Both accumulate in float32. The weights are the whole stacked ``[L, ...]``
array and ``layer`` a Python int: the CUDA kernels
(``csrc/dequant_matmul.cu``) get the layer's base pointer, so no weight
slice is ever copied.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors, raising on input the kernel does not take. Which
kernel is one pure function of the shapes, ``plan``: with K (K1) or K/2 (K4)
a multiple of 32, N a multiple of 16 and 16-byte aligned operands (every
main-path shape), bf16 x takes the bf16 tensor cores (``"tc"``) and float32
x the TF32 tensor cores in two passes (``"tf32x2"``; K4 also needs groups of
a multiple of 32 rows, or G = 1); everything else takes the CUDA cores
(``"fma"``). ``int8_matmul_stacked.launches`` and
``int4_matmul_stacked.launches`` count the launches, and each wrapper's
``route_launches`` dict counts them by route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from block_transformer_tpu_torch.kernels import build
from block_transformer_tpu_torch.ops import quant


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version: dequantize, float32 matmul, scale, cast to x.dtype."""
    return (torch.matmul(x.float(), w_q.float()) * scale).to(x.dtype)


def int8_matmul_stacked_plain(x, w_q, scale, layer: int) -> torch.Tensor:
    return int8_matmul_plain(x, w_q[layer], scale[layer])


@functools.cache
def _fn(name: str, n_ints: int):
    fn = getattr(build.load("dequant_matmul"), name)
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class Plan(NamedTuple):
    """How one dequant-matmul launches: ``route`` "tc" (bf16 tensor cores),
    "tf32x2" (TF32 tensor cores, two passes) or "fma" (CUDA cores), ``tile``
    (BM, BN, BK) of its output tile and K step, K split over ``splits``
    blocks of ``k_per_split`` rows (K1) or packed rows (K4) each."""
    route: str
    tile: tuple
    splits: int
    k_per_split: int


# the C entries' route codes
ROUTE_CODES = {"fma": 0, "tc": 1, "tf32x2": 2}
_TC_BK = 32                # K step of the tensor-core tiles
_TC_ALIGN = 16             # bytes of one cp.async copy
_FMA_BN, _FMA_BK = 64, 32  # tile of the CUDA-core kernels


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, dtype, sms: int, aligned: bool = True,
         group: int = 0) -> Plan:
    """The launch of ``x [M, .] @ w [K, N]`` on a card with ``sms`` SMs; K
    is the weight's row count (K1) or packed row count K/2 (K4), ``aligned``
    whether every operand's base pointer is 16-byte aligned, ``group`` K4's
    rows a scale group (0 for K1).

    With K a multiple of 32, N of 16 and aligned operands, bf16 x takes the
    bf16 tensor cores ("tc") and float32 x the TF32 ones ("tf32x2"; K4 only
    with ``group`` a multiple of 32); both with a 16-row tile at decode (M
    <= 16), 64 rows up to M = 64 and 128 beyond, 128 columns, 32-row steps.
    Anything else takes the CUDA cores (``fma_plan``). Either way K is split
    over blocks when the output has too few tiles for two blocks per SM: on
    the tensor cores in whole 32-row steps, at least two blocks per SM at
    decode (an SM holds three of its blocks) and at most two for the larger
    tiles, so that no launch runs in a second, mostly empty wave."""
    route = {torch.bfloat16: "tc", torch.float32: "tf32x2"}.get(dtype)
    if (route is None or not aligned or K % _TC_BK or N % _TC_ALIGN
            or (route == "tf32x2" and group % _TC_BK)):
        return fma_plan(M, K, N, sms)
    bm = 16 if M <= 16 else 64 if M <= 64 else 128
    tile = (bm, 128, _TC_BK)
    tiles = -(-N // tile[1]) * -(-M // bm)
    steps = K // _TC_BK
    if bm == 16:
        want = -(-2 * sms // tiles)
        per_split = max(1, steps // want)               # splits >= want
    else:
        want = max(1, 2 * sms // tiles)
        per_split = -(-steps // want)                   # splits <= want
    kps = per_split * _TC_BK
    return Plan(route, tile, -(-K // kps), kps)


def fma_plan(M: int, K: int, N: int, sms: int) -> Plan:
    """The CUDA-core route's launch: BM x 64 tiles (16 rows at decode, else
    64), K split into 32-row multiples of at least 256 rows each while
    there are fewer than two blocks per SM."""
    bm = 16 if M <= 16 else 64
    tiles = -(-N // _FMA_BN) * -(-M // bm)
    want = -(-2 * sms // tiles)
    splits = max(1, min(want, K // 256))               # splits >= 256 deep
    kps = -(-(-(-K // splits)) // _FMA_BK) * _FMA_BK
    return Plan("fma", (bm, _FMA_BN, _FMA_BK), -(-K // kps), kps)


def workspace_floats(p: Plan, M: int, N: int) -> int:
    """float32 partial sums the split-K reduce needs (0 without a split)."""
    return p.splits * M * N if p.splits > 1 else 0


def tile_count(p: Plan, M: int, N: int) -> int:
    """Output tiles of the launch: the tensor-core route's split-K arrival
    counters, one int32 each."""
    return -(-N // p.tile[1]) * -(-M // p.tile[0])


def _together(*ts) -> bool:
    """All contiguous and on the device of the first (device indices are
    cheaper to compare than ``torch.device`` objects)."""
    dev = ts[0].get_device()
    return all(t.get_device() == dev and t.is_contiguous() for t in ts)


def _launch(name: str, fn, x, w, scale, layer: int, out, ints,
            group: int = 0) -> None:
    """Plan, launch ``bt_<name>`` on layer ``layer`` of the stacked ``w`` and
    ``scale`` (by base pointer: no view is made) on the current stream, and
    count it."""
    M, N = out.shape
    K = w.shape[1]
    ptrs = layer_pointers(x, w, scale, layer, out)
    aligned = not any(q % _TC_ALIGN for q in ptrs)
    dev = x.device.index or 0
    p = plan(M, K, N, x.dtype, build.sm_count(dev), aligned, group)
    launch_plan(name, p, ptrs, M, ints, x.dtype, dev)
    fn.launches += 1
    fn.route_launches[p.route] += 1


def layer_pointers(x, w, scale, layer: int, out) -> tuple:
    """(x, layer ``layer`` of w, its scales, out) as device addresses."""
    K, N = w.shape[1:]
    return (x.data_ptr(), w.data_ptr() + layer * K * N,   # int8: 1 byte
            scale.data_ptr() + layer * (scale.numel() // scale.shape[0]) * 4,
            out.data_ptr())


def launch_plan(name: str, p: Plan, ptrs, M: int, ints, dtype,
                dev: int) -> None:
    """Launch ``bt_<name>`` by plan ``p`` (its route code, tile and split)
    on the current stream, with split-K scratch when it splits; counts
    nothing."""
    stream = build.raw_stream(dev)
    ws = ctr = None
    if p.splits > 1:
        N = ints[1]                       # ints: (K, N) or (Kh, N, gs)
        ws, ctr = build.scratch(dev, stream, workspace_floats(p, M, N),
                               tile_count(p, M, N))
        ws, ctr = ws.data_ptr(), ctr.data_ptr()
    err = _fn(f"bt_{name}", len(ints) + 6)(
        *ptrs, ws, ctr, M, *ints, p.splits, p.k_per_split,
        int(dtype == torch.bfloat16), ROUTE_CODES[p.route], p.tile[0], stream)
    build.check(err, name)


def int8_matmul_stacked(x: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor, layer: int) -> torch.Tensor:
    """x [M, K] (f32/bf16); w_q int8 [L, K, N]; scale f32 [L, N] -> [M, N]."""
    build.no_backward("int8_matmul", x, w_q, scale)
    if not x.is_cuda:
        return int8_matmul_stacked_plain(x, w_q, scale, layer)
    M, K = x.shape
    L, K2, N = w_q.shape
    if K != K2 or tuple(scale.shape) != (L, N) or not 0 <= layer < L:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}, "
                         f"layer {layer}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_matmul: x dtype {x.dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul: w_q {w_q.dtype}, scale {scale.dtype}")
    if not _together(x, w_q, scale):
        raise ValueError("int8_matmul: operands must be contiguous and "
                         "on one device")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    _launch("int8_matmul", int8_matmul_stacked, x, w_q, scale, layer, out,
            (K, N))
    return out


int8_matmul_stacked.launches = 0
int8_matmul_stacked.route_launches = dict.fromkeys(ROUTE_CODES, 0)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K]; w_q int8 [K, N]; scale f32 [N] -> [M, N] (one-layer form)."""
    return int8_matmul_stacked(x, w_q[None], scale[None], 0)


def int4_matmul_plain(x: torch.Tensor, w_p: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version: dequantize (scale [G, N] or [N]), float32 matmul, cast
    to x.dtype."""
    w = quant.dequantize_int4(w_p, scale, torch.float32)
    return torch.matmul(x.float(), w).to(x.dtype)


def int4_matmul_stacked_plain(x, w_p, scale, layer: int) -> torch.Tensor:
    return int4_matmul_plain(x, w_p[layer], scale[layer])


def int4_matmul_stacked(x: torch.Tensor, w_p: torch.Tensor,
                        scale: torch.Tensor, layer: int) -> torch.Tensor:
    """x [M, K] (f32/bf16); w_p int8 [L, K/2, N] split-half packed; scale
    f32 [L, G, N] group-wise or [L, N] per-channel -> [M, N]. A group may
    not straddle the two halves: G == 1, or K/G divides K/2."""
    build.no_backward("int4_matmul", x, w_p, scale)
    if not x.is_cuda:
        return int4_matmul_stacked_plain(x, w_p, scale, layer)
    M, K = x.shape
    L, Kh, N = w_p.shape
    s = scale if scale.dim() == 3 else scale[:, None]
    G = s.shape[1]
    if (K != 2 * Kh or tuple(s.shape) != (L, G, N) or G < 1 or K % G
            or not 0 <= layer < L):
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, w_p "
                         f"{tuple(w_p.shape)}, scale {tuple(scale.shape)}, "
                         f"layer {layer}")
    gs = K // G
    if G > 1 and Kh % gs:
        raise ValueError(f"int4_matmul: groups of {gs} rows straddle the "
                         f"split half K/2 = {Kh}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int4_matmul: x dtype {x.dtype}")
    if w_p.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int4_matmul: w_p {w_p.dtype}, scale {s.dtype}")
    if not _together(x, w_p, s):
        raise ValueError("int4_matmul: operands must be contiguous and "
                         "on one device")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    _launch("int4_matmul", int4_matmul_stacked, x, w_p, s, layer, out,
            (Kh, N, gs), gs)
    return out


int4_matmul_stacked.launches = 0
int4_matmul_stacked.route_launches = dict.fromkeys(ROUTE_CODES, 0)


def int4_matmul(x: torch.Tensor, w_p: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K]; w_p int8 [K/2, N]; scale f32 [G, N] or [N] -> [M, N]
    (one-layer form)."""
    return int4_matmul_stacked(x, w_p[None], scale[None], 0)
