"""W8A8-q and W8A8-mm: the prefill linears' dynamic per-row activation
quantization and int8 x int8 matmul (port of ``_w8a8_dot`` in
``block_transformer_tpu/ops/linear.py``; not a TPU kernel there but XLA ops,
a native s8 x s8 dot on the TPU's matrix unit).

W8A8-q: ``sx[m] = f32(max|x[m]|) / 127 + 1e-12`` and
``xq[m] = int8(round_half_even(f32(x[m]) / sx[m]))``.
W8A8-mm: ``out = cast_x((f32(xq @ w_q[layer]) * sx[:, None]) *
scale[layer])``, the product summed in int32. The CUDA kernels
(``csrc/w8a8.cu``) are bit-exact against these plain versions: the same
IEEE division and rounding, an exact integer sum, the same order of the
epilogue's roundings. The weights are the whole stacked ``[L, K, N]`` array
and ``layer`` a Python int: the kernel gets the layer's base pointer, so no
weight slice is copied.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors, raising on input the kernel does not take.
``w8a8_quant.launches`` and ``w8a8_matmul_stacked.launches`` count the
launches, and ``w8a8_matmul_stacked.route_launches`` W8A8-mm's by route
(one route, ``"wgmma"``: warp-specialized ``wgmma`` fed by TMA). ``plan``
(pure) gives W8A8-mm's route, tile, split of K and persistent grid.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from block_transformer_tpu_torch.kernels import build


def w8a8_quant_plain(x: torch.Tensor):
    """x [M, K] (f32/bf16) -> (xq int8 [M, K], sx f32 [M])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient
    sx = amax.float() / torch.tensor(127.0, device=x.device) + 1e-12
    xq = torch.round(x.float() / sx).to(torch.int8)
    return xq, sx[:, 0]


def int_product(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """xq int8 [M, K] @ w_q int8 [K, N] -> int32 [M, N], exact: float64 holds
    every product and partial sum exactly (|sum| < 2^31 < 2^53), whatever
    the order, on the CPU and on the card alike."""
    return torch.matmul(xq.double(), w_q.double()).to(torch.int32)


def w8a8_matmul_plain(xq: torch.Tensor, sx: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor, dtype) -> torch.Tensor:
    """((f32(xq @ w_q) * sx[:, None]) * scale) cast to ``dtype``."""
    acc = int_product(xq, w_q).float()
    return (acc * sx[:, None] * scale).to(dtype)


def w8a8_matmul_stacked_plain(xq, sx, w_q, scale, layer: int,
                              dtype) -> torch.Tensor:
    return w8a8_matmul_plain(xq, sx, w_q[layer], scale[layer], dtype)


@functools.cache
def _fn(name: str):
    fn = getattr(build.load("w8a8"), name)
    if name == "bt_w8a8_quant":
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_ALIGN = 16                # bytes: TMA's global alignment, the vector stores
# W8A8-mm's tile: 128 tokens (wgmma's N) x 256 weight columns (two consumer
# warpgroups of two m64 tiles), K in stages of 128 bytes; one block an SM
BT, BN, BK = 128, 256, 128


class Plan(NamedTuple):
    """How one W8A8-mm launches: ``route`` (``"wgmma"``), ``tile`` (tokens,
    weight columns, K bytes a stage), K split over ``splits`` units of
    ``k_per_split`` bytes each, and a persistent grid of ``blocks`` blocks
    walking the ``tiles * splits`` units."""
    route: str
    tile: tuple
    splits: int
    k_per_split: int
    blocks: int


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, sms: int) -> Plan:
    """W8A8-mm's launch of ``xq [M, K] @ w [K, N]`` on a card with ``sms``
    SMs (one block an SM: the ring takes 193 KB of shared memory). When
    the tiles are fewer than the SMs, K is split in whole 128-byte stages
    into at most as many splits as fill the SMs once; the grid is the
    units or the SMs, whichever is fewer."""
    tiles = -(-M // BT) * -(-N // BN)
    steps = -(-K // BK)
    want = max(1, sms // tiles)
    kps = -(-steps // want) * BK
    splits = -(-K // kps)
    return Plan("wgmma", (BT, BN, BK), splits, kps, min(tiles * splits, sms))


def _aligned(*ptrs) -> bool:
    return not any(p % _ALIGN for p in ptrs)


def w8a8_quant(x: torch.Tensor):
    """x [M, K] (f32/bf16) -> (xq int8 [M, K], sx f32 [M]). On the card K
    must be a multiple of 16 (as W8A8-mm's) and x 16-byte aligned."""
    build.no_backward("w8a8_quant", x)
    if not x.is_cuda:
        return w8a8_quant_plain(x)
    if x.dim() != 2:
        raise ValueError(f"w8a8_quant: x {tuple(x.shape)} is not [M, K]")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w8a8_quant: x dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("w8a8_quant: x must be contiguous")
    M, K = x.shape
    if K == 0 or K % 16:
        raise ValueError(f"w8a8_quant: K = {K} must be a positive multiple "
                         "of 16")
    if not _aligned(x.data_ptr()):
        raise ValueError("w8a8_quant: x must be 16-byte aligned")
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    if M == 0:
        return xq, sx
    dev = x.device.index or 0
    err = _fn("bt_w8a8_quant")(x.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                               M, K, int(x.dtype == torch.bfloat16),
                               build.raw_stream(dev))
    build.check(err, "w8a8_quant")
    w8a8_quant.launches += 1
    return xq, sx


w8a8_quant.launches = 0


def w8a8_matmul_stacked(xq: torch.Tensor, sx: torch.Tensor,
                        w_q: torch.Tensor, scale: torch.Tensor, layer: int,
                        dtype) -> torch.Tensor:
    """xq int8 [M, K]; sx f32 [M]; w_q int8 [L, K, N]; scale f32 [L, N] ->
    [M, N] in ``dtype`` (f32/bf16). On the card K and N must be positive
    multiples of 16 and every operand 16-byte aligned."""
    build.no_backward("w8a8_matmul", sx, scale)
    if not xq.is_cuda:
        return w8a8_matmul_stacked_plain(xq, sx, w_q, scale, layer, dtype)
    M, K = xq.shape
    L, K2, N = w_q.shape
    if (K != K2 or tuple(sx.shape) != (M,) or tuple(scale.shape) != (L, N)
            or not 0 <= layer < L):
        raise ValueError(f"w8a8_matmul: xq {tuple(xq.shape)}, sx "
                         f"{tuple(sx.shape)}, w_q {tuple(w_q.shape)}, scale "
                         f"{tuple(scale.shape)}, layer {layer}")
    if (xq.dtype != torch.int8 or w_q.dtype != torch.int8
            or sx.dtype != torch.float32 or scale.dtype != torch.float32):
        raise TypeError(f"w8a8_matmul: xq {xq.dtype}, w_q {w_q.dtype}, sx "
                        f"{sx.dtype}, scale {scale.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w8a8_matmul: output dtype {dtype}")
    if K <= 0 or N <= 0 or K % 16 or N % 16:
        raise ValueError(f"w8a8_matmul: K = {K} and N = {N} must be "
                         "positive multiples of 16")
    dev = xq.get_device()
    if not all(t.get_device() == dev and t.is_contiguous()
               for t in (sx, w_q, scale)) or not xq.is_contiguous():
        raise ValueError("w8a8_matmul: operands must be contiguous and on "
                         "one device")
    out = torch.empty((M, N), dtype=dtype, device=xq.device)
    if M == 0:
        return out
    ptrs = (xq.data_ptr(), sx.data_ptr(), w_q.data_ptr() + layer * K * N,
            scale.data_ptr() + layer * N * 4, out.data_ptr())
    if not _aligned(*ptrs):
        raise ValueError("w8a8_matmul: operands must be 16-byte aligned")
    p = plan(M, K, N, build.sm_count(dev))
    stream = build.raw_stream(dev)
    ws = ctr = None
    if p.splits > 1:
        ws, ctr = build.scratch(dev, stream, p.splits * M * N,
                                2 * -(-M // BT) * -(-N // BN))
        ws, ctr = ws.data_ptr(), ctr.data_ptr()
    err = _fn("bt_w8a8_matmul")(*ptrs, ws, ctr, M, K, N, p.splits,
                                p.k_per_split, p.blocks,
                                int(dtype == torch.bfloat16), stream)
    build.check(err, "w8a8_matmul")
    w8a8_matmul_stacked.launches += 1
    w8a8_matmul_stacked.route_launches[p.route] += 1
    return out


w8a8_matmul_stacked.launches = 0
w8a8_matmul_stacked.route_launches = {"wgmma": 0}
