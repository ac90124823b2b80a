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
kernel for CUDA tensors, raising on input the kernel does not take;
``int8_matmul_stacked.launches`` and ``int4_matmul_stacked.launches`` count
the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from block_transformer_tpu_torch.kernels import build
from block_transformer_tpu_torch.ops import quant

_BN, _BK = 64, 32        # tile sizes of csrc/dequant_matmul.cu


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version: dequantize, float32 matmul, scale, cast to x.dtype."""
    return (torch.matmul(x.float(), w_q.float()) * scale).to(x.dtype)


def int8_matmul_stacked_plain(x, w_q, scale, layer: int) -> torch.Tensor:
    return int8_matmul_plain(x, w_q[layer], scale[layer])


@functools.cache
def _fn(name: str, n_ints: int):
    fn = getattr(build.load("dequant_matmul"), name)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(M: int, K: int, N: int, sms: int):
    """(splits, k_per_split): split K over gridDim.z when the output has too
    few tiles to give every SM two blocks, keeping each split >= 256 deep."""
    bm = 16 if M <= 16 else 64
    tiles = -(-N // _BN) * -(-M // bm)
    want = -(-2 * sms // tiles)
    splits = max(1, min(want, K // 256))
    kps = -(-(-(-K // splits)) // _BK) * _BK
    return -(-K // kps), kps


def int8_matmul_stacked(x: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor, layer: int) -> torch.Tensor:
    """x [M, K] (f32/bf16); w_q int8 [L, K, N]; scale f32 [L, N] -> [M, N]."""
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
    for t in (x, w_q, scale):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_matmul: operands must be contiguous and "
                             "on one device")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    splits, kps = split_k(M, K, N, _sm_count(x.device.index or 0))
    ws = (torch.empty(splits * M * N, dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    err = _fn("bt_int8_matmul", 6)(
        build.ptr(x), build.ptr(w_q[layer]), build.ptr(scale[layer]),
        build.ptr(out), build.ptr(ws), M, K, N, splits, kps,
        int(x.dtype == torch.bfloat16), build.stream(x.device))
    build.check(err, "int8_matmul")
    int8_matmul_stacked.launches += 1
    return out


int8_matmul_stacked.launches = 0


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
    for t in (x, w_p, s):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int4_matmul: operands must be contiguous and "
                             "on one device")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    splits, kps = split_k(M, Kh, N, _sm_count(x.device.index or 0))
    ws = (torch.empty(splits * M * N, dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    err = _fn("bt_int4_matmul", 7)(
        build.ptr(x), build.ptr(w_p[layer]), build.ptr(s[layer]),
        build.ptr(out), build.ptr(ws), M, Kh, N, gs, splits, kps,
        int(x.dtype == torch.bfloat16), build.stream(x.device))
    build.check(err, "int4_matmul")
    int4_matmul_stacked.launches += 1
    return out


int4_matmul_stacked.launches = 0


def int4_matmul(x: torch.Tensor, w_p: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K]; w_p int8 [K/2, N]; scale f32 [G, N] or [N] -> [M, N]
    (one-layer form)."""
    return int4_matmul_stacked(x, w_p[None], scale[None], 0)
