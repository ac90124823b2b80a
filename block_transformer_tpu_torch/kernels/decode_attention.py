"""K2: decode attention over an INT8 KV cache (replaces the Pallas kernel
``block_transformer_tpu/ops/decode_attention.py`` ``_decode_attn``, entry
``decode_attention_int8_stacked``).

q ``[B, H, S, D]`` with S <= 8 against one layer of the stacked int8 cache
``[L, B, H, cap, D]`` with float32 per-slot scales ``[L, B, H, cap]``: the
scores are ``q . k_q * k_scale / sqrt(D)``, the probabilities are multiplied
by ``v_scale`` before the product with ``v_q``, and the softmax is float32.
The CUDA kernel (``csrc/decode_attention.cu``) reads the int8 cache once and
never dequantizes it in memory; it gets the layer's base pointers, so no
slice of the cache is copied.

The plain version dequantizes the layer's cache to ``q.dtype`` and runs
``attention_xla``, which is what the JAX package does for this shape off the
TPU. The wrapper runs it for CPU tensors and launches the kernel for CUDA
tensors; ``decode_attention_int8_stacked.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from block_transformer_tpu_torch.kernels import build
from block_transformer_tpu_torch.kernels.flash_attention import index_vectors
from block_transformer_tpu_torch.ops import masks as masks_lib
from block_transformer_tpu_torch.ops.attention import attention_xla

MAX_S = 8
HEAD_DIMS = (32, 64, 128)


def decode_attention_int8_stacked_plain(q, k_q, k_s, v_q, v_s, layer: int,
                                        mask: masks_lib.AttnMask):
    k = (k_q[layer].float() * k_s[layer][..., None]).to(q.dtype)
    v = (v_q[layer].float() * v_s[layer][..., None]).to(q.dtype)
    return attention_xla(q, k, v, mask)


@functools.cache
def _fn():
    fn = build.load("decode_attention").bt_decode_attention_int8
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention_int8_stacked(q: torch.Tensor, k_q: torch.Tensor,
                                  k_s: torch.Tensor, v_q: torch.Tensor,
                                  v_s: torch.Tensor, layer: int,
                                  mask: masks_lib.AttnMask) -> torch.Tensor:
    """q [B, H, S, D] (S <= 8); k_q/v_q int8 [L, B, H, cap, D]; k_s/v_s f32
    [L, B, H, cap]; mask at cache granularity -> [B, H, S, D] in q.dtype."""
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
    q_idx, kv_idx, kv_valid = index_vectors(mask, B, S, cap, q.device)
    out = torch.empty_like(q)
    err = _fn()(build.ptr(q), build.ptr(k_q[layer]), build.ptr(k_s[layer]),
                build.ptr(v_q[layer]), build.ptr(v_s[layer]),
                build.ptr(q_idx), build.ptr(kv_idx), build.ptr(kv_valid),
                build.ptr(out), B, H, S, D, cap,
                int(q.dtype == torch.bfloat16), build.stream(q.device))
    build.check(err, "decode_attention_int8")
    decode_attention_int8_stacked.launches += 1
    return out


decode_attention_int8_stacked.launches = 0
