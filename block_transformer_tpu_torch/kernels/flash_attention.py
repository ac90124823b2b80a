"""K3: flash attention with a structured mask (replaces the Pallas kernel
``block_transformer_tpu/ops/flash_attention.py`` ``_flash`` /
``flash_attention``).

q ``[B, H, Q, D]`` against k, v ``[B, H, K, D]`` under an ``AttnMask``; the
CUDA kernels (``csrc/flash_attention.cu``) build the mask per tile from the
index vectors and run a float32 online softmax. Any Q and K; any head
dim D <= 128. Which kernel is one pure function, ``route``: the tensor-core
kernel (``"tc"``: bf16 with D = 64 or 128, the main path's and the
baseline's head dims; it skips key tiles no query of its tile may see) or
the CUDA-core kernel (``"fma"``: float32 and every other head dim).

The plain version is ``attention_xla``. Keys past K are left out of the
kernel's softmax, so a query row with no allowed key averages the K real
values uniformly, as ``attention_xla`` does (the Pallas kernel's zero
padding rows join that average; only such rows differ from it).

The wrapper runs the plain version for CPU tensors and launches a kernel
for CUDA tensors; ``flash_attention.launches`` counts the launches and
``flash_attention.route_launches`` counts them by route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from block_transformer_tpu_torch.kernels import build
from block_transformer_tpu_torch.ops import masks as masks_lib
from block_transformer_tpu_torch.ops.attention import attention_xla

MAX_HEAD_DIM = 128
TC_HEAD_DIMS = (64, 128)
TC_MAX_KEYS = 256 * 32 * 64     # the tensor-core kernel's tile bitmask
_TC_ALIGN = 16                  # bytes of one cp.async copy


def supported_head_dim(D: int) -> bool:
    return 1 <= D <= MAX_HEAD_DIM


def route(dtype, D: int, K: int, aligned: bool = True) -> str:
    """"tc" (tensor cores) for bf16 with D in TC_HEAD_DIMS, K within the
    kernel's bitmask and 16-byte aligned operands; "fma" (CUDA cores)
    otherwise."""
    if (dtype == torch.bfloat16 and D in TC_HEAD_DIMS and K <= TC_MAX_KEYS
            and aligned):
        return "tc"
    return "fma"


def flash_attention_plain(q, k, v, mask: masks_lib.AttnMask):
    return attention_xla(q, k, v, mask)


@functools.cache
def _fn():
    fn = build.load("flash_attention").bt_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def index_vectors(mask: masks_lib.AttnMask, B: int, Q: int, K: int, device):
    """(q_idx [B, Q], kv_idx [K], kv_valid [B, K]) as contiguous int32."""
    q_idx = mask.q_idx
    if q_idx.dim() == 1:
        q_idx = q_idx[None].expand(B, Q)
    kv_valid = mask.kv_valid
    if kv_valid is None:
        kv_valid = torch.ones((B, K), dtype=torch.int32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    out = (q_idx.to(**i32).contiguous(), mask.kv_idx.to(**i32).contiguous(),
           kv_valid.to(**i32).contiguous())
    if (tuple(out[0].shape) != (B, Q) or tuple(out[1].shape) != (K,)
            or tuple(out[2].shape) != (B, K)):
        raise ValueError(f"attention mask shapes {[tuple(t.shape) for t in out]}"
                         f" do not fit B={B} Q={Q} K={K}")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: masks_lib.AttnMask) -> torch.Tensor:
    """q [B, H, Q, D]; k, v [B, H, K, D]; mask: AttnMask -> [B, H, Q, D]."""
    build.no_backward("flash_attention", q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, mask)
    B, H, Q, D = q.shape
    K = k.shape[2]
    if (tuple(k.shape) != (B, H, K, D) or k.shape != v.shape
            or not supported_head_dim(D) or Q == 0 or K == 0):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention: operands must be contiguous "
                             "and on one device")
    q_idx, kv_idx, kv_valid = index_vectors(mask, B, Q, K, q.device)
    out = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    r = route(q.dtype, D, K, not any(x % _TC_ALIGN for x in ptrs))
    dev = q.device.index or 0
    err = _fn()(*ptrs[:3], q_idx.data_ptr(), kv_idx.data_ptr(),
                kv_valid.data_ptr(), ptrs[3], B, H, Q, K, D,
                int(q.dtype == torch.bfloat16), int(r == "tc"),
                build.raw_stream(dev))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.route_launches[r] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = {"tc": 0, "fma": 0}
