"""Attention (port of ``block_transformer_tpu/ops/attention.py``).

``attention_xla`` is the plain path: float32 scores plus the mask's additive
bias, float32 softmax, probabilities cast to ``q.dtype`` before P.V with a
float32 accumulator, output in ``q.dtype``. ``attention`` sends every query
block with Q >= 8 rows (and a head dim the kernel takes) to the flash
kernel K3, whose wrapper runs its plain version on the CPU; smaller Q (the
token decoder's tiny local-cache attention) stays on ``attention_xla``, as
it stays on XLA in the JAX package.
"""

from __future__ import annotations

import torch

from block_transformer_tpu_torch.ops import masks as masks_lib


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: masks_lib.AttnMask) -> torch.Tensor:
    """q [B, H, Q, D]; k, v [B, H, K, D] -> [B, H, Q, D] in q.dtype."""
    # 1/sqrt(D) in float32 arithmetic, as 1 / jnp.sqrt(jnp.float32(D))
    scale = 1.0 / torch.tensor(float(q.shape[-1]), device=q.device).sqrt()
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores + mask.bias()
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def attention(q, k, v, mask: masks_lib.AttnMask):
    # imported here: the kernel module imports attention_xla from this one
    from block_transformer_tpu_torch.kernels import flash_attention
    if q.shape[2] >= 8 and flash_attention.supported_head_dim(q.shape[-1]):
        return flash_attention.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), mask)
    return attention_xla(q, k, v, mask)
