"""INT8 weight-only quantization (port of ``block_transformer_tpu/ops/quant.py``).

Symmetric per-output-channel scales::

    scale[n] = max(|W[:, n]|) / 127;  W_q = clip(round(W / scale), -127, 127)

Everything is computed in float32, and ``torch.round`` rounds half to even
as ``jnp.round`` does, so the results equal the JAX package's bit for bit.
A stacked ``[L, K, N]`` kernel gets one scale row per layer (``[L, N]``).
"""

from __future__ import annotations

import torch


def quantize_int8(w: torch.Tensor):
    """w [..., K, N] float -> (w_q int8 [..., K, N], scale f32 [..., N])."""
    wf = w.float()
    a = wf.abs().amax(dim=-2)
    scale = torch.clamp(a, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127)
    return w_q.to(torch.int8), scale


def dequantize_int8(w_q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (w_q.float() * scale.unsqueeze(-2)).to(dtype)


def quantize_kv(x: torch.Tensor):
    """[B, H, S, D] -> (int8 values, f32 scales [B, H, S]); one scale per
    position and head, clipped to +-127 after rounding
    (``block_transformer_tpu/models/neox.py`` ``quantize_kv``)."""
    xf = x.float()
    a = xf.abs().amax(dim=-1)
    scale = torch.clamp(a, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _is_linear(node) -> bool:
    return isinstance(node, dict) and "kernel" in node


def quantize_linear(node: dict, bits: int = 8) -> dict:
    """{'kernel': [..., K, N], 'bias'?} -> {'kernel_q8', 'scale', 'bias'?}."""
    if bits != 8:
        raise NotImplementedError("the port quantizes to INT8 only")
    w_q, scale = quantize_int8(node["kernel"])
    out = {"kernel_q8": w_q, "scale": scale}
    if "bias" in node:
        out["bias"] = node["bias"]
    return out


def quantize_model_params(params, bits: int = 8):
    """Replace every dense-kernel node of the tree with its quantized form."""
    if _is_linear(params):
        return quantize_linear(params, bits)
    if isinstance(params, dict):
        return {k: quantize_model_params(v, bits) for k, v in params.items()}
    return params


def quantize_block_transformer(params, bits: int = 8):
    """Quantize both decoder stacks, the expansion layer and the LM head;
    the embedder, layer norms and biases stay in float."""
    out = dict(params)
    for part in ("block_decoder", "token_decoder"):
        out[part] = quantize_model_params(params[part], bits)
    return out
