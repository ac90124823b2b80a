"""Weight-only quantization, INT8 and INT4 (port of
``block_transformer_tpu/ops/quant.py``).

INT8 has symmetric per-output-channel scales::

    scale[n] = max(|W[:, n]|) / 127;  W_q = clip(round(W / scale), -127, 127)

INT4 has symmetric group-wise scales: group ``g`` covers input rows
``[g*gs, (g+1)*gs)``, with ``scale[g, n] = max(|W[group, n]|) / 7`` and values
in ``[-7, 7]``. Two nibbles share a byte in **split-half** packing: byte row
``i`` holds row ``i`` in its low nibble and row ``i + K/2`` in its high one,
so a product splits into ``x[:, :K/2] @ lo + x[:, K/2:] @ hi`` (K4,
``kernels/dequant_matmul.py``). ``gs`` must divide ``K/2`` so that no group
straddles the two halves; otherwise the whole of K is one group.

Everything is computed in float32, and ``torch.round`` rounds half to even
as ``jnp.round`` does, so the results equal the JAX package's bit for bit.
A stacked ``[L, K, N]`` kernel is quantized per layer, as JAX's ``vmap``
does: INT8 gives ``[L, N]`` scales, INT4 ``[L, K/2, N]`` bytes and
``[L, G, N]`` scales.

QAT (``fake_quant_*``) trains against the same grid: each chosen kernel is
quantized and dequantized in the forward, with a straight-through gradient
(``_ste``), and stays a float ``kernel`` node.
"""

from __future__ import annotations

import torch


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, an IEEE float32 division on every device: CUDA divides by a
    Python scalar through its reciprocal, 1 ulp off for some x, which moves
    a weight across a rounding boundary now and then (the grid would then
    differ between the card and the CPU), so d goes as a tensor on x's
    device."""
    return x / x.new_full((), d)


def quantize_int8(w: torch.Tensor):
    """w [..., K, N] float -> (w_q int8 [..., K, N], scale f32 [..., N])."""
    wf = w.float()
    a = wf.abs().amax(dim=-2)
    scale = _div(torch.clamp(a, min=1e-8), 127.0)
    w_q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127)
    return w_q.to(torch.int8), scale


def dequantize_int8(w_q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (w_q.float() * scale.unsqueeze(-2)).to(dtype)


def _int4_group_size(K: int, group_size) -> int:
    """Effective K-group size: ``group_size`` if it divides K/2, else K
    (one group: per-channel scales)."""
    if not group_size or group_size <= 0:
        return K
    return group_size if (K // 2) % group_size == 0 else K


def quantize_int4(w: torch.Tensor, group_size: int = 128):
    """w [..., K, N] float -> (packed int8 [..., K/2, N], scale f32
    [..., G, N]), split-half packed."""
    K, N = w.shape[-2:]
    if K % 2:
        raise ValueError(f"int4 packing requires even K, got {K}")
    gs = _int4_group_size(K, group_size)
    lead = w.shape[:-2]
    wf = w.float()
    a = wf.reshape(*lead, K // gs, gs, N).abs().amax(dim=-2)     # [..., G, N]
    scale = _div(torch.clamp(a, min=1e-8), 7.0)
    q = torch.clamp(torch.round(wf / scale.repeat_interleave(gs, dim=-2)),
                    -7, 7).to(torch.int32)
    half = K // 2
    # the byte is built from values in [0, 255] on a wide type, then its
    # bits are read as int8
    byte = (q[..., :half, :] & 0xF) | ((q[..., half:, :] & 0xF) << 4)
    return byte.to(torch.uint8).view(torch.int8), scale


def unpack_int4(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """packed [..., K/2, N] -> values [..., K, N] in [-8, 7]: the low
    nibbles, then the high nibbles (split-half layout). A nibble is sign
    extended as ``(u << 28) >> 28`` does: 0x8 gives -8."""
    u = packed.to(torch.int32)
    lo = ((u & 0xF) ^ 8) - 8
    hi = (((u >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(dtype)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """packed [..., K/2, N]; scale [..., G, N] group-wise (as many dims as
    ``packed``) or [..., N] per-channel."""
    w = unpack_int4(packed).float()
    if scale.dim() == packed.dim():
        scale = scale.repeat_interleave(w.shape[-2] // scale.shape[-2],
                                        dim=-2)
    else:
        scale = scale.unsqueeze(-2)
    return (w * scale).to(dtype)


def quantize_kv(x: torch.Tensor, bits: int = 8):
    """[B, H, S, D] -> (int8 values, f32 scales [B, H, S]); one scale per
    position and head, ``max|x| / qmax``, values clipped to +-qmax after
    rounding, with qmax 127 (``bits=8``) or 7 (``bits=4``, values still
    one to a byte: ``pack_kv_int4`` packs them)
    (``block_transformer_tpu/models/neox.py`` ``quantize_kv``)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qmax = 127.0 if bits == 8 else 7.0
    xf = x.float()
    a = xf.abs().amax(dim=-1)
    scale = _div(torch.clamp(a, min=1e-8), qmax)
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax)
    return q.to(torch.int8), scale


def pack_kv_int4(q: torch.Tensor) -> torch.Tensor:
    """INT4 cache values int8 [..., D] in [-8, 7] -> uint8 [..., D/2], split
    half along D: byte i holds d = i in its low nibble and d = i + D/2 in
    its high one (the INT4 weights' layout along K). A packed cache is
    told from an INT8 one by its dtype, uint8."""
    D = q.shape[-1]
    if D % 2:
        raise ValueError(f"int4 packing requires an even head dim, got {D}")
    u = q.to(torch.int32)
    byte = (u[..., :D // 2] & 0xF) | ((u[..., D // 2:] & 0xF) << 4)
    return byte.to(torch.uint8)


def kv_bits(values: torch.Tensor) -> int:
    """A cache's width from its values: 4 when packed (uint8), else 8."""
    return 4 if values.dtype == torch.uint8 else 8


def unpack_kv_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., D/2] -> int8 values [..., D]: the low nibbles, then the
    high nibbles, each sign extended."""
    u = packed.to(torch.int32)
    lo = ((u & 0xF) ^ 8) - 8
    hi = (((u >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def dequantize_kv(values: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """A cache's int8 [..., D] or packed uint8 [..., D/2] values times their
    per-slot scales [...] -> ``dtype``."""
    if kv_bits(values) == 4:
        values = unpack_kv_int4(values)
    return (values.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Whole-model weight quantization
# ---------------------------------------------------------------------------

def _is_linear(node) -> bool:
    return isinstance(node, dict) and "kernel" in node


def _skipped(path, skip_paths) -> bool:
    return any(all(s in path for s in sp) if isinstance(sp, tuple)
               else sp in path for sp in skip_paths)


def quantize_linear(node: dict, bits: int = 8, group_size: int = 128) -> dict:
    """{'kernel': [..., K, N], 'bias'?} -> {'kernel_q8' | 'kernel_q4',
    'scale', 'bias'?}."""
    if bits == 8:
        w_q, scale = quantize_int8(node["kernel"])
    elif bits == 4:
        w_q, scale = quantize_int4(node["kernel"], group_size)
    else:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    out = {f"kernel_q{bits}": w_q, "scale": scale}
    if "bias" in node:
        out["bias"] = node["bias"]
    return out


def quantize_model_params(params, bits: int = 8, skip_paths=(),
                          group_size: int = 128):
    """Replace every dense-kernel node of the tree with its quantized form.
    A node is left in float when its path of keys matches an entry of
    ``skip_paths``: a string that is one of the keys, or a tuple of strings
    that all are."""
    def walk(node, path):
        if _is_linear(node):
            return node if _skipped(path, skip_paths) else quantize_linear(
                node, bits, group_size)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return walk(params, ())


def quantize_block_transformer(params, bits: int = 8, group_size: int = 128,
                               skip_lm_head: bool = False,
                               token_decoder_bits: int = None,
                               lm_head_bits: int = None):
    """Quantize both decoder stacks, the expansion layer and the LM head;
    the embedder, layer norms and biases stay in float.

    ``token_decoder_bits`` / ``lm_head_bits`` mix precisions (``bench.py
    --quantize mixed48`` is bits 8, token decoder 4, head 8);
    ``skip_lm_head`` keeps the head in float."""
    td_bits = bits if token_decoder_bits is None else token_decoder_bits
    out = dict(params)
    out["block_decoder"] = quantize_model_params(
        params["block_decoder"], bits, group_size=group_size)
    skip = ("embed_out",) if (skip_lm_head or lm_head_bits is not None) else ()
    out["token_decoder"] = quantize_model_params(
        params["token_decoder"], td_bits, skip_paths=skip,
        group_size=group_size)
    if lm_head_bits is not None and not skip_lm_head:
        out["token_decoder"] = dict(out["token_decoder"])
        out["token_decoder"]["embed_out"] = quantize_linear(
            params["token_decoder"]["embed_out"], lm_head_bits, group_size)
    return out


# ---------------------------------------------------------------------------
# Fake quantization (QAT): a straight-through quantize -> dequantize on the
# grid quantize_block_transformer rounds onto
# ---------------------------------------------------------------------------

# QAT recipes (the JAX package's ``scripts/qat_finetune.py``), each the
# arguments of both fake_quant_block_transformer and quantize_block_transformer
RECIPES = {
    "mixed48": dict(bits=8, token_decoder_bits=4, lm_head_bits=8,
                    group_size=128),
    "int4g128": dict(bits=4, group_size=128),
    "int8": dict(bits=8),
}


def _qdq_int8(w: torch.Tensor) -> torch.Tensor:
    """w [..., K, N] -> the same values as ``dequantize_int8(*quantize_int8(
    w), w.dtype)``: per-output-channel scales, per layer of a stack."""
    wf = w.float()
    scale = _div(torch.clamp(wf.abs().amax(dim=-2, keepdim=True), min=1e-8),
                 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return (q * scale).to(w.dtype)


def _qdq_int4(w: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """w [..., K, N] -> the same values as ``dequantize_int4(*quantize_int4(
    w, group_size), w.dtype)`` (the packing is lossless, so it is left
    out)."""
    K, N = w.shape[-2:]
    gs = _int4_group_size(K, group_size)
    lead = w.shape[:-2]
    wg = w.float().reshape(*lead, K // gs, gs, N)
    scale = _div(torch.clamp(wg.abs().amax(dim=-2, keepdim=True), min=1e-8),
                 7.0)
    q = torch.clamp(torch.round(wg / scale), -7, 7)
    return (q * scale).reshape(w.shape).to(w.dtype)


def _ste(w: torch.Tensor, qdq: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the forward sees ``qdq`` (as ``w + (qdq -
    w)``, JAX's arithmetic), the backward the identity."""
    return w + (qdq - w).detach()


def fake_quant_linear(node: dict, bits: int, group_size: int = 128) -> dict:
    """{'kernel': [..., K, N], ...} -> the same node with its kernel fake
    quantized (a stacked ``[L, K, N]`` kernel per layer, as JAX's ``vmap``
    does)."""
    kernel = node["kernel"]
    if bits == 8:
        fq = _qdq_int8(kernel)
    elif bits == 4:
        fq = _qdq_int4(kernel, group_size)
    else:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    out = dict(node)
    out["kernel"] = _ste(kernel, fq)
    return out


def fake_quant_model_params(params, bits: int = 8, skip_paths=(),
                            group_size: int = 128):
    """``quantize_model_params``'s selection (and ``skip_paths`` rule), each
    chosen kernel fake quantized in place of packed."""
    def walk(node, path):
        if _is_linear(node):
            return node if _skipped(path, skip_paths) else fake_quant_linear(
                node, bits, group_size)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return walk(params, ())


def fake_quant_block_transformer(params, bits: int = 8, group_size: int = 128,
                                 token_decoder_bits: int = None,
                                 lm_head_bits: int = None):
    """The QAT transform: ``quantize_block_transformer``'s kernels and grid
    with the same arguments, as a quantize -> dequantize in the forward
    with straight-through gradients. Train with ``make_train_step(...,
    param_transform=...)``; ``quantize_block_transformer`` with the same
    arguments then rounds the master weights onto the grid the loss saw."""
    td_bits = bits if token_decoder_bits is None else token_decoder_bits
    out = dict(params)
    out["block_decoder"] = fake_quant_model_params(
        params["block_decoder"], bits, group_size=group_size)
    skip = ("embed_out",) if lm_head_bits is not None else ()
    out["token_decoder"] = fake_quant_model_params(
        params["token_decoder"], td_bits, skip_paths=skip,
        group_size=group_size)
    if lm_head_bits is not None:
        out["token_decoder"] = dict(out["token_decoder"])
        out["token_decoder"]["embed_out"] = fake_quant_linear(
            params["token_decoder"]["embed_out"], lm_head_bits, group_size)
    return out


def cast_floats(tree, dtype):
    """Every floating leaf of a parameter tree cast to ``dtype``, except the
    float32 scales of quantized linears (the kernels read them as float32):
    float32 master weights, once quantized, served in bf16."""
    if isinstance(tree, dict):
        quantized = any(k.startswith("kernel_q") for k in tree)
        return {k: v if quantized and k == "scale" else cast_floats(v, dtype)
                for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree
