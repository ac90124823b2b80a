"""Linear layers, float or INT8 / INT4 weight-only (port of
``block_transformer_tpu/ops/linear.py``).

Every matmul of the model goes through ``apply_linear``, so quantization is
a transformation of the parameter tree alone (``ops/quant.py``). A ``kernel``
node is a plain ``torch.matmul``; a ``kernel_q8`` node goes to K1 and a
``kernel_q4`` node to K4 (``kernels/dequant_matmul.py``), whose wrappers run
their plain versions on the CPU. Layer stacks use ``StackedLinear(node,
layer)``: the whole ``[L, ...]`` node plus a layer index, so the kernel
reads the layer in place.

The JAX package's TPU-tuned dispatch (its ``BT_PALLAS_*`` switches, M
cut-overs and W8A8 thresholds) is not carried over: the port runs K1 for
every INT8 linear and K4 for every INT4 linear, at every M, until its own
H100 records say otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from block_transformer_tpu_torch.kernels import dequant_matmul


# quantized kernel key -> (one-layer form, stacked form)
_QUANTIZED = {
    "kernel_q8": (dequant_matmul.int8_matmul,
                  dequant_matmul.int8_matmul_stacked),
    "kernel_q4": (dequant_matmul.int4_matmul,
                  dequant_matmul.int4_matmul_stacked),
}


class StackedLinear(NamedTuple):
    """View of one layer inside a stacked ``[L, ...]`` linear param node."""
    node: dict
    layer: int


def apply_linear(x: torch.Tensor, p) -> torch.Tensor:
    """x [..., K] @ params -> [..., N] (+ bias if present). ``p`` is a linear
    param dict ({"kernel" | "kernel_q8" | "kernel_q4", "scale"?, "bias"?})
    or a ``StackedLinear``."""
    if isinstance(p, StackedLinear):
        node, layer = p.node, p.layer
        pick = lambda t: t[layer]                      # noqa: E731
    else:
        node, layer = p, None
        pick = lambda t: t                             # noqa: E731
    lead = x.shape[:-1]
    if "kernel" in node:
        out = torch.matmul(x, pick(node["kernel"]))
    elif (key := next((k for k in _QUANTIZED if k in node), None)):
        one, stacked = _QUANTIZED[key]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if layer is None:
            out = one(x2, node[key], node["scale"])
        else:
            out = stacked(x2, node[key], node["scale"], layer)
        out = out.reshape(*lead, out.shape[-1])
    else:
        raise KeyError(f"no kernel in linear params: {list(node)}")
    if "bias" in node:
        out = out + pick(node["bias"]).to(out.dtype)
    return out
