"""Linear layers, float or INT8 weight-only (port of
``block_transformer_tpu/ops/linear.py``).

Every matmul of the model goes through ``apply_linear``, so quantization is
a transformation of the parameter tree alone (``ops/quant.py``). A ``kernel``
node is a plain ``torch.matmul``; a ``kernel_q8`` node goes to K1
(``kernels/dequant_matmul.py``), whose wrapper runs its plain version on the
CPU. Layer stacks use ``StackedLinear(node, layer)``: the whole ``[L, ...]``
node plus a layer index, so K1 reads the layer in place.

The JAX package's TPU-tuned dispatch (its ``BT_PALLAS_*`` switches, M
cut-overs and W8A8 thresholds) is not carried over: the port runs K1 for
every INT8 linear until its own H100 records say otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from block_transformer_tpu_torch.kernels import dequant_matmul


class StackedLinear(NamedTuple):
    """View of one layer inside a stacked ``[L, ...]`` linear param node."""
    node: dict
    layer: int


def apply_linear(x: torch.Tensor, p) -> torch.Tensor:
    """x [..., K] @ params -> [..., N] (+ bias if present). ``p`` is a linear
    param dict ({"kernel" | "kernel_q8", "scale"?, "bias"?}) or a
    ``StackedLinear``."""
    if isinstance(p, StackedLinear):
        node, layer = p.node, p.layer
        pick = lambda t: t[layer]                      # noqa: E731
    else:
        node, layer = p, None
        pick = lambda t: t                             # noqa: E731
    lead = x.shape[:-1]
    if "kernel" in node:
        out = torch.matmul(x, pick(node["kernel"]))
    elif "kernel_q8" in node:
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if layer is None:
            out = dequant_matmul.int8_matmul(x2, node["kernel_q8"],
                                             node["scale"])
        else:
            out = dequant_matmul.int8_matmul_stacked(
                x2, node["kernel_q8"], node["scale"], layer)
        out = out.reshape(*lead, out.shape[-1])
    else:
        raise KeyError(f"no kernel in linear params: {list(node)}")
    if "bias" in node:
        out = out + pick(node["bias"]).to(out.dtype)
    return out
