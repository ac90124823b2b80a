"""Linear layers, float or INT8 / INT4 weight-only (port of
``block_transformer_tpu/ops/linear.py``).

Every matmul of the model goes through ``apply_linear``, so quantization is
a transformation of the parameter tree alone (``ops/quant.py``). A ``kernel``
node is a plain ``torch.matmul``; a ``kernel_q4`` node goes to K4 and a
``kernel_q8`` node to K1 (``kernels/dequant_matmul.py``) or, at prefill-sized
M on the card, to W8A8 (``kernels/w8a8.py``): the activations quantized per
row (W8A8-q) and an int8 x int8 product on the tensor cores (W8A8-mm). The
wrappers run their plain versions on the CPU. Layer stacks use
``StackedLinear(node, layer)``: the whole ``[L, ...]`` node plus a layer
index, so the kernel reads the layer in place.

W8A8 follows the JAX package's ``_use_w8a8``: INT8 weights with M >= 2048
rows while an INT8 KV cache is declared (``kv_mode("int8")``, which the
generation and serving entry points set), M >= 384 otherwise. Its gate
"on the TPU" becomes "x is a CUDA tensor" (``_on_card``), so on the CPU the
port takes W8A8 only where a test patches that gate. The JAX package's
environment switches are explicit contexts here: ``w8a8_disabled()`` (its
``BT_W8A8=0``) and ``w8a8_min_m(n)`` (its ``BT_W8A8_M_MIN``). Its other
TPU-tuned switches (``BT_PALLAS_*``) are not carried over: below the W8A8
floor the port runs K1 for every INT8 linear and K4 for every INT4 linear,
at every M.

``pallas_disabled()`` and ``apply_linear(use_pallas=False)`` take the plain
dequantize-and-matmul instead of any hand kernel (K1, K4 or W8A8), as the
JAX package takes XLA's; ``use_pallas=True`` takes K1 / K4 and never W8A8.
The JAX package needs the switch because XLA cannot partition a
``pallas_call``; the port's mesh programs run per rank on local shards, so
nothing in the port sets it: it is kept for JAX's signatures, and on a CUDA
tensor it raises rather than run the plain version on the card. Inside those
programs (``sharded_program()``, entered by ``parallel/tp_decode.py``) W8A8
is off whatever was forced, as under a JAX ``shard_map``: a row-parallel
linear sees a K-slice of each row, so its per-row activation scale would
differ from one device's.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch

from block_transformer_tpu_torch.kernels import dequant_matmul
from block_transformer_tpu_torch.kernels import w8a8


# quantized kernel key -> (one-layer form, stacked form)
_QUANTIZED = {
    "kernel_q8": (dequant_matmul.int8_matmul,
                  dequant_matmul.int8_matmul_stacked),
    "kernel_q4": (dequant_matmul.int4_matmul,
                  dequant_matmul.int4_matmul_stacked),
}

# the plain versions of the same (use_pallas=False)
_PLAIN = {
    "kernel_q8": (dequant_matmul.int8_matmul_plain,
                  dequant_matmul.int8_matmul_stacked_plain),
    "kernel_q4": (dequant_matmul.int4_matmul_plain,
                  dequant_matmul.int4_matmul_stacked_plain),
}

# The decode KV-cache mode ("bf16" / "int8" / "int4" / None) declared by the
# entry points: it keys W8A8's default floor, as in the JAX package.
_KV_MODE: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "bt_kv_mode", default=None)
_W8A8_OFF = contextvars.ContextVar("bt_w8a8_off", default=False)
_W8A8_M_MIN: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "bt_w8a8_m_min", default=None)
_NO_PALLAS = contextvars.ContextVar("bt_no_pallas", default=False)
_SHARDED = contextvars.ContextVar("bt_sharded_program", default=False)


@contextlib.contextmanager
def _setting(var: contextvars.ContextVar, value):
    tok = var.set(value)
    try:
        yield
    finally:
        var.reset(tok)


def kv_mode(mode: Optional[str]):
    """Declare the decode KV-cache mode for the W8A8 decisions made
    inside."""
    return _setting(_KV_MODE, mode)


def w8a8_disabled():
    """No W8A8 inside: every INT8 linear goes to K1."""
    return _setting(_W8A8_OFF, True)


def w8a8_min_m(n: int):
    """W8A8 for every INT8 linear with M >= n inside, whatever the KV mode
    (``w8a8_min_m(1)``: at every M)."""
    return _setting(_W8A8_M_MIN, int(n))


def pallas_disabled():
    """No hand kernel for the linears and the attention inside: each takes
    its plain version (JAX: XLA's dequant + dot)."""
    return _setting(_NO_PALLAS, True)


def pallas_allowed() -> bool:
    """False inside ``pallas_disabled()``."""
    return not _NO_PALLAS.get()


def refuse_plain_on_card(x: torch.Tensor) -> None:
    """The plain path the switches above ask for runs on the CPU only: no
    code of the port sets them, and the card runs the hand kernels."""
    if _on_card(x):
        raise RuntimeError("use_pallas=False / pallas_disabled() ask for the "
                           "plain version, which the port does not run on "
                           "the card")


def sharded_program():
    """Mark the code inside as a mesh program's per-rank body: no W8A8."""
    return _setting(_SHARDED, True)


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def _use_w8a8(m: int) -> bool:
    """The JAX package's decision for M = m rows (its device gate aside):
    an explicit floor wins; else 2048 under an INT8 KV cache (prefill only)
    and 384 otherwise. Never inside ``sharded_program()``, whatever was
    forced."""
    if _W8A8_OFF.get() or _SHARDED.get():
        return False
    floor = _W8A8_M_MIN.get()
    if floor is None:
        floor = 2048 if _KV_MODE.get() == "int8" else 384
    return m >= floor


def _w8a8_dot(x2: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
              layer: int) -> torch.Tensor:
    """x2 [M, K] @ INT8 layer ``layer`` of w_q [L, K, N] (scale [L, N]):
    W8A8-q, then W8A8-mm, out in x2's dtype."""
    xq, sx = w8a8.w8a8_quant(x2)
    return w8a8.w8a8_matmul_stacked(xq, sx, w_q, scale, layer, x2.dtype)


class StackedLinear(NamedTuple):
    """View of one layer inside a stacked ``[L, ...]`` linear param node."""
    node: dict
    layer: int


def apply_linear(x: torch.Tensor, p, use_pallas: Optional[bool] = None
                 ) -> torch.Tensor:
    """x [..., K] @ params -> [..., N] (+ bias if present). ``p`` is a linear
    param dict ({"kernel" | "kernel_q8" | "kernel_q4", "scale"?, "bias"?})
    or a ``StackedLinear``. ``use_pallas``: None decides (W8A8, K1 or K4;
    the plain version inside ``pallas_disabled()``), True takes K1 / K4,
    False the plain version."""
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
        w, s = node[key], node["scale"]
        if use_pallas is None and not pallas_allowed():
            use_pallas = False
        if use_pallas is False:
            refuse_plain_on_card(x2)
            one, stacked = _PLAIN[key]
        if (key == "kernel_q8" and use_pallas is None and _on_card(x2)
                and _use_w8a8(x2.shape[0])):
            if layer is None:
                w, s, layer = w[None], s[None], 0
            out = _w8a8_dot(x2, w, s, layer)
        elif layer is None:
            out = one(x2, w, s)
        else:
            out = stacked(x2, w, s, layer)
        out = out.reshape(*lead, out.shape[-1])
    else:
        raise KeyError(f"no kernel in linear params: {list(node)}")
    if "bias" in node:
        out = out + pick(node["bias"]).to(out.dtype)
    return out
