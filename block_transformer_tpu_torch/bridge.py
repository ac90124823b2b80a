"""Conversions between the JAX package's parameter trees and caches (as
numpy arrays) and the port's tensors.

Both sides use the same tree: nested dicts with the same keys, stacked
``[L, ...]`` layers, ``[K, N]`` kernels, int8 ``kernel_q8`` with float32
``[.., N]`` scales, and int8 ``kernel_q4`` (split-half packed ``[.., K/2,
N]``) with float32 group scales ``[.., G, N]`` (or ``[.., N]``). So a
conversion is a copy leaf by leaf that keeps each dtype. numpy has no
bfloat16 of its own: JAX hands out ``ml_dtypes.bfloat16`` arrays, which
cross to torch through a ``uint16`` view of the same bits.

KV caches differ in one field type: JAX's INT4 caches and pools hold
``jnp.int4`` values, one to an element (numpy dtype name ``int4``), which
the port packs two to a byte along D (``ops.quant.pack_kv_int4``, uint8
``[..., D/2]``). ``cache_to_numpy`` hands such values back unpacked as
int8, for ``.astype(jnp.int4)`` on the JAX side.

A train state crosses too: JAX's ``TrainState`` holds optax's chain state
``(clip, (adam, masked decay, schedule))`` from ``make_optimizer``, whose
Adam moments ``mu`` / ``nu`` are trees shaped like the parameters and whose
two step counts are equal; the port's ``AdamWState`` keeps one count. Each
leaf keeps its dtype both ways: bf16 parameters, and moments in bf16 (fresh)
or float32 (after an update with float32 gradients, which optax and the
port's optimizer both make float32).
"""

from __future__ import annotations

import numpy as np
import torch

from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import quant
from block_transformer_tpu_torch.train import optimizer as opt
from block_transformer_tpu_torch.train import train_step as ts


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def tensor_from_numpy(a, device="cuda", dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device="cuda", dtype=None):
    """A JAX parameter tree (after ``jax.device_get``) -> the port's tree.
    int8 stays int8; bf16 and f32 stay as they are unless ``dtype`` is given,
    which then applies to every floating leaf except the float32 scales of
    a quantized linear (the kernels read them as float32:
    ``quant.cast_floats``)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return tensor_from_numpy(node, device)

    out = conv(tree)
    return out if dtype is None else quant.cast_floats(out, dtype)


def params_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)


def cache_from_numpy(cache, device="cuda"):
    """A JAX ``KVCache`` / ``QuantKVCache`` / ``PagedKVCache`` (any object
    with its fields, arrays convertible by numpy) -> the port's cache."""
    length = int(np.asarray(cache.length))

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "int4":          # packed two to a byte
            return quant.pack_kv_int4(torch.from_numpy(
                a.astype(np.int8))).to(device)
        return tensor_from_numpy(a, device)

    if hasattr(cache, "page_table"):
        return neox.PagedKVCache(conv(cache.k), conv(cache.v),
                                 conv(cache.k_scale), conv(cache.v_scale),
                                 conv(cache.page_table), length)
    if hasattr(cache, "k_scale"):
        return neox.QuantKVCache(conv(cache.k), conv(cache.v),
                                 conv(cache.k_scale), conv(cache.v_scale),
                                 length)
    return neox.KVCache(conv(cache.k), conv(cache.v), length)


def cache_to_numpy(cache) -> dict:
    """The port's cache -> a dict of numpy arrays under the JAX field names
    (``length`` an int32 scalar), e.g. for ``QuantKVCache(**d)`` or
    ``PagedKVCache(**d)`` in JAX; an INT4 cache's values come unpacked, as
    int8."""
    def conv(t):
        if quant.kv_bits(t) == 4:
            t = quant.unpack_kv_int4(t)
        return tensor_to_numpy(t)

    out = {f: conv(getattr(cache, f)) for f in cache._fields if f != "length"}
    out["length"] = np.int32(cache.length)
    return out


def train_state_from_numpy(state, device="cuda") -> ts.TrainState:
    """A JAX ``TrainState`` (after ``jax.device_get``) built with
    ``make_optimizer`` -> the port's ``TrainState``."""
    _, (adam, _, sched) = state.opt_state
    count = int(np.asarray(adam.count))
    if int(np.asarray(sched.count)) != count:
        raise ValueError(f"Adam count {count} and schedule count "
                         f"{int(np.asarray(sched.count))} differ")
    return ts.TrainState(
        params_from_numpy(state.params, device),
        opt.AdamWState(count, params_from_numpy(adam.mu, device),
                       params_from_numpy(adam.nu, device)),
        int(np.asarray(state.step)))


def train_state_to_numpy(state: ts.TrainState, like):
    """The port's ``TrainState`` -> ``like`` (a JAX ``TrainState`` of the
    same parameter tree and optimizer) with every field replaced by the
    port's values as numpy arrays; optax's namedtuples are kept through
    ``_replace``, so no optax import is needed."""
    clip, (adam, masked, sched) = like.opt_state
    count = np.int32(state.opt_state.count)
    adam = adam._replace(count=count,
                         mu=params_to_numpy(state.opt_state.mu),
                         nu=params_to_numpy(state.opt_state.nu))
    return like._replace(params=params_to_numpy(state.params),
                         opt_state=(clip, (adam, masked,
                                           sched._replace(count=count))),
                         step=np.int32(state.step))
