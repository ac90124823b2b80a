"""The PyTorch port's INT8 quantization against the JAX package: bit-exact.

Both compute in float32 and round half to even, so weights, scales and KV
cache values must agree in every bit.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch.ops import quant as torch_quant


def _bits(x):
    return np.asarray(x).tobytes()


def _pair(a: np.ndarray):
    """The same array for JAX and for the port."""
    return jnp.asarray(a), bridge.tensor_from_numpy(a, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("shape", [(96, 40), (3, 64, 48)])
def test_quantize_int8_bit_exact(shape, dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.05).astype(dtype)
    w[..., 0, :] *= 40            # outliers set some scales
    w[..., :, 1] = 0              # an all-zero column: scale floor 1e-8
    wj, wt = _pair(w)
    stacked = len(shape) == 3
    qj, sj = (jax.vmap(jax_quant.quantize_int8) if stacked
              else jax_quant.quantize_int8)(wj)
    qt, st = torch_quant.quantize_int8(wt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert _bits(qj) == _bits(qt.numpy())
    assert _bits(sj) == _bits(st.numpy())
    deq = lambda q, s: jax_quant.dequantize_int8(q, s, jnp.float32)  # noqa: E731
    dj = (jax.vmap(deq) if stacked else deq)(qj, sj)
    dt = torch_quant.dequantize_int8(qt, st, torch.float32)
    assert _bits(dj) == _bits(dt.numpy())


def test_quantize_block_transformer_bit_exact():
    cfg = jax_config.make_block_config("t", 128, 2, vocab_size=512)
    params = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(1), cfg))
    qj = jax.device_get(jax_quant.quantize_block_transformer(params, bits=8))
    qt = torch_quant.quantize_block_transformer(
        bridge.params_from_numpy(params, device="cpu"), bits=8)
    flat_j = jax.tree_util.tree_flatten_with_path(qj)[0]
    back = bridge.params_to_numpy(qt)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    n_q8 = 0
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        assert node.dtype == np.asarray(leaf).dtype, path
        assert _bits(node) == _bits(leaf), path
        n_q8 += path[-1].key == "kernel_q8"
    assert n_q8 == 4 + 4 + 2     # qkv/out/up/down of both stacks, expansion, head


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quantize_kv_bit_exact(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 5, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0                              # scale floor
    x[0, 1, 1, :4] = [127.0, 63.5, -0.5, 1.5]     # ties at .5 after scaling
    x = x.astype(dtype)
    xj, xt = _pair(x)
    qj, sj = jax_neox.quantize_kv(xj)
    qt, st = torch_quant.quantize_kv(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert _bits(qj) == _bits(qt.numpy())
    assert _bits(sj) == _bits(st.numpy())
    assert int(np.abs(qt.numpy()).max()) <= 127
