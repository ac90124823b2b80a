"""The plain PyTorch versions of the port's kernels K1-K3 against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

The plain versions are what the port runs on the CPU and what the CUDA
kernels are held to on the card (``tests/test_torch_kernels_gpu.py``).
Inputs are made with numpy and given to both sides; float32 throughout.
Tolerance: rtol 1e-5, and atol 1e-5 of the output's largest magnitude:
both sides compute the same float32 products and differ only in summation
order and in where a scale is multiplied in, so the difference scales with
the size of the sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu.ops import attention as jax_attention
from block_transformer_tpu.ops import decode_attention as jax_da
from block_transformer_tpu.ops import dequant_matmul as jax_dm
from block_transformer_tpu.ops import flash_attention as jax_fa
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu_torch.kernels import decode_attention as k2
from block_transformer_tpu_torch.kernels import dequant_matmul as k1
from block_transformer_tpu_torch.kernels import flash_attention as k3
from block_transformer_tpu_torch.ops import masks as torch_masks


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _masks(q_idx, kv_idx, kv_valid):
    """The same AttnMask for JAX and for the port."""
    return (jax_masks.AttnMask(jnp.asarray(q_idx), jnp.asarray(kv_idx),
                               jnp.asarray(kv_valid)),
            torch_masks.AttnMask(_t(q_idx), _t(kv_idx), _t(kv_valid)))


def _int8_weights(rng, shape):
    w = rng.integers(-127, 128, shape).astype(np.int8)
    s = rng.uniform(0.01, 0.1, shape[:-2] + shape[-1:]).astype(np.float32)
    return w, s


@pytest.mark.parametrize("M,layer", [(8, 2), (20, 1)])
def test_k1_plain_matches_pallas_stacked(M, layer):
    rng = np.random.default_rng(0)
    L, K, N = 3, 256, 384
    x = rng.standard_normal((M, K)).astype(np.float32)
    w, s = _int8_weights(rng, (L, K, N))
    want = jax_dm.int8_matmul_stacked(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(s), layer, interpret=True)
    got = k1.int8_matmul_stacked(_t(x), _t(w), _t(s), layer)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    _close(got.numpy(), want)


def test_k1_plain_matches_pallas_unstacked_ragged_n():
    rng = np.random.default_rng(1)
    M, K, N = 5, 128, 200           # N is not a multiple of 128
    x = rng.standard_normal((M, K)).astype(np.float32)
    w, s = _int8_weights(rng, (K, N))
    want = jax_dm.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                              interpret=True)
    got = k1.int8_matmul(_t(x), _t(w), _t(s))
    assert tuple(got.shape) == (M, N)
    _close(got.numpy(), want)


@pytest.mark.parametrize("S", [1, 3])
def test_k2_plain_matches_pallas(S):
    rng = np.random.default_rng(2)
    L, B, H, cap, D, layer, length = 3, 3, 2, 256, 32, 1, 150
    kq = rng.integers(-127, 128, (L, B, H, cap, D)).astype(np.int8)
    vq = rng.integers(-127, 128, (L, B, H, cap, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (L, B, H, cap)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (L, B, H, cap)).astype(np.float32)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    valid = np.zeros((B, cap), np.int32)
    valid[:, :length + S] = 1        # partly filled cache
    valid[0, :20] = 0                # left-padded row
    valid[1, length - 4:length] = 0  # some invalid slots
    valid[2] = 0                     # a row with no allowed key
    q_idx = length + np.arange(S, dtype=np.int32)
    kv_idx = np.arange(cap, dtype=np.int32)
    mj, mt = _masks(q_idx, kv_idx, valid)
    want = jax_da.decode_attention_int8_stacked(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), layer, mj, interpret=True)
    got = k2.decode_attention_int8_stacked(_t(q), _t(kq), _t(ks), _t(vq),
                                           _t(vs), layer, mt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, S, D)
    _close(got.numpy(), want)


def test_k3_plain_matches_pallas():
    """Block-causal, a left-padded row, Q and K not multiples of the
    Pallas tiles (128). Rows with no allowed key are compared against
    ``attention_xla`` instead: the Pallas kernel pads K with zero rows
    that join such a row's uniform average, while the port (like
    ``attention_xla``) averages the K real keys only."""
    rng = np.random.default_rng(3)
    B, H, Q, K, D, n = 2, 2, 150, 200, 32, 2
    q = rng.standard_normal((B, H, Q, D)).astype(np.float32)
    k = rng.standard_normal((B, H, K, D)).astype(np.float32)
    v = rng.standard_normal((B, H, K, D)).astype(np.float32)
    valid = np.ones((B, K), np.int32)
    valid[1, :60] = 0                                  # left pad
    q_idx = (K - Q + np.arange(Q, dtype=np.int32)) // n
    kv_idx = np.arange(K, dtype=np.int32) // n
    mj, mt = _masks(q_idx, kv_idx, valid)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jax_fa.flash_attention(jq, jk, jv, mj, interpret=True))
    xla = np.asarray(jax_attention.attention_xla(jq, jk, jv, mj))
    got = k3.flash_attention(_t(q), _t(k), _t(v), mt).numpy()
    has_key = np.asarray(mj.allowed()).any(-1)         # [B, Q]
    assert not has_key.all() and has_key.any()
    sel = np.broadcast_to(has_key[:, None, :, None], got.shape)
    _close(got[sel], pallas[sel])
    _close(got[~sel], xla[~sel])
