"""The plain PyTorch versions of the port's K5-K8 against the JAX package's
Pallas kernels of ``ops/paged_attention.py``, run in interpret mode on the
CPU, as ``tests/test_paged_attention.py`` runs them.

Inputs are made with numpy and given to both sides. Writes must be equal
bit for bit (the pools are compared whole, except page 0 where dead rows
may collide); attention within 1e-5 in float32 (both sides compute the
same float32 products, summed in another order and with the key scale
applied to the score on one side and to the key on the other).

The port drops a write whose target is out of range; the JAX reference
clamps it instead. That deliberate difference is tested here against the
untouched pool, not against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu.ops import paged_attention as jax_pa
from block_transformer_tpu_torch.kernels import paged_attention as kp
from block_transformer_tpu_torch.ops import masks as torch_masks


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(rng, L, P, H, ps, D):
    return (rng.integers(-127, 128, (L, P, H, ps, D)).astype(np.int8),
            rng.uniform(0.01, 0.02, (L, P, H, ps)).astype(np.float32),
            rng.integers(-127, 128, (L, P, H, ps, D)).astype(np.int8),
            rng.uniform(0.01, 0.02, (L, P, H, ps)).astype(np.float32))


def _step(rng, lead, H, D):
    """(kq, ks, vq, vs) for one decode step: int8 [*lead, H, D], f32
    [*lead, H]."""
    return (rng.integers(-7, 8, (*lead, H, D)).astype(np.int8),
            rng.normal(size=(*lead, H)).astype(np.float32),
            rng.integers(-7, 8, (*lead, H, D)).astype(np.int8),
            rng.normal(size=(*lead, H)).astype(np.float32))


def _assert_pools_equal(got, want, skip_page0=False):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if skip_page0:
            g, w = g[:, 1:], w[:, 1:]
        np.testing.assert_array_equal(g, w)


def _attention_case(rng, L, B, H, D, ps, n_virt, null_tail=False):
    cap = ps * n_virt
    n_pool = B * n_virt + 2
    pools = _pools(rng, L, n_pool, H, ps, D)
    perm = rng.permutation(np.arange(1, n_pool))[:B * n_virt]
    pt = perm.reshape(B, n_virt).astype(np.int32)
    lengths = rng.integers(1, cap, B)
    if null_tail:                     # row 0's tail pages on the null page
        pt[0, 1:] = 0
        lengths[0] = ps - 3
    kv_valid = (np.arange(cap)[None] < lengths[:, None]).astype(np.int32)
    kv_valid[-1, :2] = 0              # a left-padded row
    return pools, pt, lengths, kv_valid


@pytest.mark.parametrize("npp,null_tail,S", [
    (None, False, 1),
    ("1", False, 1),                  # multi-group online softmax
    ("1", True, 1),                   # null page masked, multi-group
    (None, True, 3),                  # three query rows
])
def test_k6_plain_matches_pallas(npp, null_tail, S, monkeypatch):
    if npp is not None:
        monkeypatch.setenv("BT_PAGED_NPP", npp)
    rng = np.random.default_rng(0)
    L, B, H, D, ps, n_virt = 2, 3, 2, 128, 128, 3
    pools, pt, lengths, kv_valid = _attention_case(rng, L, B, H, D, ps,
                                                   n_virt, null_tail)
    if null_tail:                     # scribble over the null page
        for a, val in ((pools[0], 99), (pools[2], -99)):
            a[:, 0] = val
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    q_idx = (lengths[:, None] - S + np.arange(S)[None]).astype(np.int32)
    kv_idx = np.arange(ps * n_virt, dtype=np.int32)
    layer = 1
    want = jax_pa.paged_decode_attention_int8(
        jnp.asarray(q), *map(jnp.asarray, pools), layer, jnp.asarray(pt),
        jax_masks.AttnMask(jnp.asarray(q_idx), jnp.asarray(kv_idx),
                           jnp.asarray(kv_valid)), interpret=True)
    got = kp.paged_decode_attention_int8(
        _t(q), *map(_t, pools), layer, _t(pt),
        torch_masks.AttnMask(_t(q_idx), _t(kv_idx), _t(kv_valid)))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("npp", [None, "1"])
def test_k6_plain_with_fresh_matches_pallas(npp, monkeypatch):
    """The deferred write: the pool as it was, the fresh pair dequantized
    and ``q_idx - 1``; one row's query at position 0 (no pool key)."""
    if npp is not None:
        monkeypatch.setenv("BT_PAGED_NPP", npp)
    rng = np.random.default_rng(1)
    L, B, H, D, ps, n_virt = 2, 4, 2, 128, 128, 2
    pools, pt, lengths, kv_valid = _attention_case(rng, L, B, H, D, ps,
                                                   n_virt)
    lengths[-1] = 0
    kv_valid = (np.arange(ps * n_virt)[None]
                <= lengths[:, None]).astype(np.int32)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kf = (rng.integers(-7, 8, (B, H, D))
          * rng.uniform(0.01, 0.02, (B, H, 1))).astype(np.float32)
    vf = (rng.integers(-7, 8, (B, H, D))
          * rng.uniform(0.01, 0.02, (B, H, 1))).astype(np.float32)
    q_idx = (lengths[:, None] - 1).astype(np.int32)
    kv_idx = np.arange(ps * n_virt, dtype=np.int32)
    want = jax_pa.paged_decode_attention_int8(
        jnp.asarray(q), *map(jnp.asarray, pools), 0, jnp.asarray(pt),
        jax_masks.AttnMask(jnp.asarray(q_idx), jnp.asarray(kv_idx),
                           jnp.asarray(kv_valid)),
        fresh=(jnp.asarray(kf), jnp.asarray(vf)), interpret=True)
    got = kp.paged_decode_attention_int8(
        _t(q), *map(_t, pools), 0, _t(pt),
        torch_masks.AttnMask(_t(q_idx), _t(kv_idx), _t(kv_valid)),
        fresh=(_t(kf), _t(vf)))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="S == 1"):
        kp.paged_decode_attention_int8(
            _t(np.repeat(q, 2, axis=2)), *map(_t, pools), 0, _t(pt),
            torch_masks.AttnMask(_t(np.repeat(q_idx, 2, 1)), _t(kv_idx),
                                 _t(kv_valid)), fresh=(_t(kf), _t(vf)))


@pytest.mark.parametrize("identity", [False, True])
def test_k5_plain_matches_pallas(identity):
    """Distinct pages, and the contiguous cache's identity page table
    (pool [L, B, H, cap, D], page = arange(B), off = each row's frontier)."""
    rng = np.random.default_rng(2)
    L, H, D, B = 3, 4, 128, 5
    P, ps = (B, 32) if identity else (9, 16)
    pools = _pools(rng, L, P, H, ps, D)
    page = (np.arange(B) if identity
            else rng.permutation(np.arange(1, P))[:B]).astype(np.int32)
    off = rng.integers(0, ps, B).astype(np.int32)
    step = _step(rng, (B,), H, D)
    layer = 1
    want = jax_pa.paged_write_int8(
        *map(jnp.asarray, pools), layer,
        jnp.asarray(page), jnp.asarray(off), *map(jnp.asarray, step),
        interpret=True)
    got = kp.paged_write_int8(*map(_t, pools), layer, _t(page), _t(off),
                              *map(_t, step))
    _assert_pools_equal(got, want)


def test_k7_plain_matches_pallas_and_per_layer_writes():
    rng = np.random.default_rng(3)
    L, P, H, ps, D, B = 4, 9, 4, 16, 128, 5
    pools = _pools(rng, L, P, H, ps, D)
    page = rng.permutation(np.arange(1, P))[:B].astype(np.int32)
    off = rng.integers(0, ps, B).astype(np.int32)
    step = _step(rng, (L, B), H, D)
    want = jax_pa.paged_write_layers_int8(
        *map(jnp.asarray, pools), jnp.asarray(page), jnp.asarray(off),
        *map(jnp.asarray, step), interpret=True)
    got = kp.paged_write_layers_int8(*map(_t, pools), _t(page), _t(off),
                                     *map(_t, step))
    _assert_pools_equal(got, want)
    per_layer = tuple(map(_t, pools))
    for layer in range(L):
        per_layer = kp.paged_write_int8(*per_layer, layer, _t(page), _t(off),
                                        *(_t(a[layer]) for a in step))
    _assert_pools_equal(got, per_layer)


def test_k8_plain_matches_pallas():
    """Rows' pages land at their pool pages; one row's tail on page 0 and a
    padded duplicate row (pages other than 0 compared)."""
    rng = np.random.default_rng(4)
    L, P, H, ps, D, G, nv = 2, 11, 4, 16, 128, 4, 2
    pools = _pools(rng, L, P, H, ps, D)
    pt = np.asarray([[1, 2], [3, 4], [5, 0], [5, 0]], np.int32)
    rows = [rng.integers(-7, 8, (L, G, H, nv * ps, D)).astype(np.int8),
            rng.normal(size=(L, G, H, nv * ps)).astype(np.float32),
            rng.integers(-7, 8, (L, G, H, nv * ps, D)).astype(np.int8),
            rng.normal(size=(L, G, H, nv * ps)).astype(np.float32)]
    for a in rows:
        a[:, 3] = a[:, 2]                # the padded duplicate of row 2
    want = jax_pa.paged_page_copy_int8(
        *map(jnp.asarray, pools), jnp.asarray(pt), *map(jnp.asarray, rows),
        interpret=True)
    got = kp.paged_page_copy_int8(*map(_t, pools), _t(pt), *map(_t, rows))
    _assert_pools_equal(got, want, skip_page0=True)


def test_out_of_range_writes_leave_the_pool_unchanged():
    """K5 with off == ps (a finished slot at the end of its capacity) or a
    page outside [0, P), K7 likewise, K8 with pt_rows outside [0, P): those
    targets are dropped, the in-range ones written."""
    rng = np.random.default_rng(5)
    L, P, H, ps, D, B = 2, 6, 2, 8, 32, 4
    pools = _pools(rng, L, P, H, ps, D)
    page = np.asarray([1, 2, 6, -1], np.int32)
    off = np.asarray([ps, 3, 0, 0], np.int32)       # rows 0, 2, 3 dropped
    step = _step(rng, (B,), H, D)
    got = kp.paged_write_int8(*map(_t, pools), 1, _t(page), _t(off),
                              *map(_t, step))
    want = [a.copy() for a in pools]
    want[0][1, 2, :, 3], want[1][1, 2, :, 3] = step[0][1], step[1][1]
    want[2][1, 2, :, 3], want[3][1, 2, :, 3] = step[2][1], step[3][1]
    _assert_pools_equal(got, want)

    step_l = _step(rng, (L, B), H, D)
    got = kp.paged_write_layers_int8(*map(_t, pools), _t(page), _t(off),
                                     *map(_t, step_l))
    want = [a.copy() for a in pools]
    for w, s in zip(want, step_l):
        w[:, 2, :, 3] = s[:, 1]
    _assert_pools_equal(got, want)

    pt = np.asarray([[3, P], [-2, 4]], np.int32)
    rows = [rng.integers(-7, 8, (L, 2, H, 2 * ps, D)).astype(np.int8),
            rng.normal(size=(L, 2, H, 2 * ps)).astype(np.float32),
            rng.integers(-7, 8, (L, 2, H, 2 * ps, D)).astype(np.int8),
            rng.normal(size=(L, 2, H, 2 * ps)).astype(np.float32)]
    got = kp.paged_page_copy_int8(*map(_t, pools), _t(pt), *map(_t, rows))
    want = [a.copy() for a in pools]
    for w, r in zip(want, rows):
        w[:, 3] = r[:, 0, :, :ps]
        w[:, 4] = r[:, 1, :, ps:]
    _assert_pools_equal(got, want)


def test_identity_pool_off_equal_cap_is_dropped():
    """The contiguous INT8 cache as a pool (ps = cap): a row whose frontier
    reached cap writes nothing, the others write at their frontier."""
    rng = np.random.default_rng(6)
    L, B, H, cap, D = 2, 3, 2, 20, 64
    pools = _pools(rng, L, B, H, cap, D)
    off = np.asarray([cap, 0, cap - 1], np.int32)
    step = _step(rng, (B,), H, D)
    got = kp.paged_write_int8(*map(_t, pools), 0,
                              _t(np.arange(B, dtype=np.int32)), _t(off),
                              *map(_t, step))
    want = [a.copy() for a in pools]
    for w, s in zip(want, step):
        w[0, 1, :, 0] = s[1]
        w[0, 2, :, cap - 1] = s[2]
    _assert_pools_equal(got, want)
