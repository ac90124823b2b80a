"""K3's float32 tensor-core route ("tf32x3") checked on the CPU with no card.

The kernel (``csrc/flash_attention.cu``, ``FaTileF32_*``) computes every
float32 product on the TF32 tensor cores three times over: each operand x
is split as hi = tf32(x), lo = tf32(x - hi), rounding as ``cvt.rna`` does
(to nearest, ties away from zero, 10 mantissa bits), and a . b is taken as
a_lo b_hi + a_hi b_lo + a_hi b_hi in float32. Here a torch model of that
arithmetic, over the kernel's tiles with their skipping and closing pass
(``_flash_skip``), is held against JAX's Pallas kernel (interpret mode) and
``attention_xla`` on the same numpy inputs, at 1e-5 of the reference's
largest magnitude; the same model with one TF32 pass must miss that limit,
so the limit tells the two apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu.ops import attention as jax_attention
from block_transformer_tpu.ops import flash_attention as jax_fa
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu_torch.kernels import flash_attention as k3
from block_transformer_tpu_torch.ops import masks as torch_masks
from block_transformer_tpu_torch.ops.attention import attention_xla
from tests.test_torch_attention_plan import _flash_skip

REL = 1e-5
# (query rows, keys) of the float32 kernel's tiles by head dim
# (FaTileF32_128, FaTileF32_64 in csrc/flash_attention.cu)
TILES = {128: (64, 32), 64: (64, 32)}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as cvt.rna.tf32.f32 does: add half of the 13
    dropped bits' weight to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_tf32x3(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    u = 2.0 ** -10                             # TF32's ulp at 1
    x = torch.tensor([1 + u / 2, -(1 + u / 2), 1 + 1.5 * u, 1 + u / 2
                      - 2.0 ** -23, 1 + u / 4, 3.0, -0.0], dtype=torch.float32)
    want = [1 + u, -(1 + u), 1 + 2 * u, 1.0, 1.0, 3.0, -0.0]
    assert tf32(x).tolist() == want


def test_split_is_float32_close_and_its_products_exact():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * np.exp2(rng.integers(-20, 20, 4096)))
                         .astype(np.float32))
    hi, lo = split(x)
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())
    assert bool(((x - (hi + lo)).abs() <= 2.0 ** -22 * x.abs()).all())
    y = hi.flip(0)                             # 11 x 11 significant bits
    assert torch.equal((hi * y).double(), hi.double() * y.double())


def _case(name):
    """(q, k, v, q_idx, kv_idx, kv_valid) as numpy, float32, and D: ragged Q
    and K at n = 1 and 4 embeddings a block, the last batch row left-padded
    so that its first queries see no key, and unsorted kv_idx."""
    B, H, Q, K, D, n, pad = {
        "ragged_n1": (2, 2, 200, 230, 64, 1, 40),
        "ragged_n4": (2, 2, 130, 200, 128, 4, 100),
        "unsorted": (1, 2, 70, 150, 128, 1, 0),
    }[name]
    rng = np.random.default_rng(len(name))
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for S in (Q, K, K))
    q_idx = ((K - Q + np.arange(Q)) // n).astype(np.int32)
    kv_idx = (np.arange(K) // n).astype(np.int32)
    if name == "unsorted":
        kv_idx = kv_idx[rng.permutation(K)]
        q_idx = q_idx - 100                     # early queries see no key
    valid = np.ones((B, K), np.int32)
    valid[-1, :pad] = 0
    return (q, k, v, np.broadcast_to(q_idx, (B, Q)).copy(), kv_idx, valid), D


def _references(arrays):
    """JAX's Pallas kernel (interpret mode) on rows with an allowed key and
    attention_xla on the rest (the Pallas kernel's zero padding rows join a
    keyless row's mean), and the boolean [B, H, Q, D] of the former."""
    q, k, v, q_idx, kv_idx, valid = arrays
    mj = jax_masks.AttnMask(*(jnp.asarray(a) for a in (q_idx, kv_idx, valid)))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jax_fa.flash_attention(jq, jk, jv, mj,
                                               interpret=True))
    xla = np.asarray(jax_attention.attention_xla(jq, jk, jv, mj))
    has_key = np.asarray(mj.allowed()).any(-1)          # [B, Q]
    assert has_key.any() and not has_key.all()
    sel = np.broadcast_to(has_key[:, None, :, None], q.shape)
    return np.where(sel, pallas, xla), xla


def _model(arrays, D, mm):
    q, k, v, *idx = (torch.from_numpy(a) for a in arrays)
    mask = torch_masks.AttnMask(*idx)
    BQ, BKV = TILES[D]
    out, visited, total = _flash_skip(q, k, v, mask, BQ, BKV, mm=mm)
    return out, visited, total, attention_xla(q, k, v, mask)


def _rel_err(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", ["ragged_n1", "ragged_n4", "unsorted"])
def test_tf32x3_model_matches_jax_and_plain(name):
    arrays, D = _case(name)
    assert k3.route(torch.float32, D, arrays[1].shape[2]) == "tf32x3"
    ref, xla = _references(arrays)
    got, visited, total, plain = _model(arrays, D, mm_tf32x3)
    if name != "unsorted":
        assert visited < total                 # key tiles were skipped
    assert _rel_err(got, ref) <= REL
    assert _rel_err(got, plain.numpy()) <= REL
    assert _rel_err(plain.numpy(), xla) <= REL


def test_one_tf32_pass_misses_the_limit():
    """The float32 route's limit refuses a single TF32 pass: its scores
    keep ~2^-11 of their magnitude, ~1e-4 of the output."""
    arrays, D = _case("ragged_n4")
    ref, _ = _references(arrays)
    err = {name: _rel_err(_model(arrays, D, mm)[0], ref)
           for name, mm in (("tf32", mm_tf32), ("tf32x3", mm_tf32x3))}
    assert err["tf32x3"] <= REL < err["tf32"], err
    assert err["tf32"] > 10 * err["tf32x3"], err

