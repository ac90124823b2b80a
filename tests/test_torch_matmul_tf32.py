"""K1/K4's float32 tensor-core route ("tf32x2") checked on the CPU with no
card.

The kernel (``csrc/dequant_matmul.cu``, ``tf32_matmul_kernel``) takes the
weights unscaled and exact in TF32 (|q| <= 127, nibbles in [-8, 7]) and
splits x alone, hi = tf32(x), lo = tf32(x - hi), rounding as ``cvt.rna``
does; each m16n8k8 slice adds x_lo w and then x_hi w to a chain that starts
from zero at every 32-row step (K1) or plane of a step (K4), the chain is
added to the running float32 sum in a rounded add (K4: after a multiply by
its group's scale), the splits of K are summed in split order, and K1's
channel scale (K4's with G = 1) is applied last. Here a torch model of that
arithmetic over the kernel's steps and splits (``plan``) is held against
JAX's Pallas kernels (``int8_matmul_stacked`` / ``int4_matmul_stacked``,
interpret mode, float32 x) on the same numpy inputs at 1e-5 of the
reference's largest magnitude. The model is pessimistic about the tensor
cores: each slice's eight products join the chain in a sum truncated
toward zero, where the hardware keeps a few more bits. The same model with
one TF32 pass (x_hi alone) misses the limit, so the limit tells the two
apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu.ops import dequant_matmul as jax_dm
from block_transformer_tpu_torch.kernels import dequant_matmul as k1
from block_transformer_tpu_torch.ops import quant
from tests.test_torch_flash_tf32 import split, tf32

REL = 1e-5
SMS = 132           # an H100 SXM's streaming multiprocessors
BK = 32             # the route's K step


def _trunc32(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _chain(xs, w):
    """One chain from zero over a step: for each 8-row slice, x_lo w then
    x_hi w (``xs`` in that order), each slice's eight products added to the
    float32 chain and truncated."""
    c = torch.zeros((xs[0].shape[0], w.shape[1]), dtype=torch.float32)
    w = w.double()
    for kk in range(0, w.shape[0], 8):
        for xp in xs:
            c = _trunc32(c.double() + xp[:, kk:kk + 8].double()
                         @ w[kk:kk + 8])
    return c


def _halves(x, passes: int):
    hi, lo = split(x)
    return (lo, hi) if passes == 2 else (tf32(x),)


def tf32x2_k1(x, w_q, scale, sms=SMS, passes=2):
    """The route's K1: x [M, K] float32, w_q int8 [K, N], scale [N]."""
    M, K = x.shape
    N = w_q.shape[1]
    p = k1.plan(M, K, N, torch.float32, sms)
    assert p.route == "tf32x2" and p.tile[2] == BK
    xs, w = _halves(x, passes), w_q.float()
    out = torch.zeros((M, N), dtype=torch.float32)
    for z in range(p.splits):
        acc = torch.zeros_like(out)
        for k0 in range(z * p.k_per_split,
                        min(K, (z + 1) * p.k_per_split), BK):
            acc = acc + _chain([h[:, k0:k0 + BK] for h in xs],
                               w[k0:k0 + BK])
        out = out + acc
    return out * scale


def tf32x2_k4(x, w_p, scale, sms=SMS, passes=2):
    """The route's K4: x [M, K] float32, w_p int8 [K/2, N] split-half
    packed, scale [G, N] (G = 1 or groups of a multiple of 32 rows)."""
    M, K = x.shape
    Kh, N = w_p.shape
    G = scale.shape[0]
    gs = K // G
    p = k1.plan(M, Kh, N, torch.float32, sms, group=gs)
    assert p.route == "tf32x2" and p.tile[2] == BK
    xs, w = _halves(x, passes), quant.unpack_int4(w_p).float()
    out = torch.zeros((M, N), dtype=torch.float32)
    for z in range(p.splits):
        acc = torch.zeros_like(out)
        for k0 in range(z * p.k_per_split,
                        min(Kh, (z + 1) * p.k_per_split), BK):
            for r in (k0, Kh + k0):           # the low, then the high plane
                ch = _chain([h[:, r:r + BK] for h in xs], w[r:r + BK])
                acc = acc + (ch * scale[r // gs] if G > 1 else ch)
        out = out + acc
    return out * scale[0] if G == 1 else out


def _k1_case(M, K, N=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-127, 128, (2, K, N)).astype(np.int8)
    s = rng.uniform(0.001, 0.02, (2, N)).astype(np.float32)
    want = np.asarray(jax_dm.int8_matmul_stacked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), 1, interpret=True))
    return (torch.from_numpy(x), torch.from_numpy(w[1]),
            torch.from_numpy(s[1])), want


def _k4_case(M, K, G, N=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-128, 128, (2, K // 2, N)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (2, G, N)).astype(np.float32)
    want = np.asarray(jax_dm.int4_matmul_stacked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), 1, interpret=True))
    return (torch.from_numpy(x), torch.from_numpy(w[1]),
            torch.from_numpy(s[1])), want


def _rel_err(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


# (M, K, sms): ragged M at the decode, mid and prefill tiles; K split over
# many blocks (132 SMs) or a few (4 SMs)
K1_CASES = [(7, 2048, SMS), (37, 8192, SMS), (130, 2048, 4), (9, 8192, 4)]
K4_CASES = [(7, 2048, 1, SMS), (37, 2048, 16, SMS), (130, 8192, 16, 4),
            (9, 8192, 1, 4), (20, 8192, 16, SMS)]


@pytest.mark.parametrize("M,K,sms", K1_CASES)
def test_k1_model_matches_pallas(M, K, sms):
    (x, w, s), want = _k1_case(M, K)
    got = tf32x2_k1(x, w, s, sms)
    assert _rel_err(got, want) <= REL, _rel_err(got, want)


@pytest.mark.parametrize("M,K,G,sms", K4_CASES)
def test_k4_model_matches_pallas(M, K, G, sms):
    (x, w, s), want = _k4_case(M, K, G)
    got = tf32x2_k4(x, w, s, sms)
    assert _rel_err(got, want) <= REL, _rel_err(got, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_one_tf32_pass_misses_the_limit(bits):
    """x_hi alone keeps ~2^-11 of each product: the limit refuses it."""
    if bits == 8:
        (x, w, s), want = _k1_case(37, 2048)
        got = tf32x2_k1(x, w, s, passes=1)
    else:
        (x, w, s), want = _k4_case(37, 2048, 16)
        got = tf32x2_k4(x, w, s, passes=1)
    assert _rel_err(got, want) > 3 * REL


def test_weights_are_exact_in_tf32():
    """Every int8 value and nibble has at most 8 significant bits, so tf32
    leaves it as it is and the weights need no split; its product with a
    TF32 half of x is exact in float32."""
    q = torch.arange(-128, 128, dtype=torch.float32)
    nib = quant.unpack_int4(torch.arange(-128, 128, dtype=torch.int8)[None])
    for v in (q, nib.float().flatten()):
        assert torch.equal(tf32(v), v)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(256)
                         .astype(np.float32))
    hi, lo = split(x)
    for h in (hi, lo):
        assert torch.equal((h * q).double(), h.double() * q.double())
