"""The port's CUDA kernels K1-K8, W8A8-q and W8A8-mm against their plain
PyTorch versions, on the card, at small and ragged shapes (W8A8 also at the
prefill's M = 4096, bit for bit); and the launch counters. K2 is held
in both its forms (INT8 and the bf16/float32 cache; the latter by its
warp route at caps up to 32 and its split route past them, each case
asserting the route), K6 on INT8 and packed INT4 pools, K8 on both pool
widths.

Marked ``gpu``: each test skips, from inside its body, when no CUDA device
is present. This file imports torch and the port only (no JAX), so on a
machine with a card it runs on its own:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: float32 kernel vs float32 plain version differ only in the
order of float32 sums, so 1e-4 (abs and rel); bf16 outputs carry one bf16
rounding (2^-8 relative) on each side, so 1e-2 of the output's largest
magnitude (K4's tensor-core route also rounds each scaled weight to bf16,
2^-9 relative, which sums to far less). K1 and K4 cases assert which route
``plan`` took: bf16 x with K (K/2) a multiple of 32 and N of 16 goes to the
tensor cores, float32 x and ragged shapes to the CUDA cores; K3 cases
assert the route ``route`` took (bf16 with D = 64 or 128 on the tensor
cores, float32 and other head dims on the CUDA cores); W8A8-mm cases
assert its one route, ``wgmma``. K2 cases cover one
split and several (``plan``), with splits whose every slot is masked; K6
cases too (K2's ``plan`` over the virtual slots), with splits whose every
tile is skipped, rows with no allowed key, page ids outside [0, P), and
the merge counters left at zero after each launch. The
pool writes and page copies (K5, K7, K8) are compared bit for bit, outside
page 0 where dead rows may collide.

The quantization workflow on the card: every wrapper refuses inputs that
require grad under grad mode and launches under ``torch.no_grad()``; the
weight quantizers, the QAT round trips and the KV quantizer equal the
CPU's bit for bit;
``gptq_round`` and two train steps (plain and QAT) against the CPU, each
with its tolerance in its docstring.
"""

import functools

import pytest
import torch

from block_transformer_tpu_torch.kernels import build
from block_transformer_tpu_torch.kernels import decode_attention as k2
from block_transformer_tpu_torch.kernels import dequant_matmul as k1
from block_transformer_tpu_torch.kernels import flash_attention as k3
from block_transformer_tpu_torch.kernels import paged_attention as kp
from block_transformer_tpu_torch.kernels import w8a8
from block_transformer_tpu_torch.ops import masks
from block_transformer_tpu_torch.ops import quant

pytestmark = pytest.mark.gpu

F32_TOL = 1e-4
BF16_REL = 1e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_REL * want.float().abs().max().item(), err


def _route(dtype, K, N):
    """The route plan() must take (K: rows of the weight, packed for K4)."""
    return "tc" if dtype == torch.bfloat16 and K % 32 == 0 and N % 16 == 0 \
        else "fma"


def _routed(fn, route, call):
    """call(); asserts it launched once, by ``route``."""
    before = dict(fn.route_launches)
    out = call()
    after = dict(fn.route_launches)
    assert after[route] == before[route] + 1, (route, before, after)
    assert sum(after.values()) == sum(before.values()) + 1
    return out


# the tensor-core cases: every row tile and the ragged M edge, at the main
# path's K (K/2 for K4) and a narrow and a wide N; x is scaled by
# sqrt(32 / K) (K1) or sqrt(128 / (K/2)) (K4) there, so outputs stay a few
# units at every K and the float32 cases' absolute 1e-4 stays above float32
# summation noise
TC_M = (1, 8, 16, 17, 32, 64, 130, 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,L,layer,x_scale", [
    (1, 32, 8, 1, 0, 1.0),         # smallest
    (3, 100, 37, 2, 1, 1.0),       # ragged K and N (scalar weight loads)
    (17, 256, 200, 3, 2, 1.0),     # M > 16: 64-row tiles
    (70, 96, 136, 2, 0, 1.0),      # ragged M tile
    (8, 2048, 384, 2, 1, 1.0),     # decode shape: K split over blocks
] + [(M, K, N, 2, 1, (32 / K) ** 0.5)
     for M in TC_M for K in (2048, 8192) for N in (384, 6144)])
def test_k1_matches_plain(M, K, N, L, layer, x_scale, dtype):
    g = _card()
    w_q, scale = quant.quantize_int8(
        torch.randn((L, K, N), generator=g, device="cuda"))
    x = (x_scale * torch.randn((M, K), generator=g, device="cuda")).to(dtype)
    got = _routed(k1.int8_matmul_stacked, _route(dtype, K, N),
                  lambda: k1.int8_matmul_stacked(x, w_q, scale, layer))
    _close(got, k1.int8_matmul_stacked_plain(x, w_q, scale, layer), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,Kh,N,G,L,layer,legacy,x_scale", [
    (1, 64, 32, 1, 1, 0, True, 1.0),       # smallest, per-channel [L, N]
    (8, 1024, 384, 16, 2, 1, False, 1.0),  # decode shape: K split
    (16, 100, 37, 4, 2, 1, False, 1.0),    # ragged K/2 and N, groups of 50
    (17, 256, 200, 2, 3, 2, False, 1.0),   # M > 16: 64-row tiles, ragged N
    (64, 96, 136, 1, 2, 0, False, 1.0),    # ragged K/2 tile, one group
    (300, 256, 256, 8, 2, 1, False, 1.0),  # ragged M tile, groups of 64
    # tensor cores with groups that split a 32-row step: each row's scales
    (8, 96, 128, 4, 2, 1, False, 1.0),     # groups of 48, decode tile
    (40, 192, 256, 8, 2, 1, False, 1.0),   # groups of 48, 64-row tile
    (130, 1024, 384, 128, 2, 1, False, (128 / 1024) ** 0.5),  # groups of 16
] + [  # G = 1, groups of 64 rows and of 128, in turn
    (M, Kh, N, (1, 2 * Kh // 64, 2 * Kh // 128)[(i + j) % 3], 2, 1, False,
     (128 / Kh) ** 0.5)
    for i, M in enumerate(TC_M)
    for j, (Kh, N) in enumerate([(1024, 384), (1024, 6144), (4096, 384),
                                 (4096, 6144)])])
def test_k4_matches_plain(M, Kh, N, G, L, layer, legacy, x_scale, dtype):
    """Random packed bytes (every nibble, -8 included) and scales."""
    g = _card()
    w_p = torch.randint(-128, 128, (L, Kh, N), generator=g, device="cuda",
                        dtype=torch.int8)
    scale = 0.01 + 0.1 * torch.rand((L, G, N), generator=g, device="cuda")
    if legacy:
        scale = scale[:, 0].contiguous()
    x = (x_scale * torch.randn((M, 2 * Kh), generator=g,
                               device="cuda")).to(dtype)
    got = _routed(k1.int4_matmul_stacked, _route(dtype, Kh, N),
                  lambda: k1.int4_matmul_stacked(x, w_p, scale, layer))
    _close(got, k1.int4_matmul_stacked_plain(x, w_p, scale, layer), dtype)
    p = k1.plan(M, Kh, N, dtype, 132)
    assert p.route == _route(dtype, Kh, N)
    if M <= 16 and Kh == 1024 and N == 384:         # decode: K is split
        assert p.splits > 1


def test_k4_raises_and_counts():
    """A group straddling the split half, a wrong dtype or a strided operand
    raises; a launch counts once, the plain version on the CPU not at all."""
    g = _card()
    x = torch.randn((4, 192), generator=g, device="cuda")
    w_p = torch.randint(-128, 128, (1, 96, 64), generator=g, device="cuda",
                        dtype=torch.int8)
    with pytest.raises(ValueError, match="straddle"):
        k1.int4_matmul_stacked(x, w_p, torch.ones((1, 3, 64), device="cuda"),
                               0)                    # groups of 64 rows, 96
    with pytest.raises(TypeError):
        k1.int4_matmul_stacked(x, w_p, torch.ones((1, 2, 64), device="cuda",
                                                  dtype=torch.float64), 0)
    with pytest.raises(ValueError, match="contiguous"):
        k1.int4_matmul_stacked(x, w_p.transpose(1, 2).contiguous().transpose(
            1, 2), torch.ones((1, 2, 64), device="cuda"), 0)
    scale = torch.ones((1, 2, 64), device="cuda")
    before = k1.int4_matmul_stacked.launches
    k1.int4_matmul(x, w_p[0], scale[0])
    assert k1.int4_matmul_stacked.launches == before + 1
    k1.int4_matmul(x.cpu(), w_p[0].cpu(), scale[0].cpu())
    assert k1.int4_matmul_stacked.launches == before + 1


def _int8_cache(g, L, B, H, cap, D):
    kv = torch.randn((2, L * B, H, cap, D), generator=g, device="cuda")
    kq, ks = quant.quantize_kv(kv[0])
    vq, vs = quant.quantize_kv(kv[1])
    return (kq.reshape(L, B, H, cap, D), ks.reshape(L, B, H, cap),
            vq.reshape(L, B, H, cap, D), vs.reshape(L, B, H, cap))


def _int8_cache_exact(g, L, B, H, cap, D):
    """Random int8 values with power-of-two scales: the plain version's
    bf16 dequantized cache is then exact, so at long caches, where outputs
    average thousands of values and come out small, the bf16 comparison
    sees the kernel's rounding and not the plain version's."""
    def i8():
        return torch.randint(-127, 128, (L, B, H, cap, D), generator=g,
                             device="cuda", dtype=torch.int8)

    def pow2():
        return torch.pow(2.0, -torch.randint(
            6, 9, (L, B, H, cap), generator=g, device="cuda").float())

    return i8(), pow2(), i8(), pow2()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,D,L,cap,length", [
    (2, 3, 1, 32, 2, 40, 30),      # capacity not a multiple of 32
    (3, 2, 3, 64, 2, 100, 50),     # S = 3
    (1, 2, 8, 128, 3, 300, 290),   # S = 8, several tiles per warp
])
def test_k2_matches_plain(B, H, S, D, L, cap, length, dtype):
    g = _card()
    kq, ks, vq, vs = _int8_cache(g, L, B, H, cap, D)
    q = torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
    valid = torch.ones((B, cap), dtype=torch.int32, device="cuda")
    valid[:, length + S:] = 0
    valid[0, :3] = 0                   # left pad
    if B > 1:
        valid[-1] = 0                  # a row with no allowed key
    mask = masks.decode_mask(length, cap, S, valid, device="cuda")
    got = k2.decode_attention_int8_stacked(q, kq, ks, vq, vs, L - 1, mask)
    want = k2.decode_attention_int8_stacked_plain(q, kq, ks, vq, vs, L - 1,
                                                  mask)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("cap,length", [(40, 17), (640, 530), (2176, 2100),
                                        (2176, 90)])
def test_k2_split_matches_plain(cap, length, S, D, dtype):
    """B = 3, H = 4: few (b, h) pairs, so the cache is split as plan() says;
    row 1 has no allowed key, row 2 is left-padded; at length 90 of 2176
    every split but the first is fully masked."""
    g = _card()
    B, H, L = 3, 4, 2
    kq, ks, vq, vs = _int8_cache_exact(g, L, B, H, cap, D)
    q = torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
    valid = torch.ones((B, cap), dtype=torch.int32, device="cuda")
    valid[:, length + S:] = 0
    valid[1] = 0
    valid[2, :length // 3] = 0
    mask = masks.decode_mask(length, cap, S, valid, device="cuda")
    p = k2.plan(B, H, cap, build.sm_count(0))
    assert p.splits > 1
    assert p.splits * p.slots_per_split >= cap > (p.splits - 1) * p.slots_per_split
    got = k2.decode_attention_int8_stacked(q, kq, ks, vq, vs, 1, mask)
    want = k2.decode_attention_int8_stacked_plain(q, kq, ks, vq, vs, 1, mask)
    _close(got, want, dtype)


def test_k2_counters_are_left_at_zero():
    """Two launches in a row on one stream, each merging its splits through
    the arrival counters, give the same output bit for bit."""
    g = _card()
    B, H, S, D, cap = 2, 4, 1, 64, 2176
    kq, ks, vq, vs = _int8_cache_exact(g, 1, B, H, cap, D)
    q = torch.randn((B, H, S, D), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    mask = masks.decode_mask(2000, cap, S, device="cuda")
    assert k2.plan(B, H, cap, build.sm_count(0)).splits > 1
    first = k2.decode_attention_int8_stacked(q, kq, ks, vq, vs, 0, mask)
    second = k2.decode_attention_int8_stacked(q, kq, ks, vq, vs, 0, mask)
    assert torch.equal(first, second)
    _close(second, k2.decode_attention_int8_stacked_plain(
        q, kq, ks, vq, vs, 0, mask), torch.bfloat16)
    _, ctr = build.scratch(0, build.raw_stream(0), 0, 0)
    assert not bool(ctr.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,D,cap,length", [
    (8, 16, 1, 128, 6, 5),          # the token decoder's local cache
    (8, 16, 2, 128, 6, 0),          # its prefix step
    (3, 4, 1, 32, 40, 17),          # capacity not a multiple of 32
    (3, 4, 8, 64, 2176, 2100),      # several splits, S = 8
    (3, 4, 3, 128, 2176, 90),       # every split but the first masked
    (3, 4, 1, 128, 640, 530),       # the block decoder's capacity
    (64, 16, 1, 64, 64, 50),        # one split: B*H fills the card
    (2, 3, 8, 32, 300, 290),
])
def test_k2_float_cache_matches_plain(B, H, S, D, cap, length, dtype):
    """K2's unquantized form: row 0 left-padded, row 1 (when B > 2) with no
    allowed key."""
    g = _card()
    L = 2
    k, v = (torch.randn((L, B, H, cap, D), generator=g, device="cuda"
                        ).to(dtype) for _ in range(2))
    q = torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
    valid = torch.ones((B, cap), dtype=torch.int32, device="cuda")
    valid[:, length + S:] = 0
    valid[0, :min(3, length)] = 0
    if B > 2:
        valid[1] = 0
    mask = masks.decode_mask(length, cap, S, valid, device="cuda")
    before = (k2.decode_attention_stacked.launches,
              k2.decode_attention_int8_stacked.launches)
    got = k2.decode_attention_stacked(q, k, v, L - 1, mask)
    assert (k2.decode_attention_stacked.launches,
            k2.decode_attention_int8_stacked.launches) == (before[0] + 1,
                                                           before[1])
    _close(got, k2.decode_attention_stacked_plain(q, k, v, L - 1, mask),
           dtype)


def test_k2_float_cache_counters_are_left_at_zero():
    """Two launches in a row, each merging its splits, give the same bits;
    a cache of another dtype than q is refused."""
    g = _card()
    B, H, S, D, cap = 2, 4, 1, 128, 2176
    k, v = (torch.randn((1, B, H, cap, D), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn((B, H, S, D), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    mask = masks.decode_mask(2000, cap, S, device="cuda")
    assert k2.plan(B, H, cap, build.sm_count(0)).splits > 1
    first = k2.decode_attention_stacked(q, k, v, 0, mask)
    second = k2.decode_attention_stacked(q, k, v, 0, mask)
    assert torch.equal(first, second)
    _close(second, k2.decode_attention_stacked_plain(q, k, v, 0, mask),
           torch.bfloat16)
    _, ctr = build.scratch(0, build.raw_stream(0), 0, 0)
    assert not bool(ctr.any())
    with pytest.raises(TypeError, match="both"):
        k2.decode_attention_stacked(q.float(), k, v, 0, mask)


def _k2_mask(case, B, S, cap, length):
    """``case``: "1d" (the token decoder's mask: [S] q_idx at positions
    length..length+S-1, no kv_valid) or "2d" ([B, S] q_idx, each row at
    its own position, and a kv_valid: row 0 left-padded, the last row with
    no valid slot)."""
    if case == "1d":
        return masks.decode_mask(length, cap, S, device="cuda")
    q_idx = (torch.arange(S, device="cuda")[None]
             + torch.arange(B, device="cuda")[:, None] % 3 + length - 2)
    valid = torch.ones((B, cap), dtype=torch.int32, device="cuda")
    valid[0, :min(2, cap - 1)] = 0
    valid[-1] = 0
    return masks.AttnMask(q_idx.int(), torch.arange(cap, dtype=torch.int32,
                                                    device="cuda"), valid)


def _k2_routed(q, k, v, layer, mask, route):
    """decode_attention_stacked(); asserts it launched once, by ``route``."""
    return _routed(k2.decode_attention_stacked, route,
                   lambda: k2.decode_attention_stacked(q, k, v, layer, mask))


@pytest.mark.parametrize("case", ["1d", "2d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 2, 3, 8])
@pytest.mark.parametrize("cap", [1, 5, 6, 9, 31, 32])
def test_k2_warp_route_matches_plain(cap, S, D, dtype, case):
    """The warp route at every cap it takes, layer 1 of 2; queries start
    at position cap - S, so with S > cap the first rows see no slot (the
    uniform mean), as does the "2d" case's last batch row."""
    g = _card()
    B, H, L = 5, 3, 2
    k, v = (torch.randn((L, B, H, cap, D), generator=g, device="cuda"
                        ).to(dtype) for _ in range(2))
    q = torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
    mask = _k2_mask(case, B, S, cap, cap - S)
    got = _k2_routed(q, k, v, 1, mask, "warp")
    _close(got, k2.decode_attention_stacked_plain(q, k, v, 1, mask), dtype)


def test_k2_warp_route_blocks_of_several_warps():
    """B*H = 15 (b, h) warps in blocks of 4: the last block is partly
    empty."""
    g = _card()
    B, H, S, D, cap = 3, 5, 2, 128, 6
    k, v = (torch.randn((1, B, H, cap, D), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn((B, H, S, D), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    mask = masks.decode_mask(0, cap, S, device="cuda")
    got = _k2_routed(q, k, v, 0, mask, "warp")
    _close(got, k2.decode_attention_stacked_plain(q, k, v, 0, mask),
           torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("B,H,cap,length", [
    (3, 4, 33, 20),           # one slot past the warp route; two splits
    (8, 16, 640, 530),        # the block decoder's decode step
    (3, 4, 2176, 2100),       # the baseline's capacity, many tiles a split
])
def test_k2_split_route_ring_matches_plain(B, H, cap, length, S, D, dtype):
    """The float split route's cp.async ring, with the "2d" mask; the merge
    counters are left at zero."""
    g = _card()
    L = 2
    k, v = (torch.randn((L, B, H, cap, D), generator=g, device="cuda"
                        ).to(dtype) for _ in range(2))
    q = torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
    mask = _k2_mask("2d", B, S, cap, length)
    got = _k2_routed(q, k, v, 1, mask, "split")
    _close(got, k2.decode_attention_stacked_plain(q, k, v, 1, mask), dtype)
    _, ctr = build.scratch(0, build.raw_stream(0), 0, 0)
    assert not bool(ctr.any())


@pytest.mark.parametrize("S", [1, 2])
def test_k2_int8_batched_q_idx(S):
    """The INT8 form with a [B, S] q_idx (row stride S), as the engine
    gives it, against its plain version."""
    g = _card()
    B, H, D, cap = 4, 4, 128, 640
    kq, ks, vq, vs = _int8_cache(g, 1, B, H, cap, D)
    q = torch.randn((B, H, S, D), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    mask = _k2_mask("2d", B, S, cap, 500)
    got = k2.decode_attention_int8_stacked(q, kq, ks, vq, vs, 0, mask)
    _close(got, k2.decode_attention_int8_stacked_plain(q, kq, ks, vq, vs, 0,
                                                       mask), torch.bfloat16)


def _k3_routed(q, k, v, mask, route):
    """flash_attention(); asserts it launched once, by ``route``."""
    return _routed(k3.flash_attention, route,
                   lambda: k3.flash_attention(q, k, v, mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Q,K,D,n", [
    (2, 2, 10, 70, 32, 1),     # ragged K tile, left pad
    (1, 3, 130, 200, 64, 2),   # ragged Q tiles, two embeddings per block
    (2, 1, 64, 64, 128, 1),    # exact tiles
    (1, 2, 33, 90, 80, 1),     # head dim 80: masked accumulator columns
    (2, 2, 9, 130, 40, 4),     # head dim 40, four embeddings per block
])
def test_k3_matches_plain(B, H, Q, K, D, n, dtype):
    g = _card()
    q, k, v = (torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
               for S in (Q, K, K))
    valid = torch.ones((B, K), dtype=torch.int32, device="cuda")
    valid[-1, :12] = 0         # left pad (queries before slot 12 see no key)
    full = masks.block_decode_mask(K - Q, K, Q, valid, n)
    route = "tc" if dtype == torch.bfloat16 and D in (64, 128) else "fma"
    got = _k3_routed(q, k, v, full, route)
    _close(got, k3.flash_attention_plain(q, k, v, full), dtype)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Q,K,n", [
    (1, 70, 1), (9, 200, 2), (130, 2176, 4), (130, 70, 1), (9, 2176, 1),
    (1, 200, 4), (64, 64, 2), (200, 130, 1),
])
def test_k3_tensor_cores_match_plain(Q, K, n, D):
    """bf16 on the tensor cores: ragged Q and K, block-causal masks with n
    embeddings a block, a left-padded batch row whose first queries see no
    key (the closing pass), and key tiles skipped past the diagonal."""
    g = _card()
    B, H = 2, 3
    q, k, v = (torch.randn((B, H, S, D), generator=g, device="cuda").to(
        torch.bfloat16) for S in (Q, K, K))
    valid = torch.ones((B, K), dtype=torch.int32, device="cuda")
    valid[-1, :min(K - 1, 2 * n + 5)] = 0      # left pad
    mask = masks.block_decode_mask(max(0, K - Q), K, Q, valid, n)
    got = _k3_routed(q, k, v, mask, "tc")
    _close(got, k3.flash_attention_plain(q, k, v, mask), torch.bfloat16)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", ["causal", "unsorted", "all_masked",
                                  "prefix", "left_padded_prompt"])
def test_k3_tensor_core_masks(case, D):
    """causal: Q = 512 against K = 576 (a prompt after 64 cached slots);
    unsorted: kv_idx permuted, so skipping may not assume order;
    all_masked: a batch row with no valid key at all; prefix: queries that
    see only the first key tile of a long K; left_padded_prompt: a fresh
    prefill tile whose first rows see no key while later tiles are
    skipped."""
    g = _card()
    B, H = 2, 2
    Q, K = (512, 576) if case == "causal" else (70, 700)
    q, k, v = (torch.randn((B, H, S, D), generator=g, device="cuda").to(
        torch.bfloat16) for S in (Q, K, K))
    valid = torch.ones((B, K), dtype=torch.int32, device="cuda")
    q_idx = torch.arange(K - Q, K, dtype=torch.int32, device="cuda")
    kv_idx = torch.arange(K, dtype=torch.int32, device="cuda")
    if case == "unsorted":
        kv_idx = kv_idx[torch.randperm(K, generator=g, device="cuda")]
        q_idx = q_idx - 300
    elif case == "all_masked":
        valid[0] = 0
    elif case == "prefix":
        q_idx = torch.arange(Q, dtype=torch.int32, device="cuda") // 8
    elif case == "left_padded_prompt":
        q_idx = torch.arange(Q, dtype=torch.int32, device="cuda")
        valid[1, :40] = 0
    mask = masks.AttnMask(q_idx, kv_idx.contiguous(), valid)
    got = _k3_routed(q, k, v, mask, "tc")
    _close(got, k3.flash_attention_plain(q, k, v, mask), torch.bfloat16)


def test_launch_counters_move_on_the_card_only():
    g = _card()
    cpu = torch.Generator().manual_seed(0)
    w_q, scale = quant.quantize_int8(torch.randn((1, 64, 64), generator=cpu))
    x = torch.randn((4, 64), generator=cpu)
    before = k1.int8_matmul_stacked.launches
    k1.int8_matmul_stacked(x, w_q, scale, 0)                  # CPU: plain
    assert k1.int8_matmul_stacked.launches == before
    k1.int8_matmul_stacked(x.cuda(), w_q.cuda(), scale.cuda(), 0)
    assert k1.int8_matmul_stacked.launches == before + 1

    kq, ks, vq, vs = _int8_cache(g, 1, 1, 2, 64, 32)
    qd = torch.randn((1, 2, 1, 32), device="cuda")
    mask = masks.decode_mask(10, 64, 1, device="cuda")
    before = k2.decode_attention_int8_stacked.launches
    k2.decode_attention_int8_stacked(qd, kq, ks, vq, vs, 0, mask)
    assert k2.decode_attention_int8_stacked.launches == before + 1

    qf = torch.randn((1, 2, 16, 32), device="cuda")
    pos = torch.arange(16, dtype=torch.int32, device="cuda")
    before = k3.flash_attention.launches
    k3.flash_attention(qf, qf, qf, masks.causal_mask(pos, pos))
    assert k3.flash_attention.launches == before + 1
    k3.flash_attention(qf.cpu(), qf.cpu(), qf.cpu(),
                       masks.causal_mask(pos.cpu(), pos.cpu()))
    assert k3.flash_attention.launches == before + 1


def _pools(g, L, P, H, ps, D):
    """Random int8 pools and positive f32 scales, as the four K5-K8 pools."""
    def i8(shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    def f32(shape):
        return 0.01 + 0.02 * torch.rand(shape, generator=g, device="cuda")

    return [i8((L, P, H, ps, D)), f32((L, P, H, ps)), i8((L, P, H, ps, D)),
            f32((L, P, H, ps))]


def _step(g, lead, H, D):
    return (torch.randint(-127, 128, (*lead, H, D), generator=g,
                          device="cuda", dtype=torch.int8),
            torch.rand((*lead, H), generator=g, device="cuda"),
            torch.randint(-127, 128, (*lead, H, D), generator=g,
                          device="cuda", dtype=torch.int8),
            torch.rand((*lead, H), generator=g, device="cuda"))


def _i32(values):
    return torch.tensor(values, dtype=torch.int32, device="cuda")


def _same_pools(got, want, skip_page0=True):
    for a, b in zip(got, want):
        if skip_page0:
            a, b = a[:, 1:], b[:, 1:]
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,P,H,ps,D,page,off", [
    # distinct pages, one row with off == ps and one with page == P
    (3, 9, 4, 16, 128, [1, 2, 3, 4, 5], [0, 15, 16, 7, 3]),
    (2, 7, 3, 10, 32, [6, 1, 7, 2], [9, 0, 1, 4]),          # ps = 10
    # the contiguous cache as a pool: ps = cap = 640, page = row, one row
    # finished at off == cap
    (2, 4, 2, 640, 64, [0, 1, 2, 3], [639, 0, 640, 300]),
    (1, 5, 2, 12, 40, [1, 2, -1], [11, 5, 2]),               # D % 16 != 0
])
def test_k5_k7_match_plain(L, P, H, ps, D, page, off):
    g = _card()
    page, off = _i32(page), _i32(off)
    B = page.shape[0]
    pools = _pools(g, L, P, H, ps, D)
    step = _step(g, (L, B), H, D)
    for layer in range(L):
        want = kp.paged_write_int8_plain(*[t.clone() for t in pools], layer,
                                         page, off, *(t[layer] for t in step))
        got = kp.paged_write_int8(*[t.clone() for t in pools], layer, page,
                                  off, *(t[layer].contiguous() for t in step))
        _same_pools(got, want, skip_page0=False)
    want = kp.paged_write_layers_int8_plain(*[t.clone() for t in pools], page,
                                            off, *step)
    got = kp.paged_write_layers_int8(*[t.clone() for t in pools], page, off,
                                     *step)
    _same_pools(got, want, skip_page0=False)
    ok = (page >= 0) & (page < P) & (off >= 0) & (off < ps)
    untouched = torch.ones((L, P, H, ps), dtype=torch.bool, device="cuda")
    untouched[:, page[ok].long(), :, off[ok].long()] = False
    assert torch.equal(got[1][untouched], pools[1][untouched])


@pytest.mark.parametrize("G,nv,P,H,ps,D,pt", [
    (3, 2, 9, 4, 16, 128, [[1, 2], [3, 4], [5, 0]]),
    (4, 3, 12, 2, 10, 32, [[1, 2, 3], [4, 5, 0], [4, 5, 0], [6, 12, -1]]),
    (2, 1, 4, 2, 6, 40, [[3], [1]]),                        # D % 16 != 0
])
def test_k8_matches_plain(G, nv, P, H, ps, D, pt):
    g = _card()
    L = 2
    pools = _pools(g, L, P, H, ps, D)
    rows = _pools(g, L, G, H, nv * ps, D)
    pt = _i32(pt)
    for g0 in range(G):                   # a padded duplicate row repeats
        for g1 in range(g0):              # its original
            if torch.equal(pt[g0], pt[g1]):
                for t in rows:
                    t[:, g0] = t[:, g1]
    want = kp.paged_page_copy_int8_plain(*[t.clone() for t in pools], pt,
                                         *rows)
    got = kp.paged_page_copy_int8(*[t.clone() for t in pools], pt, *rows)
    _same_pools(got, want)


def _k6_case(g, B, S, ps, n_virt, P, fresh):
    """(page table, the same with two page ids outside [0, P) when B > 2,
    mask) of a K6 case: row 0 holds one page (its tail on the null page)
    and sees fewer than ps slots, so with several splits the splits past
    its first page have no allowed key and every tile of them is skipped;
    row 1 (B > 2) has no allowed pool key; the last row is left-padded.
    ``fresh``: the deferred write's mask, q_idx - 1."""
    cap = ps * n_virt
    pt = (1 + torch.randperm(B * n_virt, generator=g, device="cuda")).reshape(
        B, n_virt).to(torch.int32)
    pt[0, 1:] = 0
    lengths = torch.randint(S + 1, cap, (B,), generator=g, device="cuda")
    lengths[0] = min(ps, cap) - 1
    valid = (torch.arange(cap, device="cuda")[None]
             < lengths[:, None]).to(torch.int32)
    valid[-1, :3] = 0
    wild = pt.clone()
    if B > 2:
        valid[1] = 0
        wild[1, 0], wild[2, -1] = -2, P + 3   # read as the null page
    q_idx = (lengths[:, None] - S + torch.arange(S, device="cuda")[None])
    if fresh:
        q_idx = q_idx - 1
    mask = masks.AttnMask(q_idx.to(torch.int32),
                          torch.arange(cap, dtype=torch.int32, device="cuda"),
                          valid)
    return torch.where((wild < 0) | (wild >= P), 0, wild), wild, mask


def _k6_launch(q, pools, layer, wild, mask, fresh=None):
    """K6 on the card: asserts its split (several where B * H leaves the
    card's SMs short of 4 blocks each, and then some split with no allowed
    key for a row that sees others), one launch on its pool width, and the
    merge counters left at zero."""
    B, H, S, D = q.shape
    cap = wild.shape[1] * pools[0].shape[3]
    p = k2.plan(B, H, cap, build.sm_count(0))
    assert (p.splits == 1) == (B * H >= k2.BLOCKS_PER_SM * build.sm_count(0))
    if p.splits > 1:
        seen = mask.allowed().any(1)                        # [B, cap]
        per = [seen[:, z * p.slots_per_split:(z + 1) * p.slots_per_split]
               .any(-1) for z in range(p.splits)]
        assert any(bool((seen.any(-1) & ~part).any()) for part in per)
    fn = kp.paged_decode_attention_int8
    form = f"int{quant.kv_bits(pools[0])}"
    before = (fn.launches, dict(fn.form_launches))
    got = fn(q, *pools, layer, wild, mask, fresh=fresh)
    assert fn.launches == before[0] + 1
    assert fn.form_launches == dict(before[1], **{form: before[1][form] + 1})
    torch.cuda.synchronize()
    _, ctr = build.scratch(0, build.raw_stream(0), 0, 0)
    assert not bool(ctr.any())
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,D,ps,n_virt,fresh", [
    (3, 2, 1, 128, 16, 3, True),       # fresh over 2 splits
    (3, 2, 1, 128, 16, 3, False),
    (2, 3, 4, 64, 10, 4, False),       # ps = 10: tiles cross pages
    (4, 2, 1, 32, 48, 2, True),
    (1, 2, 8, 128, 256, 3, False),     # S = 8, the engine's pages
    (3, 2, 1, 128, 256, 3, True),      # fresh over 24 splits
    (3, 4, 8, 64, 10, 8, False),       # S = 8 across pages, no-key row
    (3, 4, 8, 32, 32, 3, False),
    (40, 16, 1, 64, 16, 4, True),      # B * H fills the card: one split
    (40, 16, 1, 32, 16, 4, False),     # one split, a row with no key
    (40, 16, 8, 128, 32, 2, False),
])
def test_k6_matches_plain(B, H, S, D, ps, n_virt, fresh, dtype):
    """INT8 pools: the row with no allowed pool key takes the fresh value
    with ``fresh`` and the uniform mean of every virtual slot without it;
    with B > 2 two page ids lie outside [0, P)."""
    g = _card()
    L = 2
    P = B * n_virt + 1
    pools = _pools(g, L, P, H, ps, D)
    pt, wild, mask = _k6_case(g, B, S, ps, n_virt, P, fresh)
    q = torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
    pair = None
    if fresh:
        pair = tuple(torch.randn((B, H, D), generator=g, device="cuda") * 0.1
                     for _ in range(2))
    got = _k6_launch(q, pools, L - 1, wild, mask, pair)
    want = kp.paged_decode_attention_int8_plain(q, *pools, L - 1, pt, mask,
                                                fresh=pair)
    _close(got, want, dtype)


def _packed_pools(g, L, P, H, ps, D):
    """Random packed INT4 pools (uint8 [L, P, H, ps, D/2]: every byte is two
    valid nibbles) and positive f32 scales."""
    def u8(shape):
        return torch.randint(0, 256, shape, generator=g, device="cuda",
                             dtype=torch.uint8)

    def f32(shape):
        return 0.01 + 0.02 * torch.rand(shape, generator=g, device="cuda")

    return [u8((L, P, H, ps, D // 2)), f32((L, P, H, ps)),
            u8((L, P, H, ps, D // 2)), f32((L, P, H, ps))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("B,H,ps,n_virt", [
    (3, 2, 16, 3),      # 2 splits, the second skipped for row 0
    (3, 2, 256, 3),     # the engine's pages, 24 splits
    (3, 2, 10, 5),      # tiles cross pages
    (40, 16, 16, 4),    # one split
])
def test_k6_int4_matches_plain(B, H, ps, n_virt, S, D, dtype):
    """Packed pools, no fresh term (the INT4 pool writes first): row 0's
    tail on the null page, row 1 with no allowed key (the uniform mean),
    rows 1 and 2 with page ids outside [0, P), which the kernel reads as
    the null page."""
    g = _card()
    L = 2
    P = B * n_virt + 1
    pools = _packed_pools(g, L, P, H, ps, D)
    pt, wild, mask = _k6_case(g, B, S, ps, n_virt, P, False)
    q = torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
    got = _k6_launch(q, pools, L - 1, wild, mask)
    want = kp.paged_decode_attention_int8_plain(q, *pools, L - 1, pt, mask)
    _close(got, want, dtype)


@pytest.mark.parametrize("G,nv,P,H,ps,D,pt", [
    (3, 2, 9, 4, 16, 128, [[1, 2], [3, 4], [5, 0]]),
    (4, 3, 12, 2, 10, 32, [[1, 2, 3], [4, 5, 0], [4, 5, 0], [6, 12, -1]]),
    (2, 1, 4, 2, 6, 40, [[3], [1]]),        # 20-byte rows: byte copies
])
def test_k8_packed_matches_plain(G, nv, P, H, ps, D, pt):
    """K8 copies a packed INT4 pool's bytes as they are."""
    g = _card()
    L = 2
    pools = _packed_pools(g, L, P, H, ps, D)
    rows = _packed_pools(g, L, G, H, nv * ps, D)
    pt = _i32(pt)
    for g0 in range(G):
        for g1 in range(g0):
            if torch.equal(pt[g0], pt[g1]):
                for t in rows:
                    t[:, g0] = t[:, g1]
    want = kp.paged_page_copy_int8_plain(*[t.clone() for t in pools], pt,
                                         *rows)
    before = kp.paged_page_copy_int8.form_launches["int4"]
    got = kp.paged_page_copy_int8(*[t.clone() for t in pools], pt, *rows)
    assert kp.paged_page_copy_int8.form_launches["int4"] == before + 1
    _same_pools(got, want)
    signed = [t.view(torch.int8) if t.dtype == torch.uint8 else t
              for t in rows]
    with pytest.raises(TypeError, match="dtype"):
        kp.paged_page_copy_int8(*pools, pt, *signed)


def test_k5_to_k8_launch_counters():
    g = _card()
    pools = _pools(g, 2, 4, 2, 8, 32)
    page, off = _i32([1, 2]), _i32([0, 8])
    step = _step(g, (2, 2), 2, 32)
    before = (kp.paged_write_int8.launches, kp.paged_write_layers_int8.launches,
              kp.paged_page_copy_int8.launches,
              kp.paged_decode_attention_int8.launches)
    kp.paged_write_int8(*pools, 1, page, off, *(t[1] for t in step))
    kp.paged_write_layers_int8(*pools, page, off, *step)
    kp.paged_page_copy_int8(*pools, _i32([[3]]), *_pools(g, 2, 1, 2, 8, 32))
    mask = masks.decode_mask(3, 16, 1, device="cuda")
    kp.paged_decode_attention_int8(torch.randn((2, 2, 1, 32), device="cuda"),
                                   *pools, 0, _i32([[1, 2], [3, 0]]), mask)
    cpu = [t.cpu() for t in pools]
    kp.paged_write_int8(*cpu, 1, page.cpu(), off.cpu(),
                        *(t[1].cpu() for t in step))
    after = (kp.paged_write_int8.launches, kp.paged_write_layers_int8.launches,
             kp.paged_page_copy_int8.launches,
             kp.paged_decode_attention_int8.launches)
    assert after == tuple(n + 1 for n in before)


# ---------------------------------------------------------------------------
# W8A8-q and W8A8-mm: bit-exact against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K", [(1, 2048), (17, 8192), (300, 112),
                                 (5, 16), (4096, 2048), (64, 1024)])
def test_w8a8_quant_bit_exact(M, K, dtype):
    """Random rows (one zero, one of tiny values, one large), K from one
    vector of 16 up, not always a multiple of the block's 128 threads'
    vectors."""
    g = _card()
    x = torch.randn((M, K), generator=g, device="cuda")
    x[0] *= 300.0
    if M > 2:
        x[1] = 0.0
        x[2] *= 1e-30
    x = x.to(dtype)
    before = w8a8.w8a8_quant.launches
    xq, sx = w8a8.w8a8_quant(x)
    assert w8a8.w8a8_quant.launches == before + 1
    xq_p, sx_p = w8a8.w8a8_quant_plain(x)
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32
    assert torch.equal(sx, sx_p) and torch.equal(xq, xq_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 16, 17, 384, 4096])
@pytest.mark.parametrize("K,N", [(2048, 384), (2048, 6144), (8192, 2048),
                                 (2048, 2048), (8192, 384)])
def test_w8a8_matmul_bit_exact(M, K, N, dtype):
    """Layer 1 of a 2-layer stack (the layer by pointer offset), xq and sx
    from W8A8-q; splits from ``plan`` (split K at small M, none at the
    prefill's M = 4096)."""
    g = _card()
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w_q = torch.randint(-127, 128, (2, K, N), generator=g, device="cuda",
                        dtype=torch.int8)
    scale = 0.001 + 0.01 * torch.rand((2, N), generator=g, device="cuda")
    xq, sx = w8a8.w8a8_quant(x)
    before = w8a8.w8a8_matmul_stacked.launches
    routed = w8a8.w8a8_matmul_stacked.route_launches["wgmma"]
    got = w8a8.w8a8_matmul_stacked(xq, sx, w_q, scale, 1, dtype)
    assert w8a8.w8a8_matmul_stacked.launches == before + 1
    assert w8a8.plan(M, K, N, build.sm_count(0)).route == "wgmma"
    assert w8a8.w8a8_matmul_stacked.route_launches["wgmma"] == routed + 1
    want = w8a8.w8a8_matmul_stacked_plain(xq, sx, w_q, scale, 1, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("M,K,N", [(70, 96, 48), (130, 80, 144),
                                   (3, 4096, 16), (200, 2064, 48),
                                   (257, 176, 144), (129, 16, 272),
                                   (1, 144, 48), (385, 1040, 528)])
def test_w8a8_matmul_ragged_tiles(M, K, N):
    """M, N and K not multiples of the 128-token x 256-column x 128-byte
    tile (K and N of 16; N = 48 and 144 end inside the first consumer
    warpgroup's columns, 272 and 528 inside a second tile's): the edges
    TMA zero-fills; layer 2 puts the weights' tensor map at an offset."""
    g = _card()
    xq = torch.randint(-127, 128, (M, K), generator=g, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand((M,), generator=g, device="cuda")
    w_q = torch.randint(-127, 128, (3, K, N), generator=g, device="cuda",
                        dtype=torch.int8)
    scale = torch.rand((3, N), generator=g, device="cuda")
    assert w8a8.plan(M, K, N, build.sm_count(0)).route == "wgmma"
    for layer in (0, 2):
        routed = w8a8.w8a8_matmul_stacked.route_launches["wgmma"]
        got = w8a8.w8a8_matmul_stacked(xq, sx, w_q, scale, layer,
                                       torch.bfloat16)
        assert w8a8.w8a8_matmul_stacked.route_launches["wgmma"] == routed + 1
        assert torch.equal(got, w8a8.w8a8_matmul_stacked_plain(
            xq, sx, w_q, scale, layer, torch.bfloat16))


def test_w8a8_counters_are_left_at_zero():
    """A split launch (M = 16: K split over the units) leaves the shared
    arrival counters at zero: the next split launch on the same stream is
    right too."""
    g = _card()
    xq = torch.randint(-127, 128, (16, 2048), generator=g, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand((16,), generator=g, device="cuda")
    w_q = torch.randint(-127, 128, (1, 2048, 384), generator=g,
                        device="cuda", dtype=torch.int8)
    scale = torch.rand((1, 384), generator=g, device="cuda")
    assert w8a8.plan(16, 2048, 384, build.sm_count(0)).splits > 1
    want = w8a8.w8a8_matmul_stacked_plain(xq, sx, w_q, scale, 0,
                                          torch.float32)
    for _ in range(3):
        got = w8a8.w8a8_matmul_stacked(xq, sx, w_q, scale, 0, torch.float32)
        assert torch.equal(got, want)
    _, ctr = build.scratch(0, build.raw_stream(0), 0, 0)
    torch.cuda.synchronize()
    assert not ctr.any()


def test_w8a8_wrappers_raise():
    """What the kernels do not take raises; nothing falls back."""
    g = _card()
    xq = torch.randint(-127, 128, (8, 64), generator=g, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand((8,), device="cuda")
    w_q = torch.randint(-127, 128, (2, 64, 32), generator=g, device="cuda",
                        dtype=torch.int8)
    scale = torch.rand((2, 32), device="cuda")
    mm = w8a8.w8a8_matmul_stacked
    with pytest.raises(ValueError, match="multiples of 16"):
        mm(xq[:, :56].contiguous(), sx, w_q[:, :56].contiguous(), scale, 0,
           torch.float32)
    with pytest.raises(ValueError, match="multiples of 16"):
        mm(xq, sx, w_q[:, :, :24].contiguous(), scale[:, :24].contiguous(),
           0, torch.float32)
    with pytest.raises(ValueError, match="positive multiples of 16"):
        mm(xq[:, :0].contiguous(), sx, w_q[:, :0].contiguous(), scale, 0,
           torch.float32)
    with pytest.raises(ValueError, match="layer"):
        mm(xq, sx, w_q, scale, 2, torch.float32)
    with pytest.raises(TypeError):
        mm(xq.float(), sx, w_q, scale, 0, torch.float32)
    with pytest.raises(TypeError):
        mm(xq, sx, w_q, scale, 0, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        mm(xq, sx, w_q.transpose(1, 2).contiguous().transpose(1, 2), scale,
           0, torch.float32)
    with pytest.raises(ValueError, match="aligned"):
        mm(xq[1:], sx[1:], w_q, scale, 0, torch.float32)
    x = torch.randn((4, 64), device="cuda")
    with pytest.raises(TypeError):
        w8a8.w8a8_quant(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        w8a8.w8a8_quant(x.t())
    with pytest.raises(ValueError):
        w8a8.w8a8_quant(x[None])
    with pytest.raises(ValueError, match="multiple of 16"):
        w8a8.w8a8_quant(x[:, :56].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        w8a8.w8a8_quant(torch.randn(80, device="cuda")[1:65].view(4, 16))


# ---------------------------------------------------------------------------
# No backward: every wrapper refuses inputs that require grad under grad
# mode, and launches under torch.no_grad()
# ---------------------------------------------------------------------------

GUARDED = ("K1", "K4", "K2", "K2 bf16", "K3", "W8A8-q", "W8A8-mm", "K5",
           "K6", "K7", "K8")


def grad_guard_cases(device):
    """{tag: (wrapper, call)}: ``call(requires_grad)`` runs the wrapper once
    on fresh small inputs on ``device`` whose float activations (or, for
    the pool writes, the new scales) require grad when asked."""
    cpu = torch.Generator().manual_seed(0)

    def randn(*shape, rg=False):
        t = torch.randn(shape, generator=cpu).to(device)
        return t.requires_grad_(rg)

    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=cpu,
                             dtype=torch.int8).to(device)

    def scales(*shape, rg=False):
        t = (0.01 + 0.02 * torch.rand(shape, generator=cpu)).to(device)
        return t.requires_grad_(rg)

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=device)

    w8, s8 = (t.to(device) for t in quant.quantize_int8(
        torch.randn((1, 64, 64), generator=cpu)))
    w4, s4 = (t.to(device) for t in quant.quantize_int4(
        torch.randn((1, 64, 64), generator=cpu), 16))
    pos = torch.arange(16, dtype=torch.int32, device=device)

    def pools():
        return [ints(2, 4, 2, 8, 32), scales(2, 4, 2, 8), ints(2, 4, 2, 8, 32),
                scales(2, 4, 2, 8)]

    def k2_int8(rg):
        return k2.decode_attention_int8_stacked(
            randn(1, 2, 1, 32, rg=rg), ints(1, 1, 2, 64, 32),
            scales(1, 1, 2, 64), ints(1, 1, 2, 64, 32), scales(1, 1, 2, 64),
            0, masks.decode_mask(10, 64, 1, device=device))

    def k2_bf16(rg):
        return k2.decode_attention_stacked(
            randn(1, 2, 1, 32, rg=rg), randn(1, 1, 2, 64, 32),
            randn(1, 1, 2, 64, 32), 0,
            masks.decode_mask(10, 64, 1, device=device))

    def k3_call(rg):
        q = randn(1, 2, 16, 32, rg=rg)
        return k3.flash_attention(q, randn(1, 2, 16, 32), randn(1, 2, 16, 32),
                                  masks.causal_mask(pos, pos))

    def w8a8_mm(rg):
        xq, sx = w8a8.w8a8_quant_plain(randn(4, 64))
        return w8a8.w8a8_matmul_stacked(xq, sx.requires_grad_(rg), w8, s8, 0,
                                        torch.float32)

    def k5(rg):
        return kp.paged_write_int8(*pools(), 1, i32([1, 2]), i32([0, 7]),
                                   ints(2, 2, 32), scales(2, 2, rg=rg),
                                   ints(2, 2, 32), scales(2, 2))

    def k6(rg):
        return kp.paged_decode_attention_int8(
            randn(2, 2, 1, 32, rg=rg), *pools(), 0, i32([[1, 2], [3, 0]]),
            masks.decode_mask(3, 16, 1, device=device))

    def k7(rg):
        return kp.paged_write_layers_int8(
            *pools(), i32([1, 2]), i32([0, 7]), ints(2, 2, 2, 32),
            scales(2, 2, 2, rg=rg), ints(2, 2, 2, 32), scales(2, 2, 2))

    def k8(rg):
        rows = [ints(2, 1, 2, 8, 32), scales(2, 1, 2, 8, rg=rg),
                ints(2, 1, 2, 8, 32), scales(2, 1, 2, 8)]
        return kp.paged_page_copy_int8(*pools(), i32([[3]]), *rows)

    return {
        "K1": (k1.int8_matmul_stacked,
               lambda rg: k1.int8_matmul_stacked(randn(4, 64, rg=rg), w8, s8,
                                                 0)),
        "K4": (k1.int4_matmul_stacked,
               lambda rg: k1.int4_matmul_stacked(randn(4, 64, rg=rg), w4, s4,
                                                 0)),
        "K2": (k2.decode_attention_int8_stacked, k2_int8),
        "K2 bf16": (k2.decode_attention_stacked, k2_bf16),
        "K3": (k3.flash_attention, k3_call),
        "W8A8-q": (w8a8.w8a8_quant,
                   lambda rg: w8a8.w8a8_quant(randn(4, 64, rg=rg))),
        "W8A8-mm": (w8a8.w8a8_matmul_stacked, w8a8_mm),
        "K5": (kp.paged_write_int8, k5),
        "K6": (kp.paged_decode_attention_int8, k6),
        "K7": (kp.paged_write_layers_int8, k7),
        "K8": (kp.paged_page_copy_int8, k8),
    }


@pytest.mark.parametrize("tag", GUARDED)
def test_wrappers_refuse_grad_and_launch_under_no_grad(tag):
    _card()
    fn, call = grad_guard_cases("cuda")[tag]
    before = fn.launches
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    assert fn.launches == before
    with torch.no_grad():
        call(True)
    assert fn.launches == before + 1
    call(False)                    # nothing requires grad: it launches
    assert fn.launches == before + 2


# ---------------------------------------------------------------------------
# GPTQ and the train step on the card against the CPU (plain torch both)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quantizer_card_equal_cpu(bits):
    """quantize_kv divides exactly on the card too (no reciprocal): its
    scales and values on a cache-sized input equal the CPU's bit for bit."""
    _card()
    x = torch.randn((8, 16, 640, 128),
                    generator=torch.Generator().manual_seed(11))
    q_cpu, s_cpu = quant.quantize_kv(x, bits)
    q_gpu, s_gpu = quant.quantize_kv(x.cuda(), bits)
    assert torch.equal(s_gpu.cpu(), s_cpu)
    assert torch.equal(q_gpu.cpu(), q_cpu)


@pytest.mark.parametrize("gs", [128, 32])
def test_weight_quantizers_card_equal_cpu(gs):
    """INT8 / INT4 quantization and the QAT round trips divide exactly on
    the card too (no reciprocal), so card and CPU grids are bit for bit
    the same."""
    _card()
    w = torch.randn((2, 256, 384), generator=torch.Generator().manual_seed(4))
    for fn in (quant.quantize_int8, functools.partial(quant.quantize_int4,
                                                      group_size=gs),
               quant._qdq_int8, functools.partial(quant._qdq_int4,
                                                  group_size=gs)):
        want, got = fn(w), fn(w.cuda())
        for a, b in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            assert torch.equal(b.cpu(), a)


@pytest.mark.parametrize("bits,gs,act_order", [(4, 128, False),
                                               (4, 64, True), (8, 0, False)])
def test_gptq_round_card_vs_cpu(bits, gs, act_order):
    """cuSOLVER's inverse and Cholesky against LAPACK's, and the card's
    fused products in the sweep: at least 99.9% of Q equal, the rest one
    step apart; scales within 1e-6 relative."""
    from block_transformer_tpu_torch.ops import gptq
    _card()
    cpu = torch.Generator().manual_seed(3)
    K, N = 512, 384
    W = torch.randn((K, N), generator=cpu)
    X = (torch.randn((2048, K // 4), generator=cpu, dtype=torch.float64)
         @ torch.randn((K // 4, K), generator=cpu, dtype=torch.float64)
         + 0.1 * torch.randn((2048, K), generator=cpu, dtype=torch.float64))
    X[:, 7] = 0.0                                       # a dead input
    H = X.T @ X
    kw = dict(bits=bits, group_size=gs, act_order=act_order)
    q_cpu, s_cpu = gptq.gptq_round(W, H, **kw)
    q_gpu, s_gpu = gptq.gptq_round(W.cuda(), H.cuda(), **kw)
    diff = (q_gpu.cpu() - q_cpu).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
    torch.testing.assert_close(s_gpu.cpu(), s_cpu, rtol=1e-6, atol=0)


@pytest.mark.parametrize("qat", [False, True])
def test_train_step_card_vs_cpu(qat):
    """Two steps (the first at lr 0) of a small model in float32, TF32 off:
    loss and grad_norm within 1e-5 relative; each leaf's update within 1e-4
    relative in Frobenius norm over the coordinates whose gradient is zero
    or above float32 noise (the CPU run's ``sqrt(nu)`` above 1e-6 of the
    leaf's largest: Adam turns a gradient that is zero in exact arithmetic,
    such as the key bias off RoPE's dims, into the sign of its rounding
    noise; ``tests/test_torch_train_step.py``)."""
    import numpy as np

    from block_transformer_tpu_torch import config
    from block_transformer_tpu_torch.data import packing
    from block_transformer_tpu_torch.train import optimizer as opt
    from block_transformer_tpu_torch.train import train_step as ts
    _card()
    cfg = config.make_block_config("t", 128, 2, vocab_size=512)
    tx, _ = opt.make_optimizer(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    transform = functools.partial(quant.fake_quant_block_transformer,
                                  **quant.RECIPES["mixed48"]) if qat else None
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 512, (2, 64))
    att = np.ones_like(ids)
    ids[1, :6], att[1, :6] = 0, 0
    batch = packing.make_train_batch(ids, att, cfg.block_length)
    params0 = ts.create_train_state(0, cfg, tx, device="cpu").params
    runs = []
    for dev in ("cpu", "cuda"):
        params = opt.tree_map(lambda t: t.to(dev, copy=True), params0)
        state = ts.TrainState(params, tx.init(params), 0)
        step = ts.make_train_step(cfg, tx, param_transform=transform)
        metrics = []
        for _ in range(2):
            state, m = step(state, packing.to_device(batch, dev))
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        runs.append((metrics, state))
    (m_cpu, s_cpu), (m_gpu, s_gpu) = runs
    for a, b in zip(m_cpu, m_gpu):
        for k in a:
            assert abs(b[k] - a[k]) <= 1e-5 * abs(a[k]), (k, a, b)
    for name in ("mu", "nu"):
        card = dict(opt.tree_items(getattr(s_gpu.opt_state, name)))
        for path, v in opt.tree_items(getattr(s_cpu.opt_state, name)):
            assert (card[path].cpu() - v).norm() <= 1e-5 * v.norm(), (name,
                                                                       path)
    nu = dict(opt.tree_items(s_cpu.opt_state.nu))
    p_cpu = dict(opt.tree_items(s_cpu.params))
    p_gpu = dict(opt.tree_items(s_gpu.params))
    for path, w0 in opt.tree_items(params0):
        rms = nu[path].sqrt()
        live = (rms == 0) | (rms > 1e-6 * rms.max())
        w = p_cpu[path][live]
        diff = (p_gpu[path].cpu() - p_cpu[path])[live]
        assert diff.norm() <= (1e-5 * w0[live].norm()
                               + 1e-4 * (w - w0[live]).norm()), path
