"""The port's CUDA kernels K1-K3 against their plain PyTorch versions, on the
card, at small and ragged shapes; and the launch counters.

Marked ``gpu``: each test skips, from inside its body, when no CUDA device
is present. This file imports torch and the port only (no JAX), so on a
machine with a card it runs on its own:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: float32 kernel vs float32 plain version differ only in the
order of float32 sums, so 1e-4 (abs and rel); bf16 outputs carry one bf16
rounding (2^-8 relative) on each side, so 1e-2 of the output's largest
magnitude.
"""

import pytest
import torch

from block_transformer_tpu_torch.kernels import decode_attention as k2
from block_transformer_tpu_torch.kernels import dequant_matmul as k1
from block_transformer_tpu_torch.kernels import flash_attention as k3
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,L,layer", [
    (1, 32, 8, 1, 0),          # smallest
    (3, 100, 37, 2, 1),        # ragged K and N (scalar weight loads)
    (17, 256, 200, 3, 2),      # M > 16: 64-row tiles
    (70, 96, 136, 2, 0),       # ragged M tile
    (8, 2048, 384, 2, 1),      # decode shape: K split over blocks
])
def test_k1_matches_plain(M, K, N, L, layer, dtype):
    g = _card()
    w_q, scale = quant.quantize_int8(
        torch.randn((L, K, N), generator=g, device="cuda"))
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    got = k1.int8_matmul_stacked(x, w_q, scale, layer)
    _close(got, k1.int8_matmul_stacked_plain(x, w_q, scale, layer), dtype)


def _int8_cache(g, L, B, H, cap, D):
    kv = torch.randn((2, L * B, H, cap, D), generator=g, device="cuda")
    kq, ks = quant.quantize_kv(kv[0])
    vq, vs = quant.quantize_kv(kv[1])
    return (kq.reshape(L, B, H, cap, D), ks.reshape(L, B, H, cap),
            vq.reshape(L, B, H, cap, D), vs.reshape(L, B, H, cap))


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
    got = k3.flash_attention(q, k, v, full)
    _close(got, k3.flash_attention_plain(q, k, v, full), dtype)


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
