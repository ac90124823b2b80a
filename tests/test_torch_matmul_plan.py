"""``plan``, the pure function that picks how K1 and K4 launch
(``kernels/dequant_matmul.py``): the route (tensor cores or CUDA cores), the
tile, and the split of K over blocks. No card needed.

The main path's shapes come from the two configurations the port runs at
full width: every linear of ``block_main_b4_1.2b`` and of ``vanilla_410``,
at the rows their generation gives it (decode M = 8 and 16, the token
decoder's M = 32 prefix steps, the 4096-row block prefill and the
baseline's 16,384-row prefill). K4 sees K/2 packed rows.
"""

import pytest
import torch

from block_transformer_tpu_torch import config
from block_transformer_tpu_torch.kernels import dequant_matmul as k1

SMS = 132           # an H100 SXM's streaming multiprocessors


def _neox_linears(h, m, vocab):
    """(K, N) of one NeoX stack's linears and its LM head."""
    return [(h, 3 * h), (h, h), (h, m), (m, h), (h, vocab)]


def _main_path_linears():
    cfg = config.get_config("block_main_b4_1.2b")
    bd, td = cfg.block_decoder, cfg.token_decoder
    shapes = _neox_linears(bd.hidden_size, bd.intermediate_size,
                           cfg.vocab_size)
    shapes += _neox_linears(td.neox.hidden_size, td.neox.intermediate_size,
                            cfg.vocab_size)
    shapes.append((cfg.embedder.projection_hidden_size,
                    td.neox.hidden_size * td.expansion_ratio))
    v = config.get_vanilla_config("vanilla_410")
    shapes += _neox_linears(v.hidden_size, v.intermediate_size, v.vocab_size)
    return sorted(set(shapes))


LINEARS = _main_path_linears()
MAIN_M = (8, 16, 32, 4096, 16384)
# (M, K, N, bits): K4 takes the packed K/2 rows
MAIN = [(M, K if bits == 8 else K // 2, N, bits)
        for M in MAIN_M for K, N in LINEARS for bits in (8, 4)]


def test_main_path_shapes_are_the_published_widths():
    assert (2048, 6144) in LINEARS and (8192, 2048) in LINEARS
    assert (2048, 50304) in LINEARS and (2048, 4096) in LINEARS
    assert (1024, 3072) in LINEARS and (4096, 1024) in LINEARS
    assert len(MAIN) == len(MAIN_M) * len(LINEARS) * 2


@pytest.mark.parametrize("M,K,N,bits", MAIN)
def test_main_path_takes_the_tensor_cores(M, K, N, bits):
    p = k1.plan(M, K, N, torch.bfloat16, SMS)
    assert p.route == "tc"
    bm = 16 if M <= 16 else 64 if M <= 64 else 128
    assert p.tile == (bm, 128, 32)


@pytest.mark.parametrize("M,K,N,bits", MAIN)
def test_splits_cover_k_in_whole_steps(M, K, N, bits):
    p = k1.plan(M, K, N, torch.bfloat16, SMS)
    assert p.k_per_split % p.tile[2] == 0
    assert p.splits * p.k_per_split >= K > (p.splits - 1) * p.k_per_split


# the baseline's attention-out projection (1024 x 1024; K4: 512 packed
# rows) has fewer (tile, 32-row step) pairs than two per SM
SHORT = {(1024, 1024, 8): 256, (512, 1024, 4): 128}


@pytest.mark.parametrize("M,K,N,bits", [s for s in MAIN if s[0] <= 16])
def test_decode_fills_every_sm_twice(M, K, N, bits):
    """At least two blocks per SM, or, where the weight has fewer 32-row
    steps than that, one step a block."""
    p = k1.plan(M, K, N, torch.bfloat16, SMS)
    bm, bn, bk = p.tile
    tiles = -(-N // bn) * -(-M // bm)
    if (K, N, bits) in SHORT:
        assert p.splits == K // bk and tiles * p.splits == SHORT[K, N, bits]
    else:
        assert tiles * p.splits >= 2 * SMS


@pytest.mark.parametrize("M,K,N", [(4096, 2048, 6144), (16384, 1024, 3072),
                                   (4096, 8192, 2048)])
def test_prefill_is_not_split(M, K, N):
    p = k1.plan(M, K, N, torch.bfloat16, SMS)
    assert (p.route, p.tile, p.splits, p.k_per_split) == (
        "tc", (128, 128, 32), 1, K)


@pytest.mark.parametrize("M,K,N,dtype,aligned", [
    (8, 2048, 6144, torch.float32, True),       # float32 x
    (4096, 2048, 6144, torch.float32, True),
    (3, 100, 37, torch.bfloat16, True),         # ragged K and N
    (8, 2048, 37, torch.bfloat16, True),        # ragged N
    (8, 2048, 200, torch.bfloat16, True),       # N not a multiple of 16
    (8, 2040, 6144, torch.bfloat16, True),      # K not a multiple of 32
    (8, 2048, 6144, torch.bfloat16, False),     # an unaligned base pointer
    (8, 2048, 6144, torch.float16, True),       # no tensor-core form
])
def test_everything_else_takes_the_cuda_cores(M, K, N, dtype, aligned):
    p = k1.plan(M, K, N, dtype, SMS, aligned)
    assert p.route == "fma"
    assert p.tile == (16 if M <= 16 else 64, 64, 32)
    assert p.k_per_split % 32 == 0
    assert p.splits * p.k_per_split >= K > (p.splits - 1) * p.k_per_split


@pytest.mark.parametrize("M,K,N,dtype", [
    (8, 2048, 6144, torch.bfloat16), (8, 1024, 1024, torch.bfloat16),
    (4096, 2048, 6144, torch.bfloat16), (8, 2048, 6144, torch.float32),
    (3, 100, 37, torch.bfloat16)])
def test_workspace_follows_from_the_plan(M, K, N, dtype):
    p = k1.plan(M, K, N, dtype, SMS)
    floats = k1.workspace_floats(p, M, N)
    assert floats == (p.splits * M * N if p.splits > 1 else 0)
    assert (floats > 0) == (p.splits > 1)


def test_plan_is_pure():
    args = (8, 2048, 6144, torch.bfloat16, SMS)
    assert k1.plan(*args) == k1.plan(*args)
    assert k1.plan(8, 2048, 6144, torch.bfloat16, 66).splits >= \
        k1.plan(*args).splits // 2
