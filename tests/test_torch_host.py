"""Host-side pieces of the PyTorch port that need no card: the split-K
part of K1's ``plan``, index-vector preparation for the attention kernels,
and the helpers of ``profile_generate``."""

import numpy as np
import pytest
import torch

from block_transformer_tpu_torch import config
from block_transformer_tpu_torch import profile_generate as pg
from block_transformer_tpu_torch.kernels import dequant_matmul as k1
from block_transformer_tpu_torch.kernels import flash_attention as k3
from block_transformer_tpu_torch.ops import masks


@pytest.mark.parametrize("M,K,N", [
    (8, 2048, 6144), (8, 8192, 2048), (8, 2048, 50304), (4096, 2048, 6144),
    (1, 32, 8), (3, 100, 37), (16, 300, 64), (17, 4096, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_k_covers_k_without_empty_splits(M, K, N, dtype):
    p = k1.plan(M, K, N, dtype, sms=132)
    splits, kps = p.splits, p.k_per_split
    assert splits >= 1 and kps % p.tile[2] == 0
    assert splits * kps >= K > (splits - 1) * kps     # last split non-empty
    if splits > 1 and p.route == "fma":
        assert kps >= 256                               # each split >= 256 deep


def test_split_k_only_when_tiles_are_few():
    for dtype in (torch.float32, torch.bfloat16):
        assert k1.plan(4096, 2048, 6144, dtype, sms=132)[2:] == (1, 2048)
        p = k1.plan(8, 2048, 2048, dtype, sms=132)
        assert p.splits > 1 and (2048 // p.tile[1]) * p.splits >= 132


def test_index_vectors_broadcast_and_default_valid():
    q_idx = torch.arange(3, dtype=torch.int32) + 5
    kv_idx = torch.arange(10, dtype=torch.int64)
    m = masks.AttnMask(q_idx, kv_idx, None)
    qi, ki, kv = k3.index_vectors(m, 2, 3, 10, "cpu")
    assert qi.shape == (2, 3) and qi.is_contiguous() and qi.dtype == torch.int32
    assert torch.equal(qi[1], q_idx)
    assert ki.dtype == torch.int32 and kv.dtype == torch.int32
    assert bool((kv == 1).all()) and kv.shape == (2, 10)
    with pytest.raises(ValueError):
        k3.index_vectors(m, 2, 3, 11, "cpu")


def test_busy_time_is_the_union_of_intervals():
    assert pg._busy_us([]) == 0.0
    assert pg._busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17.0


def test_ragged_prompts():
    cfg = config.make_block_config("t", 128, 2, vocab_size=512)
    ids, att, bam = pg.ragged_prompts(cfg, batch=3, prompt_tokens=32, seed=1)
    assert ids.shape == att.shape == (3, 8, 4) and bam.shape == (3, 8)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(bam.sum(-1), [8, 4, 0])
    assert (ids[att == 0] == cfg.pad_token_id).all()
    assert (ids[att == 1] > 0).all() and (ids < cfg.vocab_size).all()
