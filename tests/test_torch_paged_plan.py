"""How K6 (paged decode attention, ``kernels/paged_attention.py``) cuts its
work, checked on the CPU with no card: the split of the virtual capacity
that K2's ``plan`` gives it, the scratch that follows, and a torch model of
the kernel's algorithm held against ``paged_decode_attention_int8_plain``
in float32 on INT8 and packed INT4 pools:

- the ``n_virt * ps`` virtual slots are cut into splits of whole 32-slot
  tiles; a tile in which no query row may see a slot is skipped (no key,
  value or scale read), so a split may skip every tile;
- each split keeps (max, sum, acc) and the merge runs in split order; the
  ``fresh`` term is folded in once, at the merge;
- a row with no allowed key in any split and no fresh term takes the
  uniform mean over all K virtual positions;
- a page id outside [0, P) is read as the null page 0; with ``ps = 10`` a
  tile crosses pages.

Main-path shape: the paged engines of ``block_main_b4_1.2b`` (16 slots,
16 heads of 128, 3 pages of 256 slots a row).
"""

import math

import numpy as np
import pytest
import torch

from block_transformer_tpu_torch import config
from block_transformer_tpu_torch import profile_generate as pg
from block_transformer_tpu_torch.kernels import decode_attention as k2
from block_transformer_tpu_torch.kernels import paged_attention as kp
from block_transformer_tpu_torch.ops import masks
from block_transformer_tpu_torch.ops import quant

SMS = 132           # an H100 SXM's streaming multiprocessors
F32_TOL = 1e-5
TILE = k2.TILE


def _engine_shape():
    """(B, H, virtual slots) of the paged engines' decode step, as
    ``profile_generate.make_engine`` sizes the pool."""
    cfg = config.get_config(pg.MODEL)
    cap = pg.ENGINE_MAX_BLOCKS * cfg.n_embedding_tokens
    cap = -(-cap // 128) * 128
    ps = min(pg.ENGINE_PAGE_SIZE, cap)
    return pg.ENGINE_SLOTS, cfg.block_decoder.num_heads, -(-cap // ps) * ps


# (B, H, ps, n_virt) of the card tests (tests/test_torch_kernels_gpu.py)
CARD_SHAPES = [(3, 2, 16, 3), (2, 3, 10, 4), (4, 2, 48, 2), (1, 2, 256, 3),
               (3, 2, 256, 3), (3, 4, 10, 8), (3, 4, 32, 3), (40, 16, 16, 4),
               (40, 16, 32, 2), (3, 2, 10, 5)]


def test_engine_plan_is_three_splits_of_a_page():
    B, H, K = _engine_shape()
    assert (B, H, K) == (16, 16, 768)
    assert k2.plan(B, H, K, SMS) == k2.Plan(3, 256)


@pytest.mark.parametrize("B,H,ps,n_virt", CARD_SHAPES)
def test_card_shapes_split_in_whole_tiles(B, H, ps, n_virt):
    """Splits cover the virtual capacity in whole tiles with none empty;
    one split exactly where B * H alone puts BLOCKS_PER_SM blocks on every
    SM (the card tests assert the same)."""
    K = ps * n_virt
    p = k2.plan(B, H, K, SMS)
    assert p.slots_per_split % TILE == 0
    assert p.splits * p.slots_per_split >= K > (p.splits - 1) * p.slots_per_split
    assert (p.splits == 1) == (B * H >= k2.BLOCKS_PER_SM * SMS)


@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("B,H,ps,n_virt", CARD_SHAPES + [(16, 16, 256, 3)])
def test_scratch_follows_from_the_plan(B, H, ps, n_virt, S):
    D = 128
    p = k2.plan(B, H, ps * n_virt, SMS)
    floats = k2.scratch_floats(p, B, H, S, D)
    assert floats == (B * H * p.splits * S * (D + 2) if p.splits > 1 else 0)
    if (B, H, S) == (16, 16, 1):               # the engine: 3 splits
        assert floats == 16 * 16 * 3 * 130


# --------------------------------------------------------------------------
# K6's algorithm in torch


def _k6_model(q, k_pool, k_s, v_pool, v_s, layer, page_table, mask, p,
              fresh=None):
    """K6's kernel as torch code, float32: per split of ``p`` and per tile
    of 32 virtual slots, skip the tile when no query row may see a slot;
    else scores q . k_q * k_scale / sqrt(D) (-1e30 where masked) into an
    online softmax (max, sum, acc with p * v_scale). Merge the splits in
    order, fold in ``fresh`` once, and give a row whose max is still -1e30
    (and no fresh term) the mean of v_scale * v_q over all K slots.
    Returns (out, tiles visited, tiles, splits with every tile skipped)."""
    B, H, S, D = q.shape
    if quant.kv_bits(k_pool) == 4:
        k_pool, v_pool = quant.unpack_kv_int4(k_pool), quant.unpack_kv_int4(
            v_pool)
    P, ps = k_pool.shape[1], k_pool.shape[3]
    n_virt = page_table.shape[1]
    K = n_virt * ps
    page = torch.where((page_table < 0) | (page_table >= P), 0,
                       page_table).long()
    j = torch.arange(K)

    def rows(pool):                            # [B, H, K(, D)] of the layer
        x = pool[layer][page[:, j // ps], :, j % ps]   # [B, K, H(, D)]
        return x.transpose(1, 2).float()

    kq, ks, vq, vs = rows(k_pool), rows(k_s), rows(v_pool), rows(v_s)
    q_idx, kv_idx, valid = kp.index_vectors(mask, B, S, K, "cpu")
    allowed = (valid[:, None] != 0) & (kv_idx[None, None] <= q_idx[..., None])
    sc = torch.einsum("bhsd,bhjd->bhsj", q.float(), kq) * (
        ks[:, :, None] / math.sqrt(D))
    sc = torch.where(allowed[:, None], sc, torch.tensor(masks.NEG_INF))
    out = torch.empty(B, H, S, D)
    visited = total = skipped_splits = 0
    for b in range(B):
        parts = []
        for z in range(p.splits):
            m = torch.full((H, S, 1), masks.NEG_INF)
            l = torch.zeros(H, S, 1)
            acc = torch.zeros(H, S, D)
            live = 0
            for j0 in range(z * p.slots_per_split,
                            min(K, (z + 1) * p.slots_per_split), TILE):
                cols = slice(j0, min(K, j0 + TILE))
                total += 1
                if not bool(allowed[b, :, cols].any()):
                    continue                   # no key, value or scale read
                live += 1
                s = sc[b, :, :, cols]
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.exp(m - m_new)
                e = torch.exp(s - m_new)
                l = l * corr + e.sum(-1, keepdim=True)
                acc = acc * corr + (e * vs[b, :, None, cols]) @ vq[b, :, cols]
                m = m_new
            visited += live
            skipped_splits += live == 0
            parts.append((m, l, acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        acc = sum(a * torch.exp(m - mx) for m, _, a in parts)
        if fresh is not None:                  # S == 1, always allowed
            kf, vf = fresh
            s_f = (q[b].float() * kf[b, :, None]).sum(-1, keepdim=True) / (
                math.sqrt(D))
            m2 = torch.maximum(mx, s_f)
            lsum = lsum * torch.exp(mx - m2) + torch.exp(s_f - m2)
            acc = acc * torch.exp(mx - m2) + torch.exp(s_f - m2) * vf[b, :,
                                                                      None]
            res = acc / lsum
        else:
            res = acc / lsum.clamp_min(1e-30)
            mean = (vs[b, :, :, None] * vq[b]).mean(1, keepdim=True)
            res = torch.where(mx == masks.NEG_INF, mean.expand_as(res), res)
        out[b] = res
    return out.to(q.dtype), visited, total, skipped_splits


def _case(rng, bits, B, H, S, D, ps, n_virt, fresh):
    """Pools, page table (two ids outside [0, P) when B > 2), mask and
    fresh pair of a K6 case: row 0 holds one page and sees fewer than ps
    slots; row 1 (B > 2) has no allowed pool key; the last row is
    left-padded."""
    L, P = 2, B * n_virt + 1
    shape = (L, P, H, ps, D)
    if bits == 8:
        def values():
            return torch.from_numpy(rng.integers(-127, 128, shape,
                                                 dtype=np.int8))
    else:
        def values():
            return torch.from_numpy(rng.integers(0, 256, shape[:-1] + (D // 2,),
                                                 dtype=np.uint8))

    def scales():
        return torch.from_numpy(
            (0.01 + 0.02 * rng.random(shape[:-1])).astype(np.float32))

    pools = [values(), scales(), values(), scales()]
    cap = ps * n_virt
    pt = torch.from_numpy(1 + rng.permutation(B * n_virt)).reshape(
        B, n_virt).to(torch.int32)
    pt[0, 1:] = 0
    lengths = torch.from_numpy(rng.integers(S + 1, cap, B))
    lengths[0] = min(ps, cap) - 1
    valid = (torch.arange(cap)[None] < lengths[:, None]).to(torch.int32)
    valid[-1, :3] = 0
    if B > 2:
        valid[1] = 0
        pt[1, 0], pt[2, -1] = -2, P + 3
    q_idx = lengths[:, None] - S + torch.arange(S)[None] - int(fresh)
    mask = masks.AttnMask(q_idx.to(torch.int32),
                          torch.arange(cap, dtype=torch.int32), valid)
    q = torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32))
    pair = None
    if fresh:
        pair = tuple(torch.from_numpy(0.1 * rng.standard_normal(
            (B, H, D), dtype=np.float32)) for _ in range(2))
    return pools, pt, mask, q, pair


# (bits, B, H, S, D, ps, n_virt, fresh, SMs): few SMs give several splits
# at these small B * H
MODEL_CASES = [
    (8, 3, 2, 1, 32, 16, 4, True, 8),      # fresh folded once, 2 splits
    (8, 3, 2, 1, 32, 16, 4, False, 8),     # row 1: the uniform mean
    (8, 2, 3, 4, 64, 10, 8, False, 8),     # ps = 10: tiles cross pages
    (8, 3, 2, 8, 32, 32, 3, False, 2),     # S = 8, 3 splits
    (8, 3, 2, 1, 64, 256, 3, True, SMS),   # the engine's pages, 24 splits
    (8, 40, 16, 1, 32, 16, 4, True, SMS),  # one split
    (4, 3, 2, 1, 32, 16, 4, False, 8),
    (4, 2, 3, 4, 64, 10, 8, False, 8),
    (4, 3, 2, 8, 32, 32, 3, False, 2),
    (4, 3, 2, 1, 64, 256, 3, False, SMS),
    (4, 40, 16, 1, 32, 16, 4, False, SMS),
]


@pytest.mark.parametrize("bits,B,H,S,D,ps,n_virt,fresh,sms", MODEL_CASES)
def test_k6_model_matches_plain(bits, B, H, S, D, ps, n_virt, fresh, sms):
    rng = np.random.default_rng(B * 100 + S * 10 + bits)
    pools, pt, mask, q, pair = _case(rng, bits, B, H, S, D, ps, n_virt,
                                     fresh)
    p = k2.plan(B, H, ps * n_virt, sms)
    got, visited, total, skipped = _k6_model(q, *pools, 1, pt, mask, p,
                                             fresh=pair)
    null = torch.where((pt < 0) | (pt >= pools[0].shape[1]), 0, pt)
    want = kp.paged_decode_attention_int8_plain(q, *pools, 1, null, mask,
                                                fresh=pair)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    assert visited < total                     # row 0's tail is skipped
    if p.splits > 1:
        assert skipped > 0                     # a split with no tile read
    if B > 2 and not fresh:                    # row 1: the uniform mean
        k = quant.unpack_kv_int4(pools[2]) if bits == 4 else pools[2]
        rows = k[1][null[1].long()].float() * pools[3][1][null[1].long()][
            ..., None]                         # [n_virt, H, ps, D]
        mean = rows.transpose(0, 1).reshape(H, -1, D).mean(1, keepdim=True)
        torch.testing.assert_close(got[1], mean.expand(H, S, D),
                                   rtol=F32_TOL, atol=F32_TOL)
    if B > 2 and fresh:                        # row 1: only the fresh value
        torch.testing.assert_close(got[1, :, 0], pair[1][1],
                                   rtol=F32_TOL, atol=F32_TOL)
