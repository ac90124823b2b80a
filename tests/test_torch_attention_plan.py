"""How the attention kernels K2 and K3 cut their work, checked on the CPU
with no card: K2's ``plan`` (the split of the INT8 cache over blocks) and
K3's ``route`` (tensor cores or CUDA cores), and torch models of the two
algorithms those choices rely on, held against the plain versions:

- K2 splits the capacity into runs of whole 32-slot tiles; each split keeps
  (max, sum, acc) and the last split to arrive merges them. A split whose
  every slot is masked, and a batch row with no allowed key, must merge to
  what ``decode_attention_int8_stacked_plain`` gives.
- K3's tensor-core kernel skips key tiles that no row of its query tile may
  see; a row with no allowed key then gets a closing pass, the uniform mean
  over all K values, as ``attention_xla`` gives.

Main-path shapes: the block decoder of ``block_main_b4_1.2b`` (B = 8 or 16,
H = 16, D = 128, capacity 640) and the ``vanilla_410`` baseline (B = 8,
H = 16, D = 64, capacity 2176).
"""

import math

import numpy as np
import pytest
import torch

from block_transformer_tpu_torch import config
from block_transformer_tpu_torch.kernels import decode_attention as k2
from block_transformer_tpu_torch.kernels import flash_attention as k3
from block_transformer_tpu_torch.ops import masks
from block_transformer_tpu_torch.ops import quant
from block_transformer_tpu_torch.ops.attention import attention_xla

SMS = 132           # an H100 SXM's streaming multiprocessors
F32_TOL = 1e-5
BF16_REL = 1e-2


def _main_path_caches():
    """(B, H, D, cap) of every decode step K2 serves at full width."""
    cfg = config.get_config("block_main_b4_1.2b")
    v = config.get_vanilla_config("vanilla_410")
    bd = cfg.block_decoder
    return [(8, bd.num_heads, bd.head_dim, 640),      # generate_blocks
            (16, bd.num_heads, bd.head_dim, 640),     # the engine's 16 slots
            (8, v.num_heads, v.head_dim, 2048 + 128)]  # the baseline


PLAN_CASES = _main_path_caches() + [
    (1, 1, 32, 40), (2, 3, 64, 100), (3, 4, 128, 300), (8, 16, 128, 40),
    (1, 2, 64, 2176), (64, 32, 128, 640)]


def test_main_path_caches_are_the_published_widths():
    assert _main_path_caches() == [(8, 16, 128, 640), (16, 16, 128, 640),
                                   (8, 16, 64, 2176)]


@pytest.mark.parametrize("B,H,D,cap", PLAN_CASES)
def test_k2_splits_cover_the_cache_in_whole_tiles(B, H, D, cap):
    p = k2.plan(B, H, cap, SMS)
    assert p.slots_per_split % k2.TILE == 0 and p.slots_per_split > 0
    assert p.splits * p.slots_per_split >= cap
    assert (p.splits - 1) * p.slots_per_split < cap   # no empty split


@pytest.mark.parametrize("B,H,D,cap", PLAN_CASES)
def test_k2_fills_the_card(B, H, D, cap):
    """Two blocks a SM at least where B*H alone is fewer than the SMs,
    unless the cache has fewer tiles than that takes (then one tile a
    split); one split where B*H alone puts BLOCKS_PER_SM blocks on every
    SM."""
    p = k2.plan(B, H, cap, SMS)
    tiles = -(-cap // k2.TILE)
    if B * H >= k2.BLOCKS_PER_SM * SMS:
        assert p.splits == 1
    elif B * H < SMS:
        assert (p.splits * B * H >= 2 * SMS
                or (p.splits == tiles and p.slots_per_split == k2.TILE))


def test_k2_main_path_plans():
    """The block decoder and the baseline at B = 8 split into 5 runs, 640
    blocks on the 132 SMs; the engine's 16 slots into 3."""
    assert k2.plan(8, 16, 640, SMS) == k2.Plan(5, 128)
    assert k2.plan(8, 16, 2176, SMS) == k2.Plan(5, 448)
    assert k2.plan(16, 16, 640, SMS) == k2.Plan(3, 224)


@pytest.mark.parametrize("B,H,D,cap", PLAN_CASES)
@pytest.mark.parametrize("S", [1, 8])
def test_k2_scratch_follows_from_the_plan(B, H, D, cap, S):
    p = k2.plan(B, H, cap, SMS)
    floats = k2.scratch_floats(p, B, H, S, D)
    assert floats == (B * H * p.splits * S * (D + 2) if p.splits > 1 else 0)


def test_k2_plan_is_pure():
    assert k2.plan(8, 16, 640, SMS) == k2.plan(8, 16, 640, SMS)
    assert k2.plan(8, 16, 640, 66).splits <= k2.plan(8, 16, 640, SMS).splits


@pytest.mark.parametrize("D", range(1, k3.MAX_HEAD_DIM + 1))
def test_k3_route_by_dtype_and_head_dim(D):
    tc = D in (64, 128)
    assert k3.route(torch.bfloat16, D, 2176) == ("tc" if tc else "fma")
    assert k3.route(torch.float32, D, 2176) == "fma"
    assert k3.route(torch.float16, D, 2176) == "fma"


def test_k3_route_needs_alignment_and_a_bounded_k():
    assert k3.route(torch.bfloat16, 128, 512, aligned=False) == "fma"
    assert k3.route(torch.bfloat16, 64, k3.TC_MAX_KEYS) == "tc"
    assert k3.route(torch.bfloat16, 64, k3.TC_MAX_KEYS + 1) == "fma"


# --------------------------------------------------------------------------
# K2: the split-and-merge algebra


def _split_merge(q, kq, ks, vq, vs, layer, mask, p):
    """K2's algorithm in torch: float32 scores q . k_q * k_scale / sqrt(D),
    -1e30 where masked; per split of ``p`` its (max, sum, acc) with the
    probabilities times v_scale; then the merge."""
    B, H, S, D = q.shape
    cap = kq.shape[3]
    allowed = mask.allowed()[:, None]                      # [B, 1, S, cap]
    sc = torch.einsum("bhsd,bhjd->bhsj", q.float(), kq[layer].float())
    sc = sc * (ks[layer][:, :, None, :] / math.sqrt(D))
    sc = torch.where(allowed, sc, torch.tensor(masks.NEG_INF))
    parts = []
    for z in range(p.splits):
        sl = slice(z * p.slots_per_split, min(cap, (z + 1) * p.slots_per_split))
        s = sc[..., sl]
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        acc = torch.einsum("bhsj,bhjd->bhsd", e * vs[layer][:, :, None, sl],
                           vq[layer][:, :, sl].float())
        parts.append((m, e.sum(-1, keepdim=True), acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - mx) for m, _, a in parts)
    return (acc / lsum).to(q.dtype), parts


def _int8_cache(rng, L, B, H, cap, D):
    kv = torch.from_numpy(rng.standard_normal((2, L * B, H, cap, D),
                                              dtype=np.float32))
    kq, ks = quant.quantize_kv(kv[0])
    vq, vs = quant.quantize_kv(kv[1])
    return (kq.reshape(L, B, H, cap, D), ks.reshape(L, B, H, cap),
            vq.reshape(L, B, H, cap, D), vs.reshape(L, B, H, cap))


@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("case", ["masked_splits", "no_key", "ragged"])
def test_k2_split_merge_matches_plain(case, S):
    """masked_splits: the write frontier at slot 40 of 300, so every split
    past the second holds only masked slots; no_key: batch row 1 may see no
    slot (uniform mean over the capacity); ragged: capacity 100, the last
    split one partial tile."""
    rng = np.random.default_rng(S)
    B, H, D, L = 3, 2, 32, 2
    cap = 100 if case == "ragged" else 300
    length = cap - S if case == "ragged" else 40
    kq, ks, vq, vs = _int8_cache(rng, L, B, H, cap, D)
    q = torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32))
    valid = torch.ones((B, cap), dtype=torch.int32)
    valid[2, :length // 3] = 0                 # left pad
    if case == "no_key":
        valid[1] = 0
    mask = masks.decode_mask(length, cap, S, valid, device="cpu")
    p = k2.plan(B, H, cap, 8)                  # a small card: several splits
    assert p.splits > 2
    got, parts = _split_merge(q, kq, ks, vq, vs, 1, mask, p)
    want = k2.decode_attention_int8_stacked_plain(q, kq, ks, vq, vs, 1, mask)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    if case == "masked_splits":                # splits with no allowed slot
        assert all(bool((m == masks.NEG_INF).all()) for m, _, _ in parts[2:])
    if case == "no_key":
        torch.testing.assert_close(
            got[1], (vq[1, 1].float() * vs[1, 1][..., None]).mean(1,
                                                                  keepdim=True)
            .expand(H, S, D), rtol=F32_TOL, atol=F32_TOL)


# --------------------------------------------------------------------------
# K3: key-tile skipping and the closing pass


def _flash_skip(q, k, v, mask, BQ, BKV=64):
    """K3's tensor-core algorithm in torch: per query tile of BQ rows, visit
    only the key tiles of BKV keys holding a valid key with kv_idx <= the
    tile's largest q_idx (kv_idx need not be sorted); online softmax over
    them, probabilities rounded to q.dtype before P.V; rows whose max is
    still -1e30 get the uniform mean over all K values. Returns (out,
    visited tiles, tiles)."""
    B, H, Q, D = q.shape
    K = k.shape[2]
    q_idx, kv_idx, valid = k3.index_vectors(mask, B, Q, K, "cpu")
    scale = 1.0 / math.sqrt(D)
    out = torch.empty(B, H, Q, D)
    visited = total = 0
    for b in range(B):
        for q0 in range(0, Q, BQ):
            rows = slice(q0, min(Q, q0 + BQ))
            qi = q_idx[b, rows]
            qmax = int(qi.max())
            m = torch.full((H, qi.numel(), 1), masks.NEG_INF)
            l = torch.zeros(H, qi.numel(), 1)
            o = torch.zeros(H, qi.numel(), D)
            for k0 in range(0, K, BKV):
                cols = slice(k0, min(K, k0 + BKV))
                ok = valid[b, cols] != 0
                total += 1
                if not bool((ok & (kv_idx[cols] <= qmax)).any()):
                    continue
                visited += 1
                s = q[b, :, rows].float() @ k[b, :, cols].float().mT * scale
                allowed = ok[None] & (kv_idx[cols][None] <= qi[:, None])
                s = torch.where(allowed[None], s, torch.tensor(masks.NEG_INF))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                o = o * corr + p.to(q.dtype).float() @ v[b, :, cols].float()
                m = m_new
            res = o / l.clamp_min(1e-30)
            none = (m == masks.NEG_INF).expand_as(res)
            res = torch.where(none, v[b].float().mean(1, keepdim=True), res)
            out[b, :, rows] = res
    return out.to(q.dtype), visited, total


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BQ", [64, 128])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_k3_tile_skipping_matches_plain(n, BQ, dtype):
    """A left-padded, block-causal fresh prefill (n embeddings a block):
    the padded row's first queries see no key, and the later key tiles lie
    past the early query tiles' diagonal."""
    rng = np.random.default_rng(n)
    B, H, Q, D = 2, 2, 300, 64
    K = Q
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, n_, D),
                                                    dtype=np.float32)).to(dtype)
               for n_ in (Q, K, K))
    valid = torch.ones((B, K), dtype=torch.int32)
    valid[1, :70] = 0                          # left pad of 70 slots
    mask = masks.block_decode_mask(0, K, Q, valid, n)
    got, visited, total = _flash_skip(q, k, v, mask, BQ)
    assert visited < total                     # tiles were skipped
    assert bool((~mask.allowed().any(-1)).any())   # rows with no key
    want = attention_xla(q, k, v, mask)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_REL * want.float().abs().max().item(), err


@pytest.mark.parametrize("case", ["unsorted", "all_masked", "tail_query"])
def test_k3_tile_skipping_edge_masks(case):
    """unsorted: kv_idx permuted, so skipping may not assume order;
    all_masked: a batch row with no valid key; tail_query: a prompt of 130
    queries after 130 cached slots (most key tiles visited)."""
    rng = np.random.default_rng(7)
    B, H, D, Q, K = 2, 2, 32, 130, 260
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, n_, D),
                                                    dtype=np.float32))
               for n_ in (Q, K, K))
    valid = torch.ones((B, K), dtype=torch.int32)
    kv_idx = torch.arange(K, dtype=torch.int32)
    q_idx = torch.arange(Q, dtype=torch.int32)
    if case == "unsorted":
        kv_idx = kv_idx[torch.from_numpy(rng.permutation(K))]
    elif case == "all_masked":
        valid[0] = 0
    else:
        q_idx = q_idx + (K - Q)
    mask = masks.AttnMask(q_idx, kv_idx.contiguous(), valid)
    got, visited, total = _flash_skip(q, k, v, mask, 64)
    if case == "tail_query":
        assert total // 2 < visited < total
    torch.testing.assert_close(got, attention_xla(q, k, v, mask),
                               rtol=F32_TOL, atol=F32_TOL)
