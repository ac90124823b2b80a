"""K2's unquantized form as its CUDA kernels compute it, on the CPU.

- ``route``: which kernel serves each main-path shape (the token decoder's
  local cache of 6 slots goes to the warp route, every longer cache and
  every INT8 cache to the split route), the edges of the warp route's
  envelope, and the shapes neither takes.
- ``mask_args``: the kernels get the mask's own int32 vectors (same
  storage), ``q_idx`` as [S] (row stride 0) or [B, S] (row stride S) and no
  ``kv_valid`` when the mask has none; a vector is converted only when it
  is not int32 or not contiguous.
- A torch model of the warp route, lane by lane: each of 32 lanes owns
  D / 32 dims, key rows come in groups of 8, the 8 * NS partial scores are
  reduced by the halving butterfly (the model checks which lane holds which
  (query row, key row) sum, as the kernel's shuffles assume), the online
  softmax runs per segment of lanes, p is rounded to the cache's dtype
  before P.V, and a row with no allowed key gets the uniform mean over all
  cap slots. Held against the plain version and against the JAX package's
  Pallas kernel (``decode_attention_stacked(..., interpret=True)``) in
  float32 within 1e-5 of the output's scale, the tolerance of
  ``tests/test_torch_decode_bf16.py`` (the same float32 products and
  softmax, summed in another order).
- The same lane model driving the split route: 4 warps a block, each warp
  8 rows of every 32-slot tile of its split, the warps merged, then the
  splits, against the plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu.ops import decode_attention as jax_da
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu_torch import config
from block_transformer_tpu_torch.kernels import decode_attention as k2
from block_transformer_tpu_torch.ops import masks

F32_TOL = 1e-5
LANES = 32
G = 8              # key rows a warp takes at a time
NEG = masks.NEG_INF


def _local_cache():
    """(H, D, cap, prefix rows) of the token decoder's local cache."""
    cfg = config.get_config("block_main_b4_1.2b")
    t = cfg.token_decoder.neox
    return (t.num_heads, t.head_dim, cfg.n_expanded_emb + cfg.block_length,
            cfg.n_expanded_emb)


# --------------------------------------------------------------------------
# route


def test_local_cache_is_the_published_width():
    assert _local_cache() == (16, 128, 6, 2)


@pytest.mark.parametrize("cap,S,D,dtype,want", [
    (6, 1, 128, torch.bfloat16, "warp"),     # token step on the local cache
    (6, 2, 128, torch.bfloat16, "warp"),     # the prefix step
    (640, 1, 128, torch.bfloat16, "split"),  # block decoder, bf16 cache
    (640, 1, 128, torch.int8, "split"),      # block decoder, INT8 cache
    (2176, 1, 64, torch.int8, "split"),      # the vanilla_410 baseline
    (6, 1, 128, torch.float32, "warp"),      # float32 runs
    (1, 1, 32, torch.bfloat16, "warp"),      # the envelope's edges
    (31, 8, 64, torch.bfloat16, "warp"),
    (32, 3, 128, torch.float32, "warp"),
    (33, 1, 128, torch.bfloat16, "split"),
    (6, 1, 128, torch.int8, "split"),        # INT8 never takes the warp route
])
def test_route_at_main_path_shapes(cap, S, D, dtype, want):
    assert k2.route(cap, S, D, dtype) == want


def test_route_of_the_engine_slots():
    """The engine's 16 slots: B does not enter the route, so the local
    cache goes to the warp route and the global one to the split route at
    16 slots as at 8."""
    H, D, cap, n_exp = _local_cache()
    assert k2.route(cap, 1, D, torch.bfloat16) == "warp"
    assert k2.route(cap, n_exp, D, torch.bfloat16) == "warp"
    assert k2.plan(16, H, 640, 132) == k2.Plan(3, 224)
    assert k2.route(640, 1, D, torch.bfloat16) == "split"


@pytest.mark.parametrize("cap,S", [(6, 1), (6, 2), (40, 1)])
def test_cpu_tensors_take_the_plain_version_and_count_nothing(cap, S):
    """On CPU tensors the wrapper returns the plain version's result, for a
    warp-route and a split-route shape alike, and counts no launch: the
    counters move only where a kernel is launched."""
    H, D = 2, 32
    g = torch.Generator().manual_seed(cap + S)
    k, v = (torch.randn((2, 3, H, cap, D), generator=g) for _ in range(2))
    q = torch.randn((3, H, S, D), generator=g)
    mask = masks.decode_mask(cap - S, cap, S, device="cpu")
    before = (k2.decode_attention_stacked.launches,
              dict(k2.decode_attention_stacked.route_launches))
    got = k2.decode_attention_stacked(q, k, v, 1, mask)
    assert torch.equal(
        got, k2.decode_attention_stacked_plain(q, k, v, 1, mask))
    assert (k2.decode_attention_stacked.launches,
            k2.decode_attention_stacked.route_launches) == before


@pytest.mark.parametrize("cap,S,D,dtype,err", [
    (6, 0, 128, torch.bfloat16, ValueError),
    (6, 9, 128, torch.bfloat16, ValueError),
    (6, 1, 96, torch.bfloat16, ValueError),
    (0, 1, 128, torch.bfloat16, ValueError),
    (6, 1, 128, torch.float16, TypeError),
])
def test_route_raises_outside_both_envelopes(cap, S, D, dtype, err):
    with pytest.raises(err):
        k2.route(cap, S, D, dtype)


# --------------------------------------------------------------------------
# mask_args


CPU = torch.device("cpu")


def test_mask_args_hands_over_the_mask_storage():
    """The token decoder's mask: 1-D q_idx (stride 0), no kv_valid."""
    m = masks.decode_mask(4, 6, 1, device="cpu")
    a = k2.mask_args(m, 8, 1, 6, CPU)
    assert a.q_idx.data_ptr() == m.q_idx.data_ptr() and a.q_stride == 0
    assert a.kv_idx.data_ptr() == m.kv_idx.data_ptr()
    assert a.kv_valid is None


def test_mask_args_batched_q_idx_and_valid():
    """The block decoder's int32 kv_valid and a [B, S] q_idx pass as they
    are, with row stride S."""
    valid = torch.ones((3, 40), dtype=torch.int32)
    q_idx = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    m = masks.AttnMask(q_idx, torch.arange(40, dtype=torch.int32), valid)
    a = k2.mask_args(m, 3, 2, 40, CPU)
    assert a.q_idx.data_ptr() == q_idx.data_ptr() and a.q_stride == 2
    assert a.kv_valid.data_ptr() == valid.data_ptr()
    m = masks.block_decode_mask(39, 40, 1, valid)
    a = k2.mask_args(m, 3, 1, 40, CPU)
    assert a.q_stride == 0 and a.kv_valid.data_ptr() == valid.data_ptr()


@pytest.mark.parametrize("which", ["q_idx", "kv_idx", "kv_valid"])
@pytest.mark.parametrize("how", ["int64", "bool", "strided"])
def test_mask_args_converts_only_what_it_must(which, how):
    B, S, cap = 3, 2, 10
    vec = {"q_idx": torch.arange(B * S, dtype=torch.int32).reshape(B, S),
           "kv_idx": torch.arange(cap, dtype=torch.int32),
           "kv_valid": torch.ones((B, cap), dtype=torch.int32)}
    want = vec[which].clone()
    if how == "int64":
        vec[which] = vec[which].long()
    elif how == "bool":
        vec[which] = vec[which] != 0
        want = (want != 0).int()
    else:      # the same values through a non-contiguous view
        vec[which] = torch.stack([vec[which]] * 2, -1)[..., 0]
        assert not vec[which].is_contiguous()
    m = masks.AttnMask(vec["q_idx"], vec["kv_idx"], vec["kv_valid"])
    a = k2.mask_args(m, B, S, cap, CPU)
    got = {"q_idx": a.q_idx, "kv_idx": a.kv_idx, "kv_valid": a.kv_valid}
    for name, t in got.items():
        assert t.dtype == torch.int32 and t.is_contiguous()
        same = t.data_ptr() == vec[name].data_ptr()
        assert same == (name != which), name
    assert torch.equal(got[which], want)


def test_mask_args_engine_q_idx_is_not_copied():
    """The engine's q_idx, slot_len[:, None].expand(B, 1), is contiguous."""
    slot_len = torch.arange(16, dtype=torch.int32)
    q_idx = slot_len[:, None].expand(16, 1)
    m = masks.AttnMask(q_idx, torch.arange(640, dtype=torch.int32),
                       torch.ones((16, 640), dtype=torch.int32))
    a = k2.mask_args(m, 16, 1, 640, CPU)
    assert a.q_idx.data_ptr() == slot_len.data_ptr() and a.q_stride == 1


@pytest.mark.parametrize("q_idx,kv,valid", [
    ((2, 3), 10, None),      # q_idx batch 2 for B = 3
    ((4,), 10, None),        # 1-D q_idx of the wrong length
    ((3, 2), 9, None),       # kv_idx shorter than cap
    ((3, 2), 10, (2, 10)),   # kv_valid batch 2
])
def test_mask_args_rejects_shapes(q_idx, kv, valid):
    m = masks.AttnMask(torch.zeros(q_idx, dtype=torch.int32),
                       torch.arange(kv, dtype=torch.int32),
                       None if valid is None
                       else torch.ones(valid, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not fit"):
        k2.mask_args(m, 3, 2, 10, CPU)


# --------------------------------------------------------------------------
# the lanes-over-D model


class Layout:
    """Where the kernel keeps each score: NS query rows (S rounded up to a
    power of two), P = 8 * NS partials a lane, R full sums a lane after
    the halving butterfly, DUP lanes holding each, SEG lanes a query row."""

    def __init__(self, S):
        self.NS = 1 << (S - 1).bit_length()
        self.P = G * self.NS
        self.R = self.P // LANES if self.P > LANES else 1
        self.DUP = 1 if self.P >= LANES else LANES // self.P
        self.SEG = LANES // self.NS
        lane = torch.arange(LANES)
        # [32, R]: the (s * G + j) index a lane's r-th sum belongs to
        self.idx = (lane // self.DUP)[:, None] * self.R + torch.arange(self.R)
        self.s_of_lane = lane // self.SEG

    def lane_of(self, s, j):
        i = s * G + j
        return (i // self.R) * self.DUP, i % self.R


def _halve(v):
    """The kernel's halving butterfly on [..., 32 lanes, P] partials."""
    lane = torch.arange(LANES)
    n, o = v.shape[-1], 16
    while n > 1 and o > 0:
        up = ((lane & o) != 0)[:, None]
        h = n // 2
        send = torch.where(up, v[..., :h], v[..., h:n])
        keep = torch.where(up, v[..., h:n], v[..., :h])
        v = keep + send[..., lane ^ o, :]
        n, o = h, o // 2
    while o > 0:
        v = v + v[..., lane ^ o, :]
        o //= 2
    return v


def _seg(x, lay, op):
    """Reduce [..., 32] over the lanes of each query row's segment that
    hold distinct sums (xor offsets DUP .. SEG/2)."""
    lane = torch.arange(LANES)
    o = lay.DUP
    while o < lay.SEG:
        x = op(x, x[..., lane ^ o])
        o *= 2
    return x


class WarpState:
    """One warp per (b, h): q [B, H, NS, 32, N], (m, l) [B, H, 32] for each
    lane's query row, acc [B, H, NS, 32, N]."""

    def __init__(self, q, q_idx_rows, lay):
        B, H, S, D = q.shape
        self.lay, self.N = lay, D // LANES
        self.q = torch.zeros(B, H, lay.NS, LANES, self.N)
        self.q[:, :, :S] = q.float().reshape(B, H, S, LANES, self.N)
        self.acc = torch.zeros_like(self.q)
        self.m = torch.full((B, H, LANES), NEG)
        self.l = torch.zeros(B, H, LANES)
        qi = torch.full((B, lay.NS), torch.iinfo(torch.int32).min,
                        dtype=torch.int64)
        qi[:, :S] = q_idx_rows
        self.qv = qi[:, lay.s_of_lane][:, None]                # [B, 1, 32]

    def step(self, kr, vr, kidx, ok, inr, scale, dtype):
        """kr, vr [B, H, G, 32, N] (zero past the end); kidx [B, G], ok
        [B, G] (row exists and is valid), inr [B, G] (row exists)."""
        lay = self.lay
        part = torch.einsum("bhsle,bhjle->bhlsj", self.q, kr.float())
        part = part.reshape(*part.shape[:3], lay.P)
        full = _halve(part)                                    # [B, H, 32, P']
        want = part.sum(2)                                     # [B, H, P]
        torch.testing.assert_close(full[..., :lay.R], want[..., lay.idx],
                                   rtol=1e-5, atol=1e-5)
        j = lay.idx % G                                        # [32, R]
        sc = full[..., :lay.R] * scale
        allow = ok[:, None][..., j] & (kidx[:, None][..., j]
                                       <= self.qv[..., None])
        sc = torch.where(allow, sc, torch.tensor(NEG))
        sc = torch.where(inr[:, None][..., j], sc, torch.tensor(-math.inf))
        mx = _seg(sc.amax(-1), lay, torch.maximum)
        m_new = torch.maximum(self.m, mx)
        corr = torch.exp(self.m - m_new)
        p = torch.exp(sc - m_new[..., None])
        self.l = self.l * corr + _seg(p.sum(-1), lay, torch.add)
        self.m = m_new
        p = p.to(dtype).float()                                # round to T
        c = corr[..., torch.arange(lay.NS) * lay.SEG]          # [B, H, NS]
        self.acc = self.acc * c[..., None, None]
        for s in range(lay.NS):
            for jj in range(G):
                ln, r = lay.lane_of(s, jj)
                self.acc[:, :, s] += (p[:, :, ln, r][..., None, None]
                                      * vr[:, :, jj].float())

    def out(self, S):
        B, H = self.m.shape[:2]
        ls = self.l[..., torch.arange(S) * self.lay.SEG].clamp_min(1e-30)
        o = self.acc[:, :, :S] / ls[..., None, None]
        return o.reshape(B, H, S, LANES * self.N)

    def per_row(self, S):
        """(m [B, H, S], l [B, H, S], acc [B, H, S, D]) for the merge."""
        B, H = self.m.shape[:2]
        rows = torch.arange(S) * self.lay.SEG
        return (self.m[..., rows], self.l[..., rows],
                self.acc[:, :, :S].reshape(B, H, S, LANES * self.N))


def _mask_vectors(mask, B, S, cap):
    a = k2.mask_args(mask, B, S, cap, CPU)
    q_idx = a.q_idx.long().reshape(-1, S).expand(B, S)
    valid = (torch.ones((B, cap), dtype=torch.bool) if a.kv_valid is None
             else a.kv_valid != 0)
    return q_idx, a.kv_idx.long(), valid


def _rows(cache, layer, rows, cap):
    """[B, H, G, 32, N] parts of cache rows ``rows`` (zero past cap)."""
    L, B, H, _, D = cache.shape
    out = torch.zeros(B, H, G, LANES, D // LANES, dtype=cache.dtype)
    for jj, j in enumerate(rows):
        if 0 <= j < cap:
            out[:, :, jj] = cache[layer, :, :, j].reshape(B, H, LANES, -1)
    return out


def warp_route_model(q, k, v, layer, mask):
    """The warp route (cap <= 32) in torch: every lane's slot mask, groups
    of 8 rows, the butterfly, the segment softmax, lane-owned P.V."""
    B, H, S, D = q.shape
    cap = k.shape[3]
    assert cap <= k2.WARP_MAX_CAP
    lay = Layout(S)
    q_idx, kv_idx, valid = _mask_vectors(mask, B, S, cap)
    st = WarpState(q, q_idx, lay)
    for g0 in range(0, cap, G):
        rows = [g0 + j for j in range(G)]
        inr = torch.tensor([r < cap for r in rows]).expand(B, G)
        kidx = torch.tensor([int(kv_idx[r]) if r < cap else 0
                             for r in rows]).expand(B, G)
        ok = inr & torch.stack([valid[:, r] if r < cap
                                else torch.zeros(B, dtype=torch.bool)
                                for r in rows], 1)
        st.step(_rows(k, layer, rows, cap), _rows(v, layer, rows, cap), kidx,
                ok, inr, 1.0 / math.sqrt(D), q.dtype)
    return st.out(S).to(q.dtype)


def _merge(states):
    """Merge (m, l, acc) states in order, as the kernel's merge does."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    lsum = sum(l * torch.exp(m - mx) for m, l, _ in states)
    acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in states)
    return mx, lsum, acc


def split_route_model(q, k, v, layer, mask, p: k2.Plan):
    """The split route in torch: per split of ``p``, 4 warps, warp w takes
    rows 8w..8w+7 of every 32-slot tile; warps merged, then splits."""
    B, H, S, D = q.shape
    cap = k.shape[3]
    lay = Layout(1 if S == 1 else k2.MAX_S)
    q_idx, kv_idx, valid = _mask_vectors(mask, B, S, cap)
    splits = []
    for z in range(p.splits):
        j_begin = z * p.slots_per_split
        j_end = min(cap, j_begin + p.slots_per_split)
        warps = []
        for w in range(4):
            st = WarpState(q, q_idx, lay)
            for j0 in range(j_begin, j_end, k2.TILE):
                rows = [j0 + w * G + j for j in range(G)]
                inr = torch.tensor([r < j_end for r in rows]).expand(B, G)
                kidx = torch.tensor([int(kv_idx[r]) if r < j_end else 0
                                     for r in rows]).expand(B, G)
                ok = inr & torch.stack(
                    [valid[:, r] if r < j_end
                     else torch.zeros(B, dtype=torch.bool) for r in rows], 1)
                st.step(_rows(k, layer, rows, j_end),
                        _rows(v, layer, rows, j_end), kidx, ok, inr,
                        1.0 / math.sqrt(D), q.dtype)
            warps.append(st.per_row(S))
        splits.append(_merge(warps))
    _, lsum, acc = _merge(splits)
    return (acc / lsum.clamp_min(1e-30)[..., None]).to(q.dtype), splits


def _case(cap, S, D, seed, B=3, H=2, L=2):
    """Numpy inputs: row 1 left-padded, row 2 with no valid key; queries at
    the last S positions of the cache (some before slot 0 when S > cap)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, B, H, cap, D)).astype(np.float32)
    v = rng.standard_normal((L, B, H, cap, D)).astype(np.float32)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    valid = np.ones((B, cap), np.int32)
    valid[1, :min(2, cap - 1)] = 0
    valid[2] = 0
    q_idx = (cap - S + np.arange(S, dtype=np.int32))[None].repeat(B, 0)
    return q, k, v, q_idx, np.arange(cap, dtype=np.int32), valid


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 2, 3, 8])
@pytest.mark.parametrize("cap", [1, 5, 6, 32])
def test_warp_route_model_matches_plain_and_pallas(cap, S, D):
    q, k, v, q_idx, kv_idx, valid = _case(cap, S, D, cap * 100 + S * 10 + D)
    mask = masks.AttnMask(_t(q_idx), _t(kv_idx), _t(valid))
    got = warp_route_model(_t(q), _t(k), _t(v), 1, mask)
    plain = k2.decode_attention_stacked_plain(_t(q), _t(k), _t(v), 1, mask)
    want = np.asarray(jax_da.decode_attention_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1,
        jax_masks.AttnMask(jnp.asarray(q_idx), jnp.asarray(kv_idx),
                           jnp.asarray(valid)), interpret=True))
    tol = dict(rtol=F32_TOL, atol=F32_TOL * np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **tol)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    # row 2 may see no key: the uniform mean over all cap slots
    np.testing.assert_allclose(
        got[2].numpy(), np.broadcast_to(v[1, 2].mean(1, keepdims=True),
                                        (2, S, D)), **tol)


@pytest.mark.parametrize("S", [1, 2])
def test_warp_route_model_on_the_token_decoders_mask(S):
    """The local cache as the token decoder masks it: 1-D q_idx, no
    kv_valid; the prefix step (positions 0-1) and a token step."""
    H, D, cap, _ = _local_cache()
    rng = np.random.default_rng(S)
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, H, cap, D),
                                                 dtype=np.float32))
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((2, H, S, D), dtype=np.float32))
    mask = masks.decode_mask(0 if S == 2 else cap - 2, cap, S, device="cpu")
    torch.testing.assert_close(
        warp_route_model(q, k, v, 1, mask),
        k2.decode_attention_stacked_plain(q, k, v, 1, mask),
        rtol=F32_TOL, atol=F32_TOL)


def test_warp_route_model_rounds_p_like_the_plain_version():
    """In bf16 the model rounds p before P.V, as the plain version rounds
    the normalized p: one bf16 rounding apart."""
    H, D, cap, _ = _local_cache()
    g = torch.Generator().manual_seed(0)
    k, v = (torch.randn((1, 2, H, cap, D), generator=g).bfloat16()
            for _ in range(2))
    q = torch.randn((2, H, 1, D), generator=g).bfloat16()
    mask = masks.decode_mask(cap - 2, cap, 1, device="cpu")
    got = warp_route_model(q, k, v, 0, mask).float()
    want = k2.decode_attention_stacked_plain(q, k, v, 0, mask).float()
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("cap,length,D", [
    (33, 30, 32),        # one tile and one slot: the second split ragged
    (100, 40, 64),       # the frontier at 40: later splits fully masked
    (300, 290, 128),     # several tiles a split
])
def test_split_route_model_matches_plain(cap, length, D, S):
    q, k, v, q_idx, kv_idx, valid = _case(cap, S, D, cap + S)
    valid[:, length + S:] = 0
    q_idx = (length + np.arange(S, dtype=np.int32))[None].repeat(3, 0)
    mask = masks.AttnMask(_t(q_idx), _t(kv_idx), _t(valid))
    p = k2.plan(3, 2, cap, 8)                 # a small card: several splits
    assert p.splits > 1
    got, splits = split_route_model(_t(q), _t(k), _t(v), 1, mask, p)
    want = k2.decode_attention_stacked_plain(_t(q), _t(k), _t(v), 1, mask)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    masked = [m for z, (m, _, _) in enumerate(splits)
              if z * p.slots_per_split >= length + S]
    assert masked or cap != 100
    assert all(bool((m == NEG).all()) for m in masked)   # no allowed slot
