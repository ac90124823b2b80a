"""The streaming (chunked) prefill and the online-softmax attention of the
PyTorch port against the JAX package, on the CPU; and W8A8-mm's ``plan``.

- ``prefill_blocks(fresh_prefill=False)`` on the bf16, INT8 and INT4 global
  caches: ``next_embeds``, the cache's contents and ``length`` and
  ``kv_valid``, for a prompt within one chunk, one of whole chunks and one
  padded to a chunk multiple; and the ``capacity < pad_to`` error. Hidden
  states agree to float32 rounding (1e-4: the two frameworks sum in another
  order); quantized cache values may then differ by one step where a value
  sits on a rounding boundary, which must stay rare.
- ``generate_blocks(fresh_prefill=False)``: greedy tokens equal.
- ``attention_xla_chunked`` against JAX's in float32 (1e-5, as
  ``tests/test_chunked_attention.py``) and bf16 (one bf16 rounding of the
  output, 2^-8 relative, on each side), with an unaligned tail and a query
  row with no allowed key; and its gate, ``chunked_prefill_attention``
  against ``BT_CHUNKED_PREFILL_ATTN`` / ``BT_CHUNKED_ATTN_TILE``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.ops import attention as jax_attn
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import generate as torch_gen
from block_transformer_tpu_torch.kernels import w8a8
from block_transformer_tpu_torch.ops import attention as torch_attn
from block_transformer_tpu_torch.ops import masks as torch_masks


@pytest.fixture(scope="module")
def models():
    """A small config (hidden 128, 2 + 2 layers, vocab 512) with INT8
    weights."""
    cfg = jax_config.make_block_config("t", 128, 2, vocab_size=512)
    tcfg = torch_config.make_block_config("t", 128, 2, vocab_size=512)
    pj = jax.device_get(jax_quant.quantize_block_transformer(
        jax_bt.init_block_transformer_params(jax.random.PRNGKey(7), cfg),
        bits=8))
    return cfg, tcfg, pj, bridge.params_from_numpy(pj, device="cpu")


def _prompts(cfg, N, seed=0):
    rng = np.random.default_rng(seed)
    B, L = 2, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, :2], att[1, :2] = 0, 0              # a left-padded row
    att[0, -1, 2:] = 0                         # a ragged last block
    return ids, att, att.any(-1).astype(np.int32)


def _cache_close(got, want, kind):
    for f in ("k", "v"):
        a, b = got[f], np.asarray(want[f])
        if kind == "bf16":
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=f)
        else:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, f
    for f in ("k_scale", "v_scale"):
        if f in got:
            np.testing.assert_allclose(got[f], np.asarray(want[f]),
                                       rtol=1e-4, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("N,chunk_blocks,capacity", [
    (3, 4, 8),        # S <= chunk: one block-decoder step
    (12, 4, 16),      # three whole chunks
    (10, 4, 12),      # padded to 12, the capacity exactly
])
def test_streaming_prefill_matches_jax(N, chunk_blocks, capacity, kind,
                                       models):
    cfg, tcfg, pj, pt = models
    ids, att, bam = _prompts(cfg, N)
    ej, cj, vj = jax_gen.prefill_blocks(
        pj, cfg, jnp.asarray(ids), jnp.asarray(att), jnp.asarray(bam),
        capacity=capacity, kv_cache=kind, prefill_chunk_blocks=chunk_blocks,
        fresh_prefill=False)
    et, ct, vt = torch_gen.prefill_blocks(
        pt, tcfg, *(torch.from_numpy(a) for a in (ids, att, bam)),
        capacity=capacity, kv_cache=kind, prefill_chunk_blocks=chunk_blocks,
        fresh_prefill=False)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    S = N * cfg.n_embedding_tokens
    assert ct.length == int(cj.length) == S
    assert not vt[:, S:].any()
    want = {f: getattr(cj, f) for f in cj._fields if f != "length"}
    if kind == "int4":
        want = {f: np.asarray(jnp.asarray(v).astype(jnp.int8))
                if f in ("k", "v") else v for f, v in want.items()}
    _cache_close(bridge.cache_to_numpy(ct), want, kind)


def test_streaming_prefill_refuses_a_short_cache(models):
    """A prompt of 10 blocks in chunks of 4 pads to 12 > capacity 11: both
    raise."""
    cfg, tcfg, pj, pt = models
    ids, att, bam = _prompts(cfg, 10)
    kw = dict(capacity=11, kv_cache="int8", prefill_chunk_blocks=4,
              fresh_prefill=False)
    with pytest.raises(ValueError, match="padded prefill 12"):
        jax_gen.prefill_blocks(pj, cfg, jnp.asarray(ids), jnp.asarray(att),
                               jnp.asarray(bam), **kw)
    with pytest.raises(ValueError, match="padded prefill 12"):
        torch_gen.prefill_blocks(
            pt, tcfg, *(torch.from_numpy(a) for a in (ids, att, bam)), **kw)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_generate_blocks_streaming_greedy_tokens_equal(kind, models):
    """10 prompt blocks in chunks of 4 (padded to 12), 6 more generated."""
    cfg, tcfg, pj, pt = models
    ids, att, bam = _prompts(cfg, 10, seed=1)
    kw = dict(max_blocks=16, kv_cache=kind, prefill_chunk_blocks=4,
              fresh_prefill=False)
    rj = jax_gen.generate_blocks(pj, cfg, jnp.asarray(ids), jnp.asarray(att),
                                 jnp.asarray(bam), **kw)
    rt = torch_gen.generate_blocks(pt, tcfg, ids, att, bam, device="cpu",
                                   **kw)
    assert rt.n_blocks == int(rj.n_blocks) == 16
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    np.testing.assert_array_equal(rt.unfinished.numpy(),
                                  np.asarray(rj.unfinished))


# ---------------------------------------------------------------------------
# attention_xla_chunked
# ---------------------------------------------------------------------------

def _attn_case(B=2, H=3, Q=96, K=700, D=64, seed=0, empty_row=False):
    """As tests/test_chunked_attention.py; ``empty_row``: query 5 of batch
    row 1 sees no key (its q_idx is below every valid key)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Q, D)).astype(np.float32)
    k = rng.standard_normal((B, H, K, D)).astype(np.float32)
    v = rng.standard_normal((B, H, K, D)).astype(np.float32)
    q_idx = rng.integers(0, K, size=(B, Q)).astype(np.int32)
    kv_valid = rng.integers(0, 2, size=(B, K)).astype(np.int32)
    kv_valid[:, 0] = 1
    if empty_row:
        kv_valid[1, :10] = 0
        q_idx[1, 5] = 3
    return q, k, v, q_idx, np.arange(K, dtype=np.int32), kv_valid


def _both(case, dtype):
    q, k, v, q_idx, kv_idx, kv_valid = case
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = [jnp.asarray(a, jd) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    mj = jax_masks.AttnMask(jnp.asarray(q_idx), jnp.asarray(kv_idx),
                            jnp.asarray(kv_valid))
    mt = torch_masks.AttnMask(*(torch.from_numpy(a)
                                for a in (q_idx, kv_idx, kv_valid)))
    return jx, mj, tx, mt


def _f32(a):
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,tile,empty_row", [
    (700, 128, False), (512, 256, False), (300, 128, True), (64, 256, True)])
def test_chunked_attention_matches_jax(K, tile, empty_row, dtype):
    jx, mj, tx, mt = _both(_attn_case(K=K, seed=K, empty_row=empty_row),
                           dtype)
    want = _f32(jax_attn.attention_xla_chunked(*jx, mj, tile=tile))
    got = torch_attn.attention_xla_chunked(*tx, mt, tile=tile)
    assert got.dtype == dtype and got.shape == tx[0].shape
    if dtype == torch.float32:
        np.testing.assert_allclose(_f32(got), want, atol=1e-5, rtol=1e-5)
        if not empty_row:   # reassociated, the direct form's numbers
            np.testing.assert_allclose(
                _f32(got), _f32(torch_attn.attention_xla(*tx, mt)),
                atol=1e-5, rtol=1e-5)
    else:
        err = np.abs(_f32(got) - want).max()
        assert err <= 2 ** -7 * np.abs(want).max(), err


@pytest.mark.parametrize("Q,K,tile", [(64, 512, 256), (63, 512, 256),
                                      (64, 511, 256), (128, 300, 128),
                                      (8, 4096, 256)])
def test_chunked_gate_matches_jax(Q, K, tile, monkeypatch):
    monkeypatch.setenv("BT_CHUNKED_ATTN_TILE", str(tile))
    for on in (False, True):
        monkeypatch.setenv("BT_CHUNKED_PREFILL_ATTN", "1" if on else "0")
        want = jax_attn._use_chunked(Q, K)
        if on:
            with torch_attn.chunked_prefill_attention(tile):
                assert torch_attn._use_chunked(Q, K) == want
        else:
            assert not torch_attn._use_chunked(Q, K) and not want


def test_chunked_dispatch(monkeypatch):
    """Inside the context, a head dim K3 does not take (D = 160) goes
    through the chunked form, as JAX's ``attention`` sends it with the env
    switch on; a head dim K3 takes (D = 64) stays on K3."""
    jx, mj, tx, mt = _both(_attn_case(Q=64, K=600, D=160, seed=3),
                           torch.float32)
    monkeypatch.setenv("BT_CHUNKED_PREFILL_ATTN", "1")
    monkeypatch.setenv("BT_CHUNKED_ATTN_TILE", "128")
    want = _f32(jax_attn.attention(*jx, mj))
    calls = []
    chunked = torch_attn.attention_xla_chunked
    monkeypatch.setattr(torch_attn, "attention_xla_chunked",
                        lambda *a, **k: calls.append(k) or chunked(*a, **k))
    with torch_attn.chunked_prefill_attention(128):
        got = torch_attn.attention(*tx, mt)
        np.testing.assert_allclose(_f32(got), want, atol=1e-5, rtol=1e-5)
        assert calls == [{"tile": 128}]
        _, _, tx64, mt64 = _both(_attn_case(Q=64, K=600, D=64, seed=4),
                                 torch.float32)
        torch_attn.attention(*tx64, mt64)
        assert len(calls) == 1
    torch_attn.attention(*tx, mt)               # off again outside
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# W8A8-mm's plan
# ---------------------------------------------------------------------------

MAIN_PATH_W8A8 = [(4096, 2048, 6144), (4096, 2048, 2048), (4096, 2048, 8192),
                  (4096, 8192, 2048), (16384, 1024, 3072)]


@pytest.mark.parametrize("M,K,N", [
    *MAIN_PATH_W8A8,                            # the prefill shapes
    (1024, 2048, 6144), (1024, 8192, 2048),     # streaming chunks
    (384, 2048, 2048), (384, 8192, 2048), (2048, 2048, 2048),
    (1, 2048, 384), (17, 4096, 16), (130, 80, 48)])
@pytest.mark.parametrize("sms", [132, 114])
def test_w8a8_plan(M, K, N, sms):
    """W8A8-mm's one route at every shape; its K steps cover K exactly, in
    whole 128-byte stages; the persistent grid fills the card at the
    prefill's M = 4096 (and M = 16384) with no split; a split only where
    the tiles alone leave SMs idle, and never past one unit an SM; and
    ``plan`` is pure."""
    p = w8a8.plan(M, K, N, sms)
    tiles = -(-M // 128) * -(-N // 256)
    assert p.route == "wgmma" and p.tile == (128, 256, 128)
    assert p.k_per_split % 128 == 0 and p.k_per_split > 0
    spans = [min(K - z * p.k_per_split, p.k_per_split)
             for z in range(p.splits)]
    assert all(s > 0 for s in spans) and sum(spans) == K
    assert p.blocks == min(tiles * p.splits, sms)
    assert tiles * p.splits <= max(tiles, sms)
    if tiles >= sms:
        assert p.splits == 1 and p.blocks == sms
    if (M, K, N) in MAIN_PATH_W8A8:
        assert p.splits == 1 and p.blocks == sms   # fills the card
    if (M, K, N) == (384, 8192, 2048):
        assert p.splits == sms // tiles             # 24 tiles: split K
    assert w8a8.plan.__wrapped__(M, K, N, sms) == p == w8a8.plan(M, K, N, sms)


def test_w8a8_wrappers_take_cpu_tensors_as_plain():
    """On the CPU the wrappers run the plain versions and count nothing."""
    x = torch.randn(5, 32)
    before = (w8a8.w8a8_quant.launches, w8a8.w8a8_matmul_stacked.launches)
    routes = dict(w8a8.w8a8_matmul_stacked.route_launches)
    xq, sx = w8a8.w8a8_quant(x)
    w = torch.randint(-127, 128, (2, 32, 16), dtype=torch.int8)
    s = torch.rand(2, 16)
    out = w8a8.w8a8_matmul_stacked(xq, sx, w, s, 1, torch.float32)
    assert torch.equal(out, w8a8.w8a8_matmul_plain(xq, sx, w[1], s[1],
                                                   torch.float32))
    assert (w8a8.w8a8_quant.launches,
            w8a8.w8a8_matmul_stacked.launches) == before
    assert w8a8.w8a8_matmul_stacked.route_launches == routes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 300])
def test_w8a8_route_launches_still_on_cpu(M, dtype, monkeypatch):
    """A stacked INT8 linear taking W8A8 (the card gate opened, W8A8 at
    every M) on CPU tensors runs the plain versions: W8A8-mm's launches and
    its launches by route do not move."""
    from block_transformer_tpu_torch.ops import linear as torch_linear
    from block_transformer_tpu_torch.ops import quant as torch_quant
    g = torch.Generator().manual_seed(M)
    w_q, scale = torch_quant.quantize_int8(torch.randn((2, 64, 48),
                                                       generator=g))
    x = torch.randn((M, 64), generator=g).to(dtype)
    node = {"kernel_q8": w_q, "scale": scale}
    before = (w8a8.w8a8_matmul_stacked.launches,
              dict(w8a8.w8a8_matmul_stacked.route_launches))
    monkeypatch.setattr(torch_linear, "_on_card", lambda t: True)
    with torch_linear.w8a8_min_m(1):
        out = torch_linear.apply_linear(x, torch_linear.StackedLinear(node, 1))
    xq, sx = w8a8.w8a8_quant_plain(x)
    assert torch.equal(out, w8a8.w8a8_matmul_plain(xq, sx, w_q[1], scale[1],
                                                   dtype))
    assert (w8a8.w8a8_matmul_stacked.launches,
            w8a8.w8a8_matmul_stacked.route_launches) == before
