"""The port's INT4 KV caches, contiguous and paged, against the JAX package,
on the CPU.

JAX keeps INT4 cache values one to an element (``jnp.int4``); the port packs
two to a byte along D, split half (``ops.quant.pack_kv_int4``), and
``bridge`` converts both ways. Held here, on numpy inputs from a seed, in
float32:

- ``quantize_kv(x, bits=4)`` against JAX ``quantize_kv(x, jnp.int4)``, bit
  for bit, with halves that round to even;
- the packed layout and its round trip, and the bridge both ways;
- K6's plain version on a packed pool against the Pallas kernel on a
  ``jnp.int4`` pool in interpret mode, within 1e-5 of the output's scale
  (both sides compute the same float32 products, summed in another order);
- ``neox_stack`` on both INT4 caches at S = 1 and S > 1, hidden states
  within 1e-4 and the written values within one quantization step where a
  float32 difference falls on a rounding boundary;
- ``generate_blocks(kv_cache="int4")`` and the serving engine's ``int4``
  and ``paged-int4`` caches: greedy tokens and ``stats`` equal to JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_block_parity import make_cfg
from tests.test_torch_engine import BUDGETS, MAX_BLOCKS, PROMPTS, _serve
from tests.test_torch_engine import _stack_pair
from block_transformer_tpu import config as jax_config
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.inference.engine import (
    ContinuousBatchingEngine as JaxEngine)
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu.ops import paged_attention as jax_pa
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import engine as torch_engine
from block_transformer_tpu_torch.inference import generate as torch_gen
from block_transformer_tpu_torch.kernels import paged_attention as kp
from block_transformer_tpu_torch.models import neox as torch_neox
from block_transformer_tpu_torch.ops import masks as torch_masks
from block_transformer_tpu_torch.ops import quant


def _t(a):
    return torch.from_numpy(np.array(a))


def _int4(rng, shape):
    return rng.integers(-7, 8, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# Quantization and packing
# ---------------------------------------------------------------------------

def test_quantize_kv_int4_bit_exact():
    """Random rows, a row of zeros (scale 1e-8 / 7) and a row whose values
    divided by the scale land on halves, which round to even."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 64)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[1, 2, 4] = 0.25 * np.resize([7.0, 3.5, -3.5, 0.5, -0.5, 2.5, -1.5],
                                  64)
    q, s = quant.quantize_kv(torch.from_numpy(x), bits=4)
    qj, sj = jax_neox.quantize_kv(jnp.asarray(x), jnp.int4)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 7
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj).astype(np.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert q[1, 2, 4, :7].tolist() == [7, 4, -4, 0, 0, 2, -2]
    with pytest.raises(ValueError, match="bits"):
        quant.quantize_kv(torch.from_numpy(x), bits=2)


def test_pack_kv_int4_layout_and_round_trip():
    """Byte i holds d = i in its low nibble and d = i + D/2 in its high one;
    -8, -7, -1 and 7 come back as they went in."""
    rng = np.random.default_rng(1)
    D = 32
    v = rng.integers(-8, 8, (3, 2, 5, D)).astype(np.int8)
    v[0, 0, 0, :8] = [-7, -1, 7, -8, 0, 1, -2, 6]
    v[0, 0, 0, D // 2:D // 2 + 4] = [7, -7, -1, -8]
    packed = quant.pack_kv_int4(torch.from_numpy(v))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 2, 5, D // 2)
    u = v.astype(np.int32)
    want = (u[..., :D // 2] & 0xF) | ((u[..., D // 2:] & 0xF) << 4)
    np.testing.assert_array_equal(packed.numpy(), want.astype(np.uint8))
    assert packed[0, 0, 0, :4].tolist() == [0x79, 0x9F, 0xF7, 0x88]
    np.testing.assert_array_equal(quant.unpack_kv_int4(packed).numpy(), v)
    scale = torch.full((3, 2, 5), 0.5)
    np.testing.assert_array_equal(
        quant.dequantize_kv(packed, scale, torch.float32).numpy(), v * 0.5)
    with pytest.raises(ValueError, match="even"):
        quant.pack_kv_int4(torch.zeros((2, 3), dtype=torch.int8))


def _jax_int4_cache(kind, rng, cfg, B, cap, ps=4):
    """A JAX INT4 cache or pool with random values and scales."""
    if kind == "int4":
        c = jax_neox.QuantKVCache.create(cfg, B, cap, bits=4)
    else:
        c = jax_neox.PagedKVCache.create(cfg, B, cap, n_pages=B * cap // ps + 1,
                                         page_size=ps, bits=4)
        perm = 1 + rng.permutation(B * cap // ps).reshape(B, cap // ps)
        c = c._replace(page_table=jnp.asarray(perm, jnp.int32))
    shape = c.k.shape
    return c._replace(
        k=jnp.asarray(_int4(rng, shape)).astype(jnp.int4),
        v=jnp.asarray(_int4(rng, shape)).astype(jnp.int4),
        k_scale=jnp.asarray(rng.uniform(0.01, 0.03, shape[:-1]), jnp.float32),
        v_scale=jnp.asarray(rng.uniform(0.01, 0.03, shape[:-1]), jnp.float32))


@pytest.mark.parametrize("kind", ["int4", "paged-int4"])
def test_bridge_int4_caches_both_ways(kind):
    cfg = make_cfg().block_decoder
    rng = np.random.default_rng(2)
    cj = jax.device_get(_jax_int4_cache(kind, rng, cfg, 2, 8))
    ct = bridge.cache_from_numpy(cj, device="cpu")
    want_type = (torch_neox.QuantKVCache if kind == "int4"
                 else torch_neox.PagedKVCache)
    assert isinstance(ct, want_type) and ct.bits == 4
    assert ct.k.dtype == torch.uint8
    assert tuple(ct.k.shape) == cj.k.shape[:-1] + (cj.k.shape[-1] // 2,)
    np.testing.assert_array_equal(quant.unpack_kv_int4(ct.v).numpy(),
                                  np.asarray(cj.v).astype(np.int8))
    back = bridge.cache_to_numpy(ct)
    for f in cj._fields:
        a, b = np.asarray(back[f]), np.asarray(getattr(cj, f))
        if f in ("k", "v"):
            assert a.dtype == np.int8
            a = np.asarray(jnp.asarray(a).astype(jnp.int4))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32), err_msg=f)


def test_make_kv_cache_int4():
    cfg = torch_config.NeoXConfig(**dataclasses.asdict(make_cfg().block_decoder))
    c = torch_neox.make_kv_cache(cfg, 2, 8, "int4", device="cpu")
    assert isinstance(c, torch_neox.QuantKVCache) and c.bits == 4
    assert tuple(c.k.shape) == (cfg.num_layers, 2, cfg.num_heads, 8,
                                cfg.head_dim // 2)
    assert tuple(c.k_scale.shape) == (cfg.num_layers, 2, cfg.num_heads, 8)
    p = torch_neox.PagedKVCache.create(cfg, 2, 8, n_pages=5, page_size=4,
                                       bits=4, device="cpu")
    assert p.k.dtype == torch.uint8 and p.bits == 4 and p.page_size == 4
    with pytest.raises(ValueError, match="kind"):
        torch_neox.make_kv_cache(cfg, 2, 8, "int2", device="cpu")


# ---------------------------------------------------------------------------
# K6 on a packed pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,S,null_tail,all_masked", [
    (32, 1, False, False),
    (32, 8, True, False),             # eight query rows, row 0 on page 0
    (64, 3, True, True),              # a row with no allowed key
    (64, 1, False, True),
])
def test_k6_int4_plain_matches_pallas(D, S, null_tail, all_masked):
    rng = np.random.default_rng(3)
    L, B, H, ps, n_virt = 2, 3, 2, 4, 3
    cap = ps * n_virt
    P = B * n_virt + 2
    pools = [_int4(rng, (L, P, H, ps, D)),
             rng.uniform(0.01, 0.02, (L, P, H, ps)).astype(np.float32),
             _int4(rng, (L, P, H, ps, D)),
             rng.uniform(0.01, 0.02, (L, P, H, ps)).astype(np.float32)]
    pt = rng.permutation(np.arange(1, P))[:B * n_virt].reshape(
        B, n_virt).astype(np.int32)
    lengths = rng.integers(S, cap + 1, B)
    if null_tail:                     # row 0's tail pages on the null page
        pt[0, 1:] = 0
        lengths[0] = ps
    kv_valid = (np.arange(cap)[None] < lengths[:, None]).astype(np.int32)
    kv_valid[-1, :1] = 0              # a left-padded row
    if all_masked:
        kv_valid[1] = 0
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    q_idx = (lengths[:, None] - S + np.arange(S)[None]).astype(np.int32)
    kv_idx = np.arange(cap, dtype=np.int32)
    jpools = [jnp.asarray(a) for a in pools]
    jpools[0] = jpools[0].astype(jnp.int4)
    jpools[2] = jpools[2].astype(jnp.int4)
    want = np.asarray(jax_pa.paged_decode_attention_int8(
        jnp.asarray(q), *jpools, 1, jnp.asarray(pt),
        jax_masks.AttnMask(jnp.asarray(q_idx), jnp.asarray(kv_idx),
                           jnp.asarray(kv_valid)), interpret=True))
    tpools = [_t(a) for a in pools]
    tpools[0] = quant.pack_kv_int4(tpools[0])
    tpools[2] = quant.pack_kv_int4(tpools[2])
    got = kp.paged_decode_attention_int8(
        _t(q), *tpools, 1, _t(pt),
        torch_masks.AttnMask(_t(q_idx), _t(kv_idx), _t(kv_valid)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_k8_plain_takes_packed_rows():
    """Admission's page copy on a packed pool is the reference's scatter of
    page-cut rows, byte for byte."""
    rng = np.random.default_rng(4)
    L, P, H, ps, D, G, nv = 2, 8, 2, 4, 32, 2, 3
    pools = [rng.integers(0, 256, (L, P, H, ps, D // 2)).astype(np.uint8),
             rng.normal(size=(L, P, H, ps)).astype(np.float32),
             rng.integers(0, 256, (L, P, H, ps, D // 2)).astype(np.uint8),
             rng.normal(size=(L, P, H, ps)).astype(np.float32)]
    rows = [rng.integers(0, 256, (L, G, H, nv * ps, D // 2)).astype(np.uint8),
            rng.normal(size=(L, G, H, nv * ps)).astype(np.float32),
            rng.integers(0, 256, (L, G, H, nv * ps, D // 2)).astype(np.uint8),
            rng.normal(size=(L, G, H, nv * ps)).astype(np.float32)]
    pt = np.asarray([[3, 1, 6], [2, 7, 0]], np.int32)
    got = kp.paged_page_copy_int8(*map(_t, pools), _t(pt), *map(_t, rows))
    for pool, row, g in zip(pools, rows, got):
        want = pool.copy()
        pages = row.reshape(L, G, H, nv, ps, *row.shape[4:]).swapaxes(2, 3)
        want[:, pt] = pages
        np.testing.assert_array_equal(g.numpy()[:, 1:], want[:, 1:])


# ---------------------------------------------------------------------------
# neox_stack on the INT4 caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,S", [("int4", 1), ("int4", 3),
                                    ("paged-int4", 1), ("paged-int4", 3)])
def test_neox_stack_int4_caches(kind, S):
    """Rows at their own frontiers (one at the last slots), one row with
    left padding."""
    cfg, tcfg, pj, pt = _stack_pair()
    rng = np.random.default_rng(5)
    B, cap = 3, 16
    cj = _jax_int4_cache(kind, rng, cfg, B, cap)
    ct = bridge.cache_from_numpy(jax.device_get(cj), device="cpu")
    wp = np.asarray([5, 0, cap - S], np.int32)
    x = rng.standard_normal((B, S, cfg.hidden_size)).astype(np.float32)
    valid = (np.arange(cap)[None] < (wp + S)[:, None]).astype(np.int32)
    valid[0, :2] = 0
    q_idx = (wp[:, None] + np.arange(S)[None]).astype(np.int32)
    kv_idx = np.arange(cap, dtype=np.int32)
    hj, cj2 = jax_neox.neox_stack(
        pj, jnp.asarray(x), cfg=cfg,
        mask=jax_masks.AttnMask(jnp.asarray(q_idx), jnp.asarray(kv_idx),
                                jnp.asarray(valid)),
        positions=jnp.asarray(q_idx), cache=cj, write_pos=jnp.asarray(wp))
    ht, ct2 = torch_neox.neox_stack(
        pt, torch.from_numpy(x), cfg=tcfg,
        mask=torch_masks.AttnMask(_t(q_idx), _t(kv_idx), _t(valid)),
        positions=_t(q_idx), cache=ct, write_pos=_t(wp))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4,
                               rtol=1e-4)
    assert ct2.k.dtype == torch.uint8
    got = bridge.cache_to_numpy(ct2)
    for f in ("k", "v"):
        a = got[f].astype(np.int32)
        b = np.asarray(getattr(cj2, f)).astype(np.int32)
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, f
    for f in ("k_scale", "v_scale"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(cj2, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


# ---------------------------------------------------------------------------
# Generation and serving
# ---------------------------------------------------------------------------

def test_generate_blocks_int4_kv_greedy_tokens_equal():
    """Float weights, INT4 global KV cache, B=2 with one left-padded row,
    3 prompt blocks, max_blocks 7: the fresh prefill, then decode."""
    cfg = jax_config.make_block_config("t", 128, 2, vocab_size=512)
    tcfg = torch_config.make_block_config("t", 128, 2, vocab_size=512)
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(2), cfg))
    pt = bridge.params_from_numpy(pj, device="cpu")
    rng = np.random.default_rng(6)
    B, N, L = 2, 3, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, 0], att[1, 0] = 0, 0
    bam = att.any(-1).astype(np.int32)
    rj = jax_gen.generate_blocks(pj, cfg, jnp.asarray(ids), jnp.asarray(att),
                                 jnp.asarray(bam), max_blocks=7,
                                 kv_cache="int4")
    rt = torch_gen.generate_blocks(pt, tcfg, ids, att, bam, max_blocks=7,
                                   kv_cache="int4", device="cpu")
    assert rt.n_blocks == int(rj.n_blocks) == 7
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    np.testing.assert_array_equal(rt.unfinished.numpy(),
                                  np.asarray(rj.unfinished))


INT4_KINDS = {
    "int4": {},
    # 4 usable pages of 4 positions, as the INT8 pool's test
    "paged-int4": dict(page_size=4, pool_pages=5),
}


@pytest.fixture(scope="module", params=sorted(INT4_KINDS))
def served4(request):
    cfg = make_cfg()
    tcfg = torch_config.BlockTransformerConfig.from_dict(
        dataclasses.asdict(cfg))
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(0), cfg))
    pt = bridge.params_from_numpy(pj, device="cpu")
    kind = request.param
    kw = dict(n_slots=3, max_blocks=MAX_BLOCKS, kv_cache=kind, sync_blocks=3,
              bucket_blocks=2, **INT4_KINDS[kind])
    jax_eng = JaxEngine(pj, cfg, **kw)
    port_eng = torch_engine.ContinuousBatchingEngine(pt, tcfg, device="cpu",
                                                     **kw)
    return kind, (jax_eng, _serve(jax_eng)), (port_eng, _serve(port_eng))


def test_engine_int4_greedy_tokens_equal(served4):
    _, (_, want), (eng, got) = served4
    assert eng.cache.k.dtype == torch.uint8
    assert [r.generated for r in got] == [r.generated for r in want]
    assert [r.error for r in got] == [r.error for r in want]
    assert got[-1].error and all(r.generated for r in got[:-1])
    assert len(got[5].generated) == BUDGETS[5]      # ran to write_pos == cap


def test_engine_int4_stats_equal(served4):
    kind, (jax_eng, _), (port_eng, _) = served4
    assert dataclasses.asdict(port_eng.stats) == dataclasses.asdict(
        jax_eng.stats)
    assert port_eng.stats.prompts_admitted == len(PROMPTS) - 1
    if kind == "paged-int4":          # every page free again
        assert (port_eng.cache.page_table == 0).all()
        assert sorted(port_eng._free_pages) == list(
            range(1, port_eng.pool_pages))
