"""The port's serving engine against the JAX engine, on the CPU.

Both engines get the same parameters (the JAX tree bridged to tensors), the
small float32 configuration of ``tests/test_engine.py`` and the same
requests: more requests than slots, uneven prompts and budgets, one
request whose prompt plus budget fills ``max_blocks`` exactly (its slot
ends at ``write_pos == cap``) and one too long to admit. Greedy tokens must
be equal per request, and so must the scheduling counters: the port keeps
the JAX engine's order of admission, dispatch and consumption. The JAX runs
are shared through module-scoped fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_block_parity import VOCAB, make_cfg
from block_transformer_tpu.inference.engine import (
    ContinuousBatchingEngine as JaxEngine)
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import engine as torch_engine
from block_transformer_tpu_torch.models import neox as torch_neox
from block_transformer_tpu_torch.ops import masks as torch_masks

MAX_BLOCKS = 12
PROMPTS = (8, 12, 4, 9, 6, 8, 48)
BUDGETS = (6, 9, 5, 14, 3, 40, 4)        # 8 tokens + 40 = 12 blocks; 48 + 4
KINDS = {                                # is too long for 12 blocks
    "bf16": {},
    "int8": {},
    # 4 usable pages of 4 positions: the requests need 1-3 pages each and
    # cannot all hold pages at once
    "paged": dict(page_size=4, pool_pages=5),
}


@pytest.fixture(scope="module")
def models():
    cfg = make_cfg()
    tcfg = torch_config.BlockTransformerConfig.from_dict(
        dataclasses.asdict(cfg))
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(0), cfg))
    return cfg, tcfg, pj, bridge.params_from_numpy(pj, device="cpu")


def _serve(engine, prompts_seed=0):
    rng = np.random.default_rng(prompts_seed)
    for n, m in zip(PROMPTS, BUDGETS):
        engine.submit(rng.integers(1, VOCAB, size=n), m)
    reqs = list(engine.waiting)
    engine.run(max_steps=200)
    assert not engine.has_work()
    return reqs


@pytest.fixture(scope="module", params=sorted(KINDS))
def served(request, models):
    cfg, tcfg, pj, pt = models
    kind = request.param
    kw = dict(n_slots=3, max_blocks=MAX_BLOCKS, kv_cache=kind, sync_blocks=3,
              bucket_blocks=2, **KINDS[kind])
    jax_eng = JaxEngine(pj, cfg, **kw)
    port_eng = torch_engine.ContinuousBatchingEngine(pt, tcfg, device="cpu",
                                                     **kw)
    return kind, (jax_eng, _serve(jax_eng)), (port_eng, _serve(port_eng))


def test_engine_greedy_tokens_equal(served):
    _, (_, want), (_, got) = served
    assert [r.generated for r in got] == [r.generated for r in want]
    assert [r.error for r in got] == [r.error for r in want]
    assert got[-1].error and all(r.generated for r in got[:-1])
    assert len(got[5].generated) == BUDGETS[5]      # ran to write_pos == cap


def test_engine_stats_equal(served):
    _, (jax_eng, _), (port_eng, _) = served
    assert dataclasses.asdict(port_eng.stats) == dataclasses.asdict(
        jax_eng.stats)
    assert port_eng.stats.prompts_admitted == len(PROMPTS) - 1
    m = port_eng.latency_metrics()
    assert m["completed"] == len(PROMPTS) - 1
    assert 0 <= m["queue_wait_s_mean"] <= m["ttft_s_mean"]


@pytest.mark.parametrize("served", ["paged"], indirect=True)
def test_engine_paged_pages_freed(served):
    """Finished slots point at the null page and every page is free
    again."""
    _, _, (eng, _) = served
    assert (eng.cache.page_table == 0).all()
    assert sorted(eng._free_pages) == list(range(1, eng.pool_pages))
    assert eng.pool_pages == 5 and eng.n_virt == 3


def test_engine_refuses_what_it_does_not_serve(models):
    """Mesh serving and overlapped streams are refused; the INT4 caches are
    served (their own tests compare them with JAX)."""
    _, tcfg, _, pt = models
    make = torch_engine.ContinuousBatchingEngine
    for kw in (dict(mesh=object()), dict(overlap_streams=2)):
        with pytest.raises(NotImplementedError):
            make(pt, tcfg, device="cpu", **kw)
    for kind in ("int4", "paged-int4"):
        eng = make(pt, tcfg, device="cpu", kv_cache=kind, page_size=4)
        assert eng.cache.k.dtype == torch.uint8
    with pytest.raises(ValueError, match="kv_cache"):
        make(pt, tcfg, device="cpu", kv_cache="fp8")
    with pytest.raises(ValueError, match="params must be on"):
        make(pt, tcfg, device="cuda")       # params on the CPU: no move


# ---------------------------------------------------------------------------
# neox_stack with a per-row write_pos
# ---------------------------------------------------------------------------

def _stack_pair():
    cfg = make_cfg().block_decoder
    tcfg = torch_config.NeoXConfig(**dataclasses.asdict(cfg))
    pj = jax.device_get(jax_neox.init_neox_params(jax.random.PRNGKey(1), cfg,
                                                  with_embed_in=False,
                                                  with_lm_head=False))
    return cfg, tcfg, pj, bridge.params_from_numpy(pj, device="cpu")


def _cache_pair(kind, cfg, tcfg, B, cap, rng):
    """The same prefilled cache on both sides (random K/V values)."""
    if kind == "bf16":
        cj = jax_neox.KVCache.create(cfg, B, cap, dtype=jnp.float32)
        cj = cj._replace(k=jnp.asarray(rng.standard_normal(cj.k.shape),
                                       jnp.float32),
                         v=jnp.asarray(rng.standard_normal(cj.v.shape),
                                       jnp.float32))
    else:
        cj = jax_neox.QuantKVCache.create(cfg, B, cap)
        shape = cj.k.shape
        cj = cj._replace(
            k=jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
            v=jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
            k_scale=jnp.asarray(rng.uniform(0.01, 0.03, shape[:-1]),
                                jnp.float32),
            v_scale=jnp.asarray(rng.uniform(0.01, 0.03, shape[:-1]),
                                jnp.float32))
    if kind == "paged":
        ps, n_virt = 4, cap // 4
        L, _, H, _, D = cj.k.shape
        P = B * n_virt + 1
        perm = 1 + rng.permutation(B * n_virt).reshape(B, n_virt)

        def to_pool(a):                          # [L, B, H, cap(, D)]
            pages = np.asarray(a).reshape(L, B, H, n_virt, ps, *a.shape[4:])
            pages = np.moveaxis(pages, 3, 2)     # [L, B, n_virt, H, ps(, D)]
            pool = np.zeros((L, P) + pages.shape[3:], pages.dtype)
            pool[:, perm] = pages
            return jnp.asarray(pool)

        cj = jax_neox.PagedKVCache(to_pool(cj.k), to_pool(cj.v),
                                   to_pool(cj.k_scale), to_pool(cj.v_scale),
                                   jnp.asarray(perm, jnp.int32),
                                   jnp.int32(0))
    return cj, bridge.cache_from_numpy(jax.device_get(cj), device="cpu")


@pytest.mark.parametrize("kind,S", [("bf16", 1), ("bf16", 2), ("int8", 1),
                                    ("int8", 2), ("paged", 1), ("paged", 2)])
def test_neox_stack_per_row_write_pos(kind, S):
    """Rows at their own frontiers: hidden states within 1e-4 and the
    written caches equal (int8 values within one step where a float32
    difference falls on a rounding boundary)."""
    cfg, tcfg, pj, pt = _stack_pair()
    rng = np.random.default_rng(2)
    B, cap = 3, 16
    cj, ct = _cache_pair(kind, cfg, tcfg, B, cap, rng)
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
        mask=torch_masks.AttnMask(torch.from_numpy(q_idx),
                                  torch.from_numpy(kv_idx),
                                  torch.from_numpy(valid)),
        positions=torch.from_numpy(q_idx), cache=ct,
        write_pos=torch.from_numpy(wp))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-4,
                               rtol=1e-4)
    got = bridge.cache_to_numpy(ct2)
    assert int(got["length"]) == int(cj2.length)
    for f in cj2._fields:
        if f == "length":
            continue
        a, b = got[f], np.asarray(getattr(cj2, f))
        if a.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, f
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_per_row_write_drops_out_of_range(kind):
    """A row at write_pos == cap (a finished slot) leaves its cache row as
    it was; a row straddling the end writes its in-range positions only."""
    cfg, tcfg, _, pt = _stack_pair()
    rng = np.random.default_rng(3)
    B, cap, S = 2, 8, 2
    _, ct = _cache_pair(kind, cfg, tcfg, B, cap, rng)
    before = {f: getattr(ct, f).clone() for f in ct._fields if f != "length"}
    x = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.hidden_size)).astype(np.float32))
    wp = torch.tensor([cap, cap - 1], dtype=torch.int32)
    pos = (wp[:, None] + torch.arange(S)).clamp(max=cap - 1)
    mask = torch_masks.AttnMask(pos, torch.arange(cap, dtype=torch.int32),
                                torch.ones((B, cap), dtype=torch.int32))
    _, ct2 = torch_neox.neox_stack(pt, x, cfg=tcfg, mask=mask, positions=pos,
                                   cache=ct, write_pos=wp)
    for f, old in before.items():
        new = getattr(ct2, f)
        assert torch.equal(new[:, 0], old[:, 0]), f
        assert torch.equal(new[:, 1, :, :cap - 1], old[:, 1, :, :cap - 1]), f
        assert not torch.equal(new[:, 1, :, cap - 1], old[:, 1, :, cap - 1])
