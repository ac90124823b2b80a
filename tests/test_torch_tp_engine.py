"""The port's serving engine over a (data 2, model 2) mesh against the JAX
engine over the same mesh shape, on the CPU.

Four gloo ranks (``tests/torch_mesh_ranks.py``, no JAX imported there) each
run the engine on the same requests (SPMD), holding their data shard's
slots and their heads: ``mesh_impl="shard_map"`` over the contiguous INT8
cache and the paged INT8 and INT4 pools, and ``"gspmd"`` over INT8 (served
by the same per-rank programs in the port). The requests and the small
float32 configuration are those of ``tests/test_torch_engine.py`` (more
requests than slots, one that fills ``max_blocks`` exactly, one too long).
Greedy tokens and the scheduling counters must equal the JAX engine's over
4 of the test process's CPU devices and the port's single-device engine's;
a paged pool must end with every page of every shard free.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests import torch_mesh_ranks as ranks
from tests.test_block_parity import VOCAB, make_cfg
from block_transformer_tpu.inference.engine import (
    ContinuousBatchingEngine as JaxEngine)
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.parallel import sharding as jax_sh
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import engine as torch_engine

MAX_BLOCKS = 12
PROMPTS = (8, 12, 4, 9, 6, 8, 48)
BUDGETS = (6, 9, 5, 14, 3, 40, 4)
KW = {kind: dict(n_slots=4, max_blocks=MAX_BLOCKS, sync_blocks=3,
                 bucket_blocks=2, **extra)
      for kind, extra in (("int8", {}),
                          ("paged", dict(page_size=4, pool_pages=9)),
                          ("paged-int4", dict(page_size=4, pool_pages=9)))}
# (mesh, kv_cache, mesh_impl)
CASES = [("2x2", "int8", "shard_map"), ("2x2", "paged", "shard_map"),
         ("2x2", "paged-int4", "shard_map"), ("2x2", "int8", "gspmd")]


def _ids(case):
    return "-".join(case)


@pytest.fixture(scope="module")
def models():
    cfg = make_cfg()
    tcfg = torch_config.BlockTransformerConfig.from_dict(
        dataclasses.asdict(cfg))
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, VOCAB, size=n).astype(np.int32)
               for n in PROMPTS]
    return cfg, tcfg, pj, bridge.params_from_numpy(pj, device="cpu"), prompts


@pytest.fixture(scope="module")
def ranked(models, tmp_path_factory):
    _, tcfg, _, pt, prompts = models
    tmp = tmp_path_factory.mktemp("tp_engine")
    torch.save({"fp32": pt}, tmp / "params.pt")
    return ranks.spawn("engine", tmp, params_file=str(tmp / "params.pt"),
                       cfg=tcfg, cases=CASES, prompts=prompts,
                       budgets=BUDGETS, kw=KW)


def _serve(engine, prompts):
    for p, m in zip(prompts, BUDGETS):
        engine.submit(p, m)
    reqs = list(engine.waiting)
    engine.run(max_steps=200)
    assert not engine.has_work()
    return reqs


@pytest.fixture(scope="module")
def jax_served(models):
    """The JAX engine over the same mesh shape, per case."""
    cfg, _, pj, _, prompts = models
    out = {}
    for mesh_name, kind, impl in CASES:
        mesh = jax_sh.make_mesh(devices=jax.devices()[:ranks.WORLD],
                                **ranks.MESHES[mesh_name])
        eng = JaxEngine(pj, cfg, kv_cache=kind, mesh=mesh, mesh_impl=impl,
                        **KW[kind])
        reqs = _serve(eng, prompts)
        out[(mesh_name, kind, impl)] = (
            [r.generated for r in reqs], [r.error for r in reqs],
            dataclasses.asdict(eng.stats))
    return out


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_engine_tokens_and_stats_equal_jax(ranked, jax_served, case):
    want_tokens, want_errors, want_stats = jax_served[case]
    for res in ranked:                    # every rank sees every request
        got = res[case]
        assert got["generated"] == want_tokens
        assert got["errors"] == want_errors
        assert got["stats"] == want_stats
        assert not got["has_work"]
    assert want_errors[-1] and all(want_tokens[:-1])
    assert len(want_tokens[5]) == BUDGETS[5]     # ran to write_pos == cap


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_engine_equals_single_device(models, ranked, case):
    _, tcfg, _, pt, prompts = models
    _, kind, _ = case
    eng = torch_engine.ContinuousBatchingEngine(pt, tcfg, device="cpu",
                                                kv_cache=kind, **KW[kind])
    reqs = _serve(eng, prompts)
    got = ranked[0][case]
    assert got["generated"] == [r.generated for r in reqs]
    assert got["stats"] == dataclasses.asdict(eng.stats)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] != "int8"],
                         ids=_ids)
def test_tp_engine_pages_freed_per_shard(ranked, case):
    """Each data shard's sub-pool (pool_pages / dp pages, page 0 its null
    page) ends with every page free, and every slot at the null page."""
    for res in ranked:
        got = res[case]
        per = got["pages_per_shard"]
        assert per == 5
        assert got["free_pages"] == [list(range(1, per))] * 2
        assert got["table_clear"]


def test_gspmd_paged_refused_as_in_jax(models):
    """A paged pool needs mesh_impl="shard_map", in JAX and in the port."""
    cfg, tcfg, pj, pt, _ = models
    mesh = jax_sh.make_mesh(devices=jax.devices()[:1])
    with pytest.raises(AssertionError, match="shard_map"):
        JaxEngine(pj, cfg, kv_cache="paged", mesh=mesh, mesh_impl="gspmd",
                  **KW["paged"])
    with pytest.raises(ValueError, match="shard_map"):
        torch_engine.ContinuousBatchingEngine(
            pt, tcfg, device="cpu", kv_cache="paged", mesh=object(),
            mesh_impl="gspmd", **KW["paged"])


def test_ranks_import_no_jax(ranked):
    assert not any(res["jax_imported"] for res in ranked)
