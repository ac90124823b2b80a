"""The port's mesh and sharding rules against the JAX package's, on the CPU.

``parallel/sharding.py``'s axis tables and partition specs, and
``parallel/tp_decode.py``'s specs and parameter preparation, must equal
JAX's on the same trees (the small float32 configuration of
``tests/test_block_parity.py``, 4 heads and 2 layers: float, INT8 and
group-wise INT4 weights), bit for bit. Then four gloo ranks
(``tests/torch_mesh_ranks.py``, no JAX imported there) build each mesh and
keep their shards: each rank's mesh coordinate and each shard must equal
JAX's on the device of the same index, under the GSPMD rules
(``shard_params``) and under the tensor-parallel ones.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from tests import torch_mesh_ranks as ranks
from tests.test_block_parity import make_cfg
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu.parallel import sharding as jax_sh
from block_transformer_tpu.parallel import tp_decode as jax_tp
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.parallel import sharding
from block_transformer_tpu_torch.parallel import tp_decode

TREES = ("fp32", "int8", "int4")


@pytest.fixture(scope="module")
def models():
    cfg = make_cfg()
    tcfg = torch_config.BlockTransformerConfig.from_dict(
        dataclasses.asdict(cfg))
    pj = jax_bt.init_block_transformer_params(jax.random.PRNGKey(0), cfg)
    jt = {"fp32": pj,
          "int8": jax_quant.quantize_block_transformer(pj, bits=8),
          "int4": jax_quant.quantize_block_transformer(pj, bits=4,
                                                       group_size=16)}
    jt = {k: jax.device_get(v) for k, v in jt.items()}
    pt = {k: bridge.params_from_numpy(v, device="cpu") for k, v in jt.items()}
    return cfg, tcfg, jt, pt


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _jax_leaves(tree):
    """{path: leaf} of a JAX tree whose leaves may be PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


def _spec(s):
    return tuple(tuple(p) if isinstance(p, (tuple, list)) else p for p in s)


def _assert_specs_equal(got, want):
    got = dict(_leaves(got))
    want = _jax_leaves(want)
    assert set(got) == set(want)
    for path, spec in want.items():
        assert _spec(got[path]) == _spec(spec), path


MESH_CASES = [(1, {}), (2, {}), (4, {}), (8, {}), (8, dict(n_data=4)),
              (8, dict(n_model=2)), (8, dict(n_dcn=2)),
              (8, dict(n_dcn=2, n_data=2, n_model=2)),
              (8, dict(n_dcn=4)), (8, dict(n_seq=2)),
              (8, dict(n_seq=2, n_model=2))]


@pytest.mark.parametrize("n,kw", MESH_CASES)
def test_mesh_shape_matches_jax(n, kw):
    """make_mesh's axis table and defaults: shape and names equal JAX's."""
    mesh = jax_sh.make_mesh(devices=jax.devices()[:n], **kw)
    shape, names = sharding.mesh_shape(n, **kw)
    assert names == tuple(mesh.axis_names)
    assert shape == tuple(mesh.devices.shape)


def test_mesh_shape_refuses_what_jax_asserts():
    with pytest.raises(ValueError):
        sharding.mesh_shape(8, n_data=3)
    with pytest.raises(ValueError):
        sharding.mesh_shape(8, n_seq=2, n_dcn=2)
    with pytest.raises(ValueError):
        sharding.mesh_shape(6, n_dcn=4)


@pytest.mark.parametrize("tree", TREES)
def test_param_pspecs_match_jax(models, tree):
    _, _, jt, pt = models
    _assert_specs_equal(sharding.param_pspecs(pt[tree]),
                        jax_sh.param_pspecs(jt[tree]))


@pytest.mark.parametrize("tree", TREES)
def test_tp_param_specs_match_jax(models, tree):
    cfg, tcfg, jt, pt = models
    _assert_specs_equal(
        tp_decode.tp_param_specs(tp_decode.prepare_tp_params(pt[tree], tcfg,
                                                             tp=2)),
        jax_tp.tp_param_specs(jax_tp.prepare_tp_params(jt[tree], cfg, tp=2)))


def test_batch_and_cache_specs_match_jax():
    assert _spec(sharding.kv_cache_pspec()) == _spec(jax_sh.kv_cache_pspec())
    assert _spec(sharding.batch_pspec()) == _spec(jax_sh.batch_pspec())
    x = torch.zeros(3)
    assert sharding.seq_constraint(x) is x


@pytest.mark.parametrize("kind", ["bf16", "int8", "paged"])
def test_engine_state_specs_match_jax(models, kind):
    """The engine state's specs: slots (and a paged pool's pages) over the
    data axes, heads over ``model``."""
    from block_transformer_tpu.models import neox as jax_neox
    from block_transformer_tpu_torch.models import neox as torch_neox
    cfg, tcfg, _, _ = models
    if kind == "paged":
        cj = jax_neox.PagedKVCache.create(cfg.block_decoder, 4, 8, n_pages=5,
                                          page_size=4)
        ct = torch_neox.PagedKVCache.create(tcfg.block_decoder, 4, 8,
                                            n_pages=5, page_size=4,
                                            device="cpu")
    else:
        cj = jax_neox.make_kv_cache(cfg.block_decoder, 4, 8, kind)
        ct = torch_neox.make_kv_cache(tcfg.block_decoder, 4, 8, kind,
                                      device="cpu")
    for axes in (("data",), ("dcn", "data")):
        want = jax_tp.engine_state_specs(cj, axes)
        got = tp_decode.engine_state_specs(ct, axes)
        assert [_spec(s) for s in got[0]] == [
            _spec(s) for s in jax.tree.leaves(
                want[0], is_leaf=lambda x: isinstance(x, JP))]
        assert [_spec(s) for s in got[1:]] == [_spec(s) for s in want[1:]]


def test_qkv_head_major_perm_matches_jax():
    for hidden, heads in ((64, 4), (2048, 16)):
        np.testing.assert_array_equal(
            tp_decode._qkv_head_major_perm(hidden, heads).numpy(),
            np.asarray(jax_tp._qkv_head_major_perm(hidden, heads)))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("tree", TREES)
def test_prepare_tp_params_bit_equal(models, tree, tp):
    """Head-major QKV columns and, INT4, row-parallel kernels repacked so
    each row shard is its own split-half packing: every leaf bit for bit."""
    cfg, tcfg, jt, pt = models
    got = dict(_leaves(tp_decode.prepare_tp_params(pt[tree], tcfg, tp=tp)))
    want = _jax_leaves(jax.device_get(
        jax_tp.prepare_tp_params(jt[tree], cfg, tp=tp)))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == bridge.tensor_from_numpy(
            np.asarray(leaf), "cpu").dtype, path
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(leaf),
                                      err_msg=str(path))


def test_prepare_tp_params_refuses_int4_without_tp(models):
    _, tcfg, _, pt = models
    with pytest.raises(ValueError, match="needs tp"):
        tp_decode.prepare_tp_params(pt["int4"], tcfg)


@pytest.fixture(scope="module")
def rank_shards(models, tmp_path_factory):
    _, tcfg, _, pt = models
    tmp = tmp_path_factory.mktemp("sharding")
    torch.save(pt, tmp / "params.pt")
    return ranks.spawn("mesh", tmp, params_file=str(tmp / "params.pt"),
                       cfg=tcfg)


def _jax_mesh(name):
    return jax_sh.make_mesh(devices=jax.devices()[:ranks.WORLD],
                            **ranks.MESHES[name])


@pytest.mark.parametrize("name", sorted(ranks.MESHES))
def test_rank_meshes_match_jax(rank_shards, name):
    """Each rank's DeviceMesh: JAX's names and shape, and the rank sits at
    the coordinate of the JAX device of its index."""
    mesh = _jax_mesh(name)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r, res in enumerate(rank_shards):
        got = res[name]
        assert got["names"] == tuple(mesh.axis_names)
        assert got["shape"] == tuple(mesh.devices.shape)
        assert tuple(int(i) for i in np.argwhere(ids == r)[0]) == got["coord"]
    assert not any(res["jax_imported"] for res in rank_shards)


@pytest.mark.parametrize("rules", ["gspmd", "tp"])
@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("name", sorted(ranks.MESHES))
def test_rank_shards_equal_jax(models, rank_shards, name, tree, rules):
    """Each rank's shard of every leaf equals JAX's addressable shard on the
    device of the rank's index: ``shard_params`` against JAX's
    ``param_shardings``; ``shard_tp_params`` of the prepared tree against
    the prepared tree placed by ``tp_param_specs``."""
    cfg, _, jt, _ = models
    mesh = _jax_mesh(name)
    if rules == "gspmd":
        tree_j, specs = jt[tree], jax_sh.param_pspecs(jt[tree])
    else:
        tree_j = jax_tp.prepare_tp_params(jt[tree], cfg, tp=2)
        specs = jax_tp.tp_param_specs(tree_j)
    leaves, specs = _jax_leaves(tree_j), _jax_leaves(specs)
    key = "shards" if rules == "gspmd" else "tp_shards"
    for path, leaf in leaves.items():
        placed = jax.device_put(leaf, NamedSharding(mesh, specs[path]))
        by_device = {s.device.id: np.asarray(s.data)
                     for s in placed.addressable_shards}
        for r, res in enumerate(rank_shards):
            got = res[name][key][tree]
            for k in path:
                got = got[k]
            np.testing.assert_array_equal(got, by_device[r],
                                          err_msg=f"rank {r} {path}")
