"""The port's training over a mesh against the JAX package's, on the CPU.

Four gloo ranks (``tests/torch_mesh_ranks.py``, no JAX imported there)
train from JAX's initial state (bridged) on the same two global batches as
JAX's ``make_sharded_grad_and_apply`` on 4 of the test process's 8 CPU
devices, mesh by mesh: (data 2, model 2), (dcn 2, data 1, model 2) and
(data 1, seq 2, model 2). The model is small (hidden 64, 2 heads, 2 + 2
layers, vocab 512, block length 4, expansion ratio 1, float32, remat on);
its tree holds a moment-placement quirk of JAX's ``_opt_state_pspecs``
(the expansion bias takes the spec of the block decoder's final-norm bias,
the first leaf of its shape, so its moments split over ``data`` while the
bias splits over ``model``). The batches are ragged (padded tokens, padded
blocks, a different weight sum on each data shard), so a mean of the
ranks' means would miss the loss. Learning rate 0 at step 1 (warmup 1),
1e-3 at step 2. Tolerances:

- loss, ``loss_by_position`` and the grad norm: 1e-5 relative (float32
  sums in another order);
- each gathered gradient leaf: within 2e-5 of its largest |g| (JAX's);
- parameters after steps 1 and 2: within 1e-5 of the tree's largest |p|
  (Adam turns a gradient that is zero in exact arithmetic into the sign
  of its rounding noise, as ``tests/test_torch_trainer.py`` says); the
  first moments within 2e-5 of each leaf's largest |mu|, the second
  within 1e-4 of its largest nu;
- every rank's gathered state the same, bit for bit;
- each rank holds 1/n of a ZeRO-split moment's bytes;
- ``_opt_state_pspecs``' spec tree equal to JAX's on every mesh shape;
- the ``Trainer`` and the ``VanillaTrainer`` at (data 2, model 2): their
  ``metrics.jsonl`` against the JAX trainers' on the same mesh, as
  ``tests/test_torch_trainer.py`` holds the one-device records (1e-5
  relative); the mesh checkpoint restores into the one-device trainer.
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from tests import torch_mesh_ranks as ranks
from tests.test_trainer import make_dataset
from block_transformer_tpu.config import make_block_config as jax_config
from block_transformer_tpu.data import packing as jax_packing
from block_transformer_tpu.parallel import sharding as jax_sh
from block_transformer_tpu.train import optimizer as jax_opt
from block_transformer_tpu.train import train_step as jax_ts
from block_transformer_tpu.train import trainer as jax_trainer
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch.config import make_block_config
from block_transformer_tpu_torch.parallel import sharding
from block_transformer_tpu_torch.train import optimizer as opt
from block_transformer_tpu_torch.train import train_step as ts

SHAPES = ("2x2", "dcn2x1x2", "1x2x2seq")
CFG_KW = dict(block_decoder_hidden=64, block_decoder_layers=2, max_length=64,
              vocab_size=512, expansion_ratio=1)
TKW = dict(peak_lr=1e-3, warmup_steps=1, total_steps=100)
RTOL = 1e-5
GRAD_TOL = 2e-5
PARAM_TOL = 1e-5
MU_TOL, NU_TOL = 2e-5, 1e-4


def ragged_batches(vocab: int, B=4, N=6, L=4, seed=0) -> list:
    """Two global batches with padded tokens and padded blocks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        ids = rng.integers(1, vocab - 2, size=(B, N, L)).astype(np.int32)
        att = np.ones((B, N, L), np.int32)
        att[0, -1, 1:] = 0
        att[1, 2:, 3] = 0
        att[3, -2:, :] = 0
        bam = att.any(-1).astype(np.int32)
        bam[2, 4] = 0
        labels = np.where(att == 0, -100, ids).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": att,
                    "block_attention_mask": bam, "labels": labels})
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: np.asarray(tree)}


def _port_flat(tree):
    return {p: t.numpy() for p, t in opt.tree_items(tree)}


def _jax_mesh(name):
    return jax_sh.make_mesh(devices=jax.devices()[:ranks.WORLD],
                            **ranks.TRAIN_MESHES[name])


def _jax_run(name, cfg, tx, state0, batches) -> dict:
    """JAX's sharded grad / apply for two steps on ``name``'s mesh."""
    mesh = _jax_mesh(name)
    steps = []
    with jax.sharding.set_mesh(mesh):
        state = jax_ts.shard_state(mesh, tx, state0)
        grad_fn, apply_fn, zeros_fn = jax_ts.make_sharded_grad_and_apply(
            mesh, cfg, tx, state.params, remat=True)
        bsh = NamedSharding(mesh, jax_sh.batch_pspec(mesh))
        for batch in batches:
            b = {k: jax.device_put(v, bsh) for k, v in batch.items()}
            grads, metrics = grad_fn(state.params, b,
                                     zeros_fn(state.params))
            g = _flat(jax.device_get(grads))
            state, norm = apply_fn(state, grads, 1.0)
            st = bridge.train_state_from_numpy(jax.device_get(state), "cpu")
            steps.append({"grads": g, "grad_norm": float(norm),
                          "metrics": jax.device_get(metrics),
                          "params": _port_flat(st.params),
                          "mu": _port_flat(st.opt_state.mu),
                          "nu": _port_flat(st.opt_state.nu)})
    return steps


@pytest.fixture(scope="module")
def models():
    cfg = jax_config("mesh", **CFG_KW)
    tx, _ = jax_opt.make_optimizer(**TKW)
    state0 = jax.device_get(jax_ts.create_train_state(
        jax.random.PRNGKey(0), cfg, tx))
    return cfg, make_block_config("mesh", **CFG_KW), tx, state0


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    cfg, tcfg, tx, state0 = models
    tmp = tmp_path_factory.mktemp("sharded_train")
    torch.save(bridge.train_state_from_numpy(state0, "cpu"),
               tmp / "state.pt")
    batches = ragged_batches(cfg.vocab_size)
    wait = ranks.spawn_async("train", tmp, state_file=str(tmp / "state.pt"),
                             cfg=tcfg, cases=[(n, None) for n in SHAPES],
                             batches=batches, tkw=TKW)
    want = {name: _jax_run(name, cfg, tx, state0, batches)
            for name in SHAPES}
    return want, wait()


def test_batches_are_ragged_over_the_data_shards():
    """The two data shards' token weights differ, so the global masked
    mean is not the mean of the shards' means."""
    for b in ragged_batches(512):
        w = ((b["labels"][:, 1:] != -100) * b["attention_mask"][:, 1:]
             * b["block_attention_mask"][:, 1:, None])
        assert w[:2].sum() != w[2:].sum()


@pytest.mark.parametrize("name", SHAPES)
def test_loss_and_loss_by_position_equal_jax(runs, name):
    want, got = runs
    for s, (w, g) in enumerate(zip(want[name], got[0][name]["steps"])):
        for k in ("loss", "token_decoding_loss", "loss_by_position"):
            np.testing.assert_allclose(g["metrics"][k],
                                       np.asarray(w["metrics"][k]),
                                       rtol=RTOL, atol=1e-7,
                                       err_msg=f"step {s + 1} {k}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL)


@pytest.mark.parametrize("name", SHAPES)
def test_gathered_grads_equal_jax(runs, name):
    want, got = runs
    for s, (w, g) in enumerate(zip(want[name], got[0][name]["steps"])):
        assert set(g["grads"]) == set(w["grads"])
        for path, ref in w["grads"].items():
            err = np.abs(g["grads"][path] - ref).max()
            assert err <= GRAD_TOL * np.abs(ref).max(), (s + 1, path, err)


@pytest.mark.parametrize("name", SHAPES)
def test_params_and_moments_equal_jax(runs, name):
    want, got = runs
    for s, (w, g) in enumerate(zip(want[name], got[0][name]["steps"])):
        scale = max(np.abs(p).max() for p in w["params"].values())
        for path, ref in w["params"].items():
            err = np.abs(g["params"][path] - ref).max()
            assert err <= PARAM_TOL * scale, (s + 1, path, err)
        for key, tol in (("mu", MU_TOL), ("nu", NU_TOL)):
            for path, ref in w[key].items():
                assert g[key][path].dtype == ref.dtype
                err = np.abs(g[key][path] - ref).max()
                assert err <= tol * max(np.abs(ref).max(), 1e-30), (
                    s + 1, key, path, err)


@pytest.mark.parametrize("name", SHAPES)
def test_train_step_equals_jax(runs, name):
    """``make_sharded_train_step`` (one batch a step, remat off) for two
    steps: the loss of step 1 and the parameters after step 2."""
    want, got = runs
    g = got[0][name]["train_step"]
    w = want[name]
    np.testing.assert_allclose(g["loss"], float(w[0]["metrics"]["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(g["grad_norm"], w[0]["grad_norm"], rtol=RTOL)
    scale = max(np.abs(p).max() for p in w[1]["params"].values())
    for path, ref in w[1]["params"].items():
        err = np.abs(g["params"][path] - ref).max()
        assert err <= PARAM_TOL * scale, (path, err)


@pytest.mark.parametrize("name", SHAPES)
def test_ranks_hold_one_state(runs, name):
    """Every rank gathers the same state and the same metrics, bit for
    bit; no rank imported JAX."""
    _, got = runs
    for r in got[1:]:
        assert not r["jax_imported"]
        for a, b in zip(r[name]["steps"], got[0][name]["steps"]):
            for key in ("params", "mu", "nu", "grads"):
                for path, t in b[key].items():
                    np.testing.assert_array_equal(a[key][path], t,
                                                  err_msg=f"{key} {path}")
            np.testing.assert_array_equal(a["metrics"]["loss"],
                                          b["metrics"]["loss"])
    assert not got[0]["jax_imported"]


@pytest.mark.parametrize("name", SHAPES)
def test_zero_moments_hold_their_share(runs, name):
    """A moment split over the data axes (ZeRO) takes 1/n of its bytes on
    each rank; one split over ``model`` too, and a replicated one all."""
    _, got = runs
    mesh = types.SimpleNamespace(mesh_dim_names=_jax_mesh(name).axis_names)
    sizes = dict(zip(mesh.mesh_dim_names, _jax_mesh(name).devices.shape))
    split = 0
    for r in got:
        for path, (local, full) in r[name]["moment_bytes"].items():
            spec = r[name]["mspecs"]
            for k in path:
                spec = spec[k]
            n = int(np.prod([sizes[a] for a in ts._spec_axes(spec)] or [1]))
            assert local * n == full, (path, spec, local, full)
            split += n > 1 and "model" not in ts._spec_axes(spec)
    assert split


def _spec(s):
    return tuple(tuple(p) if isinstance(p, (tuple, list)) else p for p in s)


SPEC_MESHES = [dict(n_data=2, n_model=2), dict(n_dcn=2, n_data=1, n_model=2),
               dict(n_data=1, n_seq=2, n_model=2), dict(n_data=2, n_model=4),
               dict(n_data=8, n_model=1), dict(n_data=4, n_seq=2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", SPEC_MESHES)
def test_opt_state_pspecs_equal_jax(models, kw, dtype):
    """The moments' spec tree (both moments) and the count's, JAX's
    quirks included, on meshes of 4 and 8 devices."""
    cfg, _, tx, state0 = models
    params = jax.tree.map(lambda a: a.astype(dtype), state0.params)
    mesh = jax_sh.make_mesh(devices=jax.devices()[:int(np.prod(
        [v for v in kw.values()]))], **kw)
    want = jax_ts._opt_state_pspecs(tx, params, jax_sh.param_pspecs(params),
                                    mesh)
    adam = want[1][0]
    pt = bridge.params_from_numpy(params, device="cpu")
    stand_in = types.SimpleNamespace(
        mesh_dim_names=tuple(mesh.axis_names),
        shape=tuple(mesh.devices.shape))
    got = ts._opt_state_pspecs(None, pt, sharding.param_pspecs(pt), stand_in)
    assert _spec(got.count) == _spec(adam.count) == ()
    for g_tree, w_tree in ((got.mu, adam.mu), (got.nu, adam.nu)):
        w = {tuple(k.key for k in p): s for p, s in
             jax.tree_util.tree_flatten_with_path(
                 w_tree, is_leaf=lambda x: isinstance(x, JP))[0]}
        g = dict(opt.tree_items(g_tree))
        assert set(g) == set(w)
        for path in w:
            assert _spec(g[path]) == _spec(w[path]), (path, g[path], w[path])
    quirk = ("token_decoder", "expansion", "bias")
    assert "data" in _spec(g[quirk])[0] or _spec(g[quirk])[0] == "data"


# ---------------------------------------------------------------------------
# The Trainer over (data 2, model 2)
# ---------------------------------------------------------------------------

TRAINER_KW = dict(learning_rate=3e-3, num_train_steps=12, stop_steps=3,
                  num_warmup_steps=2, total_batch_size=8, micro_batch_size=4,
                  max_length=32, save_steps=100, logging_steps=1,
                  remat=False)
TRAINER_CFG = dict(block_decoder_hidden=64, block_decoder_layers=1,
                   vocab_size=96, max_length=32)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """JAX's Trainer and VanillaTrainer on (data 2, model 2) over 4 CPU
    devices, and the port's over 4 gloo ranks from their initial
    states."""
    from block_transformer_tpu.config import NeoXConfig as JNeoX
    from block_transformer_tpu.train import vanilla_trainer as jax_vanilla
    from block_transformer_tpu_torch.config import NeoXConfig
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    corpus = make_dataset().corpus
    ds_kw = dict(eos_token=0, pad_token=0, block_length=4, seed=1)
    devices = jax.devices()[:ranks.WORLD]
    make_mesh = jax_sh.make_mesh
    tkw = dict(n_data=2, n_model=2, **TRAINER_KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer.sh, "make_mesh",
                   lambda n_data, n_model: make_mesh(n_data, n_model,
                                                     devices=devices))
        jt = jax_trainer.Trainer(
            jax_config("tiny", **TRAINER_CFG),
            jax_trainer.TrainerConfig(output_dir=str(tmp / "jax" / "block"),
                                      **tkw),
            jax_packing.PackedDataset(corpus, 32, **ds_kw))
        jv = jax_vanilla.VanillaTrainer(
            JNeoX(**VANILLA_CFG),
            jax_trainer.TrainerConfig(output_dir=str(tmp / "jax" /
                                                     "vanilla"), **tkw),
            jax_packing.PackedDataset(corpus, 32, eos_token=0,
                                      block_length=None))
        for t, name in ((jt, "state.pt"), (jv, "vstate.pt")):
            torch.save(bridge.train_state_from_numpy(
                jax.device_get(t.state), "cpu"), tmp / name)
        wait = ranks.spawn_async(
            "trainer", tmp, cfg=make_block_config("tiny", **TRAINER_CFG),
            vcfg=NeoXConfig(**VANILLA_CFG), tkw=tkw,
            out_dir=str(tmp / "port"),
            data=(corpus, ds_kw, str(tmp / "state.pt"),
                  str(tmp / "vstate.pt")))
        jt.train()
        jv.train()
    want = {}
    for name in ("block", "vanilla"):
        with open(tmp / "jax" / name / "metrics.jsonl") as f:
            want[name] = [json.loads(line) for line in f]
    return want, wait(), tmp


VANILLA_CFG = dict(vocab_size=96, hidden_size=64, num_layers=1, num_heads=4,
                   intermediate_size=256, max_position_embeddings=64)


@pytest.mark.parametrize("which", ["block", "vanilla"])
def test_trainer_records_equal_jax(trainer_runs, which):
    want, got, _ = trainer_runs
    want = want[which]
    recs = got[0][which]["records"]
    assert len(recs) == len(want) == TRAINER_KW["stop_steps"]
    for g, w in zip(recs, want):
        assert sorted(g) == sorted(w)
        assert g["step"] == w["step"]
        assert g.get("tokens_seen") == w.get("tokens_seen")
        for k, v in w.items():
            if k not in ("step", "tokens_seen", "wall_time_s"):
                np.testing.assert_allclose(g[k], v, rtol=RTOL, err_msg=k)
    assert all(r[which]["records"] == [] for r in got[1:])   # rank 0 writes
    assert {r[which]["step"] for r in got} == {TRAINER_KW["stop_steps"]}
    assert not any(r["jax_imported"] for r in got)


@pytest.mark.parametrize("which", ["block", "vanilla"])
def test_mesh_checkpoint_restores_on_the_mesh(trainer_runs, which):
    """Every rank cuts its shards from the last checkpoint equal bit for
    bit to the ones it trained (the template from the shards' shapes, no
    gather); the host gather leaves the full state on rank 0's host
    only."""
    _, got, _ = trainer_runs
    assert all(r[which]["restored_equal"] for r in got)
    assert got[0][which]["host_gather"] == ["cpu"]
    assert all(r[which]["host_gather"] is None for r in got[1:])


def test_mesh_checkpoint_restores_on_one_device(trainer_runs):
    """The mesh run's checkpoint is the full state: the one-device trainer
    restores it, shapes and dtypes those of its own state."""
    from block_transformer_tpu_torch.data import packing
    from block_transformer_tpu_torch.train import trainer
    _, _, tmp = trainer_runs
    out = str(tmp / "port" / "block")
    step = TRAINER_KW["stop_steps"]
    assert os.path.isfile(os.path.join(out, f"checkpoint-{step}", "state.pt"))
    ds = packing.PackedDataset(make_dataset().corpus, 32, eos_token=0,
                               pad_token=0, block_length=4, seed=1)
    tt = trainer.Trainer(make_block_config("tiny", **TRAINER_CFG),
                         trainer.TrainerConfig(output_dir=out,
                                               **TRAINER_KW), ds,
                         device="cpu")
    state = tt.mesh_state.restore(out, step, tt.state)
    assert state.step == step and state.opt_state.count == step
    for a, b in zip(opt.tree_items(state.params),
                    opt.tree_items(tt.state.params)):
        assert a[0] == b[0] and a[1].shape == b[1].shape
        assert a[1].dtype == b[1].dtype
