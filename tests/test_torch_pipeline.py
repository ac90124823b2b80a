"""The port's pipeline (``parallel/pipeline.py``) against the JAX package's,
on the CPU.

Four gloo ranks (``tests/torch_mesh_ranks.py``, no JAX imported there)
run ``make_pp_train_step`` for two steps from JAX's initial state (bridged)
on the same global batches as JAX's ``make_pp_train_step`` on 4 of the
test process's 8 CPU devices, mesh by mesh: (data 2, pipe 2) and (data 1,
pipe 4), 2 and 4 micro-batches. The model is ``tests/test_pipeline.py``'s
(hidden 64, 4 + 4 layers, vocab 512, block length 4, float32), remat on;
both trunks pipeline (4 layers split over 2 or 4 stages). The batches are
ragged, 8 rows of 6 blocks. Learning rate 0 at step 1, 1e-3 at step 2.
Tolerances:

- the loss: 1e-5 relative;
- the pipelined loss's gradient at the initial state (``jax.grad`` of the
  same loss on JAX's side), each leaf within 2e-5 of its largest |g|;
- parameters after steps 1 and 2 within 1e-5 of the tree's largest |p|,
  first moments within 2e-5 of each leaf's largest |mu|, second moments
  within 1e-4 of its largest nu (as ``tests/test_torch_sharded_train.py``);
- every rank's gathered state the same, bit for bit;
- ``pp_param_pspecs`` and the moments' specs equal to JAX's.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from tests import torch_mesh_ranks as ranks
from tests.test_torch_sharded_train import (GRAD_TOL, MU_TOL, NU_TOL,
                                            PARAM_TOL, RTOL, TKW, _flat,
                                            _port_flat, _spec, ragged_batches)
from block_transformer_tpu.config import make_block_config as jax_config
from block_transformer_tpu.parallel import pipeline as jax_pp
from block_transformer_tpu.parallel import sharding as jax_sh
from block_transformer_tpu.train import optimizer as jax_opt
from block_transformer_tpu.train import train_step as jax_ts
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch.config import make_block_config
from block_transformer_tpu_torch.parallel import pipeline
from block_transformer_tpu_torch.train import optimizer as opt
from block_transformer_tpu_torch.train import train_step as ts

CASES = {"2x2pipe": 2, "1x4pipe": 4}       # mesh -> n_micro
CFG_KW = dict(block_decoder_hidden=64, block_decoder_layers=4, max_length=64,
              vocab_size=512)


def _jax_mesh(name):
    shape, names = ranks.TRAIN_MESHES[name]
    dev = np.asarray(jax.devices()[:ranks.WORLD]).reshape(shape)
    return Mesh(dev, names)


def _jax_grads(mesh, cfg, params, batch, n_micro) -> dict:
    """jax.grad of the pipelined loss (both trunks) at ``params``."""
    from block_transformer_tpu.models import block_transformer as jax_bt
    bd_fn = jax_pp.make_pp_block_decoder_forward(mesh, n_micro)
    td_fn = jax_pp.make_pp_token_decoder_stack(mesh, cfg.token_decoder,
                                               n_micro, remat=True)

    def loss(p):
        return jax_bt.block_transformer_forward(
            p, cfg, batch["input_ids"], batch["attention_mask"],
            batch["block_attention_mask"], labels=batch["labels"],
            compute_logits=False, remat=True, block_decoder_fn=bd_fn,
            token_decoder_stack_fn=td_fn).loss

    with jax.sharding.set_mesh(mesh):
        return _flat(jax.device_get(jax.jit(jax.grad(loss))(params)))


def _jax_run(name, cfg, tx, state0, batches) -> list:
    mesh = _jax_mesh(name)
    step_fn, spec = jax_pp.make_pp_train_step(mesh, cfg, tx, state0.params,
                                              n_micro=CASES[name],
                                              remat=True)
    steps = []
    with jax.sharding.set_mesh(mesh):
        state = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state0,
            spec, is_leaf=lambda x: isinstance(x, JP))
        for batch in batches:
            b = {k: jax.device_put(v, NamedSharding(mesh, JP("data")))
                 for k, v in batch.items()}
            state, metrics = step_fn(state, b)
            st = bridge.train_state_from_numpy(jax.device_get(state), "cpu")
            steps.append({"loss": float(metrics["loss"]),
                          "params": _port_flat(st.params),
                          "mu": _port_flat(st.opt_state.mu),
                          "nu": _port_flat(st.opt_state.nu)})
    steps[0]["grads"] = _jax_grads(mesh, cfg, state0.params, batches[0],
                                   CASES[name])
    return steps


@pytest.fixture(scope="module")
def models():
    cfg = jax_config("pp", **CFG_KW)
    tx, _ = jax_opt.make_optimizer(**TKW)
    state0 = jax.device_get(jax_ts.create_train_state(
        jax.random.PRNGKey(1), cfg, tx))
    return cfg, make_block_config("pp", **CFG_KW), tx, state0


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    cfg, tcfg, tx, state0 = models
    tmp = tmp_path_factory.mktemp("pipeline")
    torch.save(bridge.train_state_from_numpy(state0, "cpu"),
               tmp / "state.pt")
    batches = ragged_batches(cfg.vocab_size, B=8)
    wait = ranks.spawn_async("train", tmp, state_file=str(tmp / "state.pt"),
                             cfg=tcfg, cases=sorted(CASES.items()),
                             batches=batches, tkw=TKW)
    want = {name: _jax_run(name, cfg, tx, state0, batches)
            for name in CASES}
    return want, wait()


@pytest.mark.parametrize("name", sorted(CASES))
def test_pp_loss_equals_jax(runs, name):
    want, got = runs
    for s, (w, g) in enumerate(zip(want[name], got[0][name]["steps"])):
        np.testing.assert_allclose(float(g["metrics"]["loss"]), w["loss"],
                                   rtol=RTOL, err_msg=f"step {s + 1}")
        assert np.isfinite(g["grad_norm"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_pp_gathered_grads_equal_jax(runs, name):
    """The pipelined loss's gradient at the initial state (the backward
    through the reverse shifts, the loss scaled by 1/P on each ``pipe``
    rank, the replicated leaves summed over ``pipe``): every leaf within
    GRAD_TOL of its largest |g|, the embedder's and the LM head's too."""
    want, got = runs
    w, g = want[name][0]["grads"], got[0][name]["grads"]
    assert set(g) == set(w)
    for path, ref in w.items():
        err = np.abs(g[path] - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (path, err)
    assert np.abs(g[("embedder", "embeddings", "weight")]).max() > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_pp_params_and_moments_equal_jax(runs, name):
    want, got = runs
    for s, (w, g) in enumerate(zip(want[name], got[0][name]["steps"])):
        scale = max(np.abs(p).max() for p in w["params"].values())
        for path, ref in w["params"].items():
            err = np.abs(g["params"][path] - ref).max()
            assert err <= PARAM_TOL * scale, (s + 1, path, err)
        for key, tol in (("mu", MU_TOL), ("nu", NU_TOL)):
            for path, ref in w[key].items():
                err = np.abs(g[key][path] - ref).max()
                assert err <= tol * max(np.abs(ref).max(), 1e-30), (
                    s + 1, key, path, err)
    # the stacks moved under pipelined gradients
    moved = [np.abs(want[name][1]["params"][p] - want[name][0]["params"][p])
             .max() for p in want[name][0]["params"] if "layers" in p]
    assert max(moved) > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_pp_ranks_hold_one_state(runs, name):
    _, got = runs
    for r in got[1:]:
        assert not r["jax_imported"]
        for a, b in zip(r[name]["steps"], got[0][name]["steps"]):
            for key in ("params", "mu", "nu"):
                for path, t in b[key].items():
                    np.testing.assert_array_equal(a[key][path], t,
                                                  err_msg=f"{key} {path}")
    assert not got[0]["jax_imported"]


def _jax_specs(tree):
    return {tuple(k.key for k in p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


@pytest.mark.parametrize("pipe_td", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_pp_param_pspecs_equal_jax(models, runs, name, pipe_td):
    """``pp_param_pspecs`` (both trunks or the block decoder only) and the
    moments' specs over it, against JAX's; the ranks used the same."""
    _, _, tx, state0 = models
    mesh = _jax_mesh(name)
    want = jax_pp.pp_param_pspecs(state0.params, mesh,
                                  pipe_token_decoder=pipe_td)
    pt = bridge.params_from_numpy(state0.params, device="cpu")
    stand_in = types.SimpleNamespace(mesh_dim_names=tuple(mesh.axis_names),
                                     shape=tuple(mesh.devices.shape))
    got = pipeline.pp_param_pspecs(pt, stand_in, pipe_token_decoder=pipe_td)
    w = _jax_specs(want)
    g = dict(opt.tree_items(got))
    assert set(g) == set(w)
    for path in w:
        assert _spec(g[path]) == _spec(w[path]), path
    wm = _jax_specs(jax_ts._opt_state_pspecs(tx, state0.params, want,
                                             mesh)[1][0].mu)
    gm = dict(opt.tree_items(ts._opt_state_pspecs(None, pt, got,
                                                  stand_in).mu))
    for path in wm:
        assert _spec(gm[path]) == _spec(wm[path]), path
    if pipe_td:     # the ranks' step pipelines both trunks (4 layers)
        ranks_specs = dict(opt.tree_items(runs[1][0][name]["pspecs"]))
        for path in w:
            assert _spec(ranks_specs[path]) == _spec(w[path]), path
