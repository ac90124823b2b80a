"""The port's training loop (``train/trainer.py``, ``train/train_step.py``'s
``make_grad_and_apply``, ``utils/checkpoint.py`` and the entry point
``pretrain_block_transformer.py``) against the JAX package's, on the CPU.

The JAX ``Trainer`` runs at the size of ``tests/test_trainer.py`` (hidden
64, one layer, vocab 96, samples of 32 tokens) on a one-device mesh
(``n_data = n_model = 1``); the port's ``Trainer`` starts from JAX's
initial state (bridged as numpy: ``jax.random`` cannot be reproduced in
torch) and reads the same ``PackedDataset`` corpus. 4 steps, total batch
8 of micro-batches of 4 (accumulation 2), ramp-up 2 (accumulation 1 for
the first two steps), remat off, float32. Tolerances:

- every ``metrics.jsonl`` record: ``step`` and ``tokens_seen`` exact,
  ``lr`` within 1e-7 relative, the losses, ``grad_norm`` and each
  ``loss_by_position`` entry within 1e-5 relative (float32, sums taken in
  another order);
- the final parameters within 1e-5 of the tree's largest |p|: Adam turns
  a gradient that is zero in exact arithmetic (the key bias on the
  dimensions RoPE leaves alone) into the sign of its rounding noise, so
  those coordinates move by ~lr apart on the two sides, below that bound
  at this lr;
- the port saved at step 2 and resumed to step 4 equals its uninterrupted
  run bit for bit (records but the wall time, parameters and moments);
- variable block lengths (``uniform``, mean 4, radius 3): batches exact,
  records as above;
- bf16 ``param_dtype``: after steps 1 and 2 every leaf of the state (the
  parameters and Adam's moments) has optax's dtype under JAX's trainer,
  and the losses agree within 2e-2 relative.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from block_transformer_tpu.config import make_block_config as jax_make_config
from block_transformer_tpu.data import packing as jax_packing
from block_transformer_tpu.parallel import sharding as jax_sharding
from block_transformer_tpu.train import trainer as jax_trainer
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import pretrain_block_transformer as entry
from block_transformer_tpu_torch.config import make_block_config
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.train import optimizer as opt
from block_transformer_tpu_torch.train import trainer
from block_transformer_tpu_torch.utils import checkpoint as ckpt
from tests.test_trainer import make_dataset

RTOL = 1e-5
LR_RTOL = 1e-7
PARAM_TOL = 1e-5
BF16_RTOL = 2e-2
TKW = dict(learning_rate=3e-3, num_train_steps=12, stop_steps=4,
           num_warmup_steps=2, total_batch_size=8, micro_batch_size=4,
           batch_size_rampup_steps=2, max_length=32, save_steps=100,
           logging_steps=1, remat=False)
CFG_KW = dict(block_decoder_hidden=64, block_decoder_layers=1, vocab_size=96,
              max_length=32)


def datasets(block_length=4, max_length=32):
    corpus = make_dataset().corpus
    kw = dict(eos_token=0, pad_token=0, block_length=block_length, seed=1)
    return (jax_packing.PackedDataset(corpus, max_length, **kw),
            packing.PackedDataset(corpus, max_length, **kw))


def records(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_pair(out_dir, cfg_kw=CFG_KW, block_length=4, jax_hook=None,
             torch_hook=None, **tkw):
    """The JAX trainer and the port's from JAX's initial state, trained;
    returns (jax trainer, port trainer, JAX's initial state as numpy)."""
    tkw = {**TKW, **tkw}
    jds, tds = datasets(block_length, tkw["max_length"])
    one = jax.devices()[:1]
    mesh = jax_sharding.make_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer.sh, "make_mesh",
                   lambda n_data, n_model: mesh(n_data, n_model, devices=one))
        jt = jax_trainer.Trainer(
            jax_make_config("tiny", block_length=block_length, **cfg_kw),
            jax_trainer.TrainerConfig(output_dir=f"{out_dir}/jax", n_data=1,
                                      n_model=1, **tkw), jds,
            eval_hook=jax_hook and (lambda s, _: jax_hook(s, jt.state)))
        state0 = jax.device_get(jt.state)
        jt.train()
    tt = trainer.Trainer(
        make_block_config("tiny", block_length=block_length, **cfg_kw),
        trainer.TrainerConfig(output_dir=f"{out_dir}/port", **tkw), tds,
        eval_hook=torch_hook and (lambda s, _: torch_hook(s, tt.state)),
        device="cpu")
    tt.state = bridge.train_state_from_numpy(state0, device="cpu")
    tt.train()
    return jt, tt, state0


@pytest.fixture(scope="module")
def f32_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("f32"))
    return (out, *run_pair(out))


def assert_records_close(got, want):
    assert sorted(got) == sorted(want)
    assert (got["step"], got["tokens_seen"]) == (want["step"],
                                                 want["tokens_seen"])
    assert abs(got["lr"] - want["lr"]) <= LR_RTOL * abs(want["lr"])
    for k, w in want.items():
        if k not in ("step", "tokens_seen", "lr", "wall_time_s"):
            np.testing.assert_allclose(got[k], w, rtol=RTOL, err_msg=k)
    assert got["wall_time_s"] > 0


@pytest.mark.parametrize("i", range(4))
def test_records_equal_jax(f32_run, i):
    out = f32_run[0]
    want, got = records(f"{out}/jax"), records(f"{out}/port")
    assert len(got) == len(want) == 4
    assert got[i]["step"] == i + 1
    assert_records_close(got[i], want[i])


def test_final_params_equal_jax(f32_run):
    _, jt, tt, _ = f32_run
    want = {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(jax.device_get(
                jt.state.params))}
    got = dict(opt.tree_items(bridge.params_to_numpy(tt.state.params)))
    assert sorted(got) == sorted(want)
    bound = PARAM_TOL * max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        assert got[path].dtype == w.dtype
        assert np.abs(got[path] - w).max() <= bound, path
    assert tt.state.step == int(jt.state.step) == 4
    assert tt.state.opt_state.count == 4


def test_rampup_and_cursor_equal_jax(f32_run):
    _, jt, tt, _ = f32_run
    assert tt.grad_accum == jt.grad_accum == 2
    for step in range(7):
        assert tt._effective_accum(step) == jt._effective_accum(step)
        assert (tt._samples_consumed_before(step)
                == jt._samples_consumed_before(step))


def test_resume_is_bit_exact(f32_run, tmp_path):
    """Save at step 2, resume to step 4 in a new Trainer: the uninterrupted
    run's records, parameters and moments, bit for bit."""
    out, _, tt, state0 = f32_run
    _, tds = datasets()
    cfg = make_block_config("tiny", **CFG_KW)
    first = trainer.Trainer(cfg, trainer.TrainerConfig(
        output_dir=str(tmp_path), **{**TKW, "stop_steps": 2,
                                     "save_steps": 2}), tds, device="cpu")
    first.state = bridge.train_state_from_numpy(state0, device="cpu")
    first.train()
    assert ckpt.find_latest_checkpoint(str(tmp_path)) == 2
    second = trainer.Trainer(cfg, trainer.TrainerConfig(
        output_dir=str(tmp_path), **TKW), tds, device="cpu")
    state = second.train(resume=True)
    assert [(e["op"], e["step"]) for e in first.checkpoint_log] == [
        ("save", 2)]
    assert [(e["op"], e["step"]) for e in second.checkpoint_log] == [
        ("restore", 2), ("save", 4)]
    got, want = records(str(tmp_path)), records(f"{out}/port")
    assert [r["step"] for r in got] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "wall_time_s"} == {
            k: v for k, v in w.items() if k != "wall_time_s"}
    for mine, ref in ((state.params, tt.state.params),
                      (state.opt_state.mu, tt.state.opt_state.mu),
                      (state.opt_state.nu, tt.state.opt_state.nu)):
        for (pa, a), (pb, b) in zip(opt.tree_items(mine),
                                    opt.tree_items(ref)):
            assert pa == pb and a.dtype == b.dtype
            assert torch.equal(a, b), pa
    assert (state.step, state.opt_state.count) == (4, 4)


def test_variable_block_lengths_equal_jax(tmp_path):
    kw = dict(block_split_distribution="uniform",
              block_split_kwargs={"mean": 4, "radius": 3}, stop_steps=2,
              max_length=28)
    # hidden 224 = 7 x 32: the embedder's concat takes hidden / 7 a token
    jt, tt, _ = run_pair(str(tmp_path), block_length=7,
                         cfg_kw={**CFG_KW, "block_decoder_hidden": 224}, **kw)
    idxs = np.arange(4)
    want = jax_packing.make_train_batch(jt.dataset, idxs, 7,
                                        distribution=jt._distribution)
    got = packing.make_train_batch(tt.dataset, idxs, 7,
                                   distribution=tt._distribution)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["input_ids"].shape == (4, 7, 7)
    want_r, got_r = records(f"{tmp_path}/jax"), records(f"{tmp_path}/port")
    assert len(got_r) == len(want_r) == 2
    for g, w in zip(got_r, want_r):
        assert_records_close(g, w)


def _dtypes(params, mu, nu):
    out = {}
    for name, tree in (("params", params), ("mu", mu), ("nu", nu)):
        for path, leaf in opt.tree_items(tree):
            out[(name,) + path] = str(leaf.dtype).replace("torch.", "")
    return out


def test_bf16_state_dtypes_follow_optax(tmp_path):
    want, got = {}, {}

    def jax_hook(step, state):
        _, (adam, _, _) = state.opt_state
        flat = lambda t: {tuple(k.key for k in p): np.asarray(v) for p, v in
                          jax.tree_util.tree_leaves_with_path(t)}
        want[step] = {(name,) + path: str(a.dtype) for name, tree in
                      (("params", state.params), ("mu", adam.mu),
                       ("nu", adam.nu)) for path, a in flat(tree).items()}

    def torch_hook(step, state):
        got[step] = _dtypes(state.params, state.opt_state.mu,
                            state.opt_state.nu)

    run_pair(str(tmp_path), param_dtype="bfloat16", stop_steps=2,
                      jax_hook=jax_hook, torch_hook=torch_hook)
    assert sorted(got) == sorted(want) == [1, 2]
    for step in (1, 2):
        assert got[step] == want[step]
    assert set(v for k, v in got[2].items() if k[0] == "params") == {
        "bfloat16"}
    assert set(v for k, v in got[2].items() if k[0] != "params") == {
        "float32"}
    want_r, got_r = records(f"{tmp_path}/jax"), records(f"{tmp_path}/port")
    for g, w in zip(got_r, want_r):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=BF16_RTOL)


def test_fresh_bf16_moments_take_the_params_dtype():
    """Before the first update the moments are zeros in the parameters'
    dtype (optax's ``zeros_like``); the first float32 update replaces them
    with float32 leaves, and the update is float32."""
    tx, _ = opt.make_optimizer(1e-3, 1, 10)
    p = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
         "b": {"bias": torch.ones(2, dtype=torch.bfloat16)}}
    state = tx.init(p)
    assert {t.dtype for t in opt.tree_leaves(state.mu)} == {torch.bfloat16}
    g = opt.tree_map(lambda t: torch.full(t.shape, 0.5), p)
    upd, state = tx.update(g, state, p)
    for tree in (upd, state.mu, state.nu):
        assert {t.dtype for t in opt.tree_leaves(tree)} == {torch.float32}


@pytest.mark.parametrize("n_data,n_model", [(2, None), (None, 4), (2, 2)])
def test_parallel_meshes_raise(n_data, n_model, tmp_path):
    """A mesh of more than one rank needs its ranks in a process group
    (``tests/test_torch_sharded_train.py`` trains over one): outside one,
    the trainer refuses it instead of training on one device."""
    _, tds = datasets()
    with pytest.raises(RuntimeError, match="process group"):
        trainer.Trainer(make_block_config("tiny", **CFG_KW),
                        trainer.TrainerConfig(output_dir=str(tmp_path),
                                              n_data=n_data, n_model=n_model),
                        tds, device="cpu")


def test_checkpoint_round_trip(tmp_path):
    """bf16 parameters and float32 moments come back with their dtypes on
    the state's device; restore_params needs no optimizer; a state of
    another shape is refused."""
    tx, _ = opt.make_optimizer(1e-3, 1, 10)
    params = {"w": torch.randn(4, 3).to(torch.bfloat16),
              "ln": {"scale": torch.ones(3, dtype=torch.bfloat16)}}
    state = ckpt.ts.TrainState(params, tx.init(params), 0)
    upd, o = tx.update(opt.tree_map(lambda t: torch.randn(t.shape), params),
                       state.opt_state, params)
    state = ckpt.ts.TrainState(params, o, 7)
    ckpt.save_checkpoint(str(tmp_path), 7, state)
    ckpt.save_checkpoint(str(tmp_path), 3, state)
    assert ckpt.find_latest_checkpoint(str(tmp_path)) == 7
    assert ckpt.find_latest_checkpoint(str(tmp_path / "none")) is None
    like = ckpt.ts.TrainState(params, tx.init(params), 0)
    back = ckpt.restore_checkpoint(str(tmp_path), 7, like)
    assert (back.step, back.opt_state.count) == (7, 1)
    for a, b in ((back.params, params), (back.opt_state.mu, o.mu),
                 (back.opt_state.nu, o.nu)):
        for x, y in zip(opt.tree_leaves(a), opt.tree_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert {t.dtype for t in opt.tree_leaves(back.opt_state.mu)} == {
        torch.float32}
    only = ckpt.restore_params(str(tmp_path), 3, device="cpu")
    assert torch.equal(only["w"], params["w"])
    other = {"w": torch.zeros(4, 4), "ln": {"scale": torch.ones(3)}}
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(str(tmp_path), 7, ckpt.ts.TrainState(
            other, None, 0))


TINY_YAML = """\
name: tiny_block
block_length: 4
total_batch_size: 2
per_device_train_batch_size: 1
max_length: 32
embedder:
  cls: lookup
  n_embedding_tokens: 1
  config: {vocab_size: 96, hidden_size: 16}
block_decoder:
  cls: gpt-neo-x
  config: {num_hidden_layers: 1, hidden_size: 64}
token_decoder:
  cls: gpt-neo-x
  expansion_method: expansion_layer
  expansion_ratio: 2
  decoding_strategy: prefix
  config: {num_hidden_layers: 1, hidden_size: 64}
learning_rate: 6e-4
precision: fp32
num_train_steps: 10
num_warmup_steps: 1
save_steps: 100
logging_steps: 1
"""


def test_pretrain_entry_point_on_the_cpu(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    out = tmp_path / "out"
    t = entry.main(["--config", str(cfg), "--synthetic", "4000", "--steps",
                    "2", "--output_dir", str(out), "--cpu"])
    assert t.device == "cpu" and t.grad_accum == 2
    assert t.tcfg.learning_rate == 6e-4 and t.tcfg.param_dtype == "float32"
    recs = records(str(out))
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert ckpt.find_latest_checkpoint(str(out)) == 2
    assert {p.device.type for p in opt.tree_leaves(t.state.params)} == {"cpu"}


def test_synthetic_corpus_equals_the_jax_script(tmp_path):
    import argparse
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_pretrain", os.path.join(os.path.dirname(__file__), "..",
                                     "scripts", "pretrain_block_transformer.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    for synthetic, no_pad in ((5000, False), (100, True)):
        args = argparse.Namespace(pile=None, synthetic=synthetic, seed=3,
                                  no_random_pad=no_pad)
        want = script.build_dataset(args, 4, 64, 300)
        got = entry.build_dataset(args, 4, 64, 300)
        for f in ("token_data", "document_lengths", "document_indices"):
            np.testing.assert_array_equal(getattr(got.corpus, f),
                                          getattr(want.corpus, f))
        np.testing.assert_array_equal(got.left_pad, want.left_pad)
        assert len(got) == len(want)


UPTRAIN_YAML = """\
name: uptrain_from_vanilla_31
block_length: 4
total_batch_size: 2
per_device_train_batch_size: 1
max_length: 32
embedder:
  cls: lookup
  n_embedding_tokens: 1
  projection_method: projection_layer
  config: {{vocab_size: 50304, hidden_size: 256}}
block_decoder:
  cls: gpt-neo-x
  config: {{num_hidden_layers: {layers}, hidden_size: 256, num_attention_heads: 8}}
token_decoder:
  cls: gpt-neo-x
  expansion_method: expansion_layer
  expansion_ratio: 2
  decoding_strategy: prefix
  config: {{num_hidden_layers: {layers}, hidden_size: 256, num_attention_heads: 8}}
learning_rate: 6e-4
precision: fp32
num_train_steps: 10
num_warmup_steps: 1
save_steps: 100
logging_steps: 1
"""


@pytest.mark.parametrize("method,layers", [("skip", 3), ("partition", 3)])
def test_from_vanilla_uptrains_as_jax(tmp_path, monkeypatch, method, layers):
    """``--from_vanilla`` on a ``vanilla_31`` tree (6 layers of 256, the
    directory named after its config, as the JAX script reads it) written
    in the HF layout by JAX's exporter (the safetensors package), into
    block and token decoders of ``layers`` layers (``duplicate``, equal
    depth, is held in ``tests/test_torch_uptrain.py``) with a
    projection-layer embedder of the vanilla width: the uptrained tree the
    trainer starts from equals JAX's ``load_block_from_vanilla`` on that
    state dict, from the same initial block tree, bit for bit (float32);
    the optimizer state is fresh and the step trains."""
    from block_transformer_tpu import config as jax_config
    from block_transformer_tpu import config_yaml as jax_config_yaml
    from block_transformer_tpu.models import vanilla as jax_vanilla
    from block_transformer_tpu.train import uptrain as jax_uptrain
    from block_transformer_tpu.utils import torch_export as jax_export
    from block_transformer_tpu.utils import torch_import as jax_import
    from block_transformer_tpu_torch.train import uptrain

    cfg_path = tmp_path / "uptrain.yaml"
    cfg_path.write_text(UPTRAIN_YAML.format(layers=layers))
    jcfg = jax_config_yaml.load_block_config_yaml(str(cfg_path))
    vcfg = jax_config.get_vanilla_config("vanilla_31")
    vp = jax.device_get(jax_vanilla.init_vanilla_params(
        jax.random.PRNGKey(5), vcfg))
    sd = jax_export.neox_state_dict(vp, vcfg)
    van_dir = str(tmp_path / "vanilla_31")
    jax_export._write_component(van_dir, sd, jax_export._neox_hf_config(vcfg))

    seen = {}
    real_load, real_train = uptrain.load_block_from_vanilla, \
        trainer.Trainer.train

    def copy(tree):
        return jax.tree.map(np.array, bridge.params_to_numpy(tree))

    def load_spy(block_params, cfg, vanilla_params, vanilla_cfg, **kw):
        seen["before"], seen["kw"] = copy(block_params), kw
        out = real_load(block_params, cfg, vanilla_params, vanilla_cfg, **kw)
        seen["after"] = copy(out)
        return out

    def train_spy(self, resume=False):
        seen["start"] = (self.state.step, self.state.opt_state.count,
                         copy(self.state.params))
        return real_train(self, resume)

    monkeypatch.setattr(uptrain, "load_block_from_vanilla", load_spy)
    monkeypatch.setattr(trainer.Trainer, "train", train_spy)
    out = tmp_path / "out"
    t = entry.main(["--config", str(cfg_path), "--synthetic", "4000",
                    "--steps", "1", "--output_dir", str(out),
                    "--from_vanilla", van_dir, "--uptrain_method", method,
                    "--cpu"])
    assert seen["kw"] == {"method": method}
    want = jax.device_get(jax_uptrain.load_block_from_vanilla(
        seen["before"], jcfg,
        jax_import.neox_params_from_state_dict(sd, vcfg), vcfg,
        method=method))
    step, count, start = seen["start"]
    assert step == 0 and count == 0
    for tree in (seen["after"], start):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat) == len(flat_want)
        for path, leaf in flat:
            np.testing.assert_array_equal(leaf, np.asarray(flat_want[path]),
                                          err_msg=jax.tree_util.keystr(path))
    recs = records(str(out))
    assert t.state.step == 1 and np.isfinite(recs[-1]["loss"])