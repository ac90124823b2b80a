"""The port's vanilla training and uptraining (``models/vanilla.py``'s
``vanilla_loss``, ``train/vanilla_trainer.py``, ``train/uptrain.py`` and the
entry point ``pretrain_vanilla_transformer.py``) against the JAX package's,
on the CPU, from the same seeded parameters (JAX's, bridged as numpy).

Tolerances:
- ``vanilla_loss`` (remat on and off): within 1e-5 relative, float32;
- ``VanillaTrainer`` (3 steps, accumulation 2) from JAX's initial state:
  every record's ``step`` exact, ``loss`` within 1e-5 relative, ``lr``
  within 1e-7 relative;
- ``load_block_from_vanilla`` for each method (``skip``, ``partition``,
  ``duplicate``) and each option: every copied, sliced or initialized
  leaf bit for bit with JAX's dtype, the token decoder's computed
  embeddings (a forward of the block decoder) within 1e-5 of their
  largest magnitude in float32, 2e-2 in bf16 (the port's bf16 tolerance:
  ~2^-8 rounding of each op's output, summed in another order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.data import packing as jax_packing
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import vanilla as jax_vanilla
from block_transformer_tpu.parallel import sharding as jax_sharding
from block_transformer_tpu.train import trainer as jax_trainer
from block_transformer_tpu.train import uptrain as jax_uptrain
from block_transformer_tpu.train import vanilla_trainer as jax_vt
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch import pretrain_vanilla_transformer as entry
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.models import vanilla
from block_transformer_tpu_torch.train import optimizer as opt
from block_transformer_tpu_torch.train import trainer
from block_transformer_tpu_torch.train import uptrain
from block_transformer_tpu_torch.train import vanilla_trainer
from block_transformer_tpu_torch.utils import checkpoint as ckpt
from tests.test_trainer import make_dataset

V, H = 96, 64
RTOL = 1e-5
LR_RTOL = 1e-7
EMB_TOL = 1e-5
EMB_TOL_BF16 = 2e-2


def neox(C, layers):
    return C.NeoXConfig(vocab_size=V, hidden_size=H, num_layers=layers,
                        num_heads=4, intermediate_size=H * 4,
                        max_position_embeddings=64)


def block_cfg(C, layers=2, emb_hidden=H // 4, projection="concat"):
    return C.BlockTransformerConfig(
        block_length=4,
        embedder=C.EmbedderConfig(vocab_size=V, hidden_size=emb_hidden,
                                  projection_hidden_size=H,
                                  projection_method=projection),
        block_decoder=neox(C, layers),
        token_decoder=C.TokenDecoderConfig(neox=neox(C, layers),
                                           expansion_ratio=2))


def flat(tree):
    return {tuple(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(jax.device_get(tree))}


@pytest.mark.parametrize("remat", [False, True])
def test_vanilla_loss_equals_jax(remat):
    cfg = neox(jax_config, 2)
    params = jax_vanilla.init_vanilla_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, V, (3, 20)).astype(np.int32)
    att = np.ones_like(ids)
    att[1, :6] = 0
    labels = np.where(att == 0, -100, ids).astype(np.int32)
    labels[2, 5] = -100
    want = float(jax_vanilla.vanilla_loss(params, cfg, ids, att, labels,
                                          remat=remat))
    t = lambda a: torch.from_numpy(a)                      # noqa: E731
    tp = bridge.params_from_numpy(jax.device_get(params), device="cpu")
    with torch.enable_grad():
        live = opt.tree_map(lambda p: p.requires_grad_(True), tp)
        loss = vanilla.vanilla_loss(live, neox(torch_config, 2), t(ids),
                                    t(att), t(labels), remat=remat)
        loss.backward()
    assert loss.dtype == torch.float32
    assert abs(float(loss) - want) <= RTOL * abs(want)
    assert all(p.grad is not None for p in opt.tree_leaves(live))


def test_vanilla_trainer_records_equal_jax(tmp_path):
    tkw = dict(learning_rate=3e-3, num_train_steps=8, stop_steps=3,
               num_warmup_steps=1, total_batch_size=4, micro_batch_size=2,
               max_length=32, save_steps=100, logging_steps=1, remat=False)
    corpus = make_dataset().corpus
    one = jax.devices()[:1]
    mesh = jax_sharding.make_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vt.sh, "make_mesh",
                   lambda n_data, n_model: mesh(n_data, n_model, devices=one))
        jt = jax_vt.VanillaTrainer(
            neox(jax_config, 1), jax_trainer.TrainerConfig(
                output_dir=f"{tmp_path}/jax", n_data=1, n_model=1, **tkw),
            jax_packing.PackedDataset(corpus, 32, eos_token=0,
                                      block_length=None))
        state0 = jax.device_get(jt.state)
        jt.train()
    tt = vanilla_trainer.VanillaTrainer(
        neox(torch_config, 1), trainer.TrainerConfig(
            output_dir=f"{tmp_path}/port", **tkw),
        packing.PackedDataset(corpus, 32, eos_token=0, block_length=None),
        device="cpu")
    tt.state = bridge.train_state_from_numpy(state0, device="cpu")
    state = tt.train()
    read = lambda d: [json.loads(l) for l in open(f"{tmp_path}/{d}/"  # noqa
                                                    "metrics.jsonl")]
    want, got = read("jax"), read("port")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert abs(g["loss"] - w["loss"]) <= RTOL * abs(w["loss"])
        assert abs(g["lr"] - w["lr"]) <= LR_RTOL * abs(w["lr"])
    assert state.step == 3 and ckpt.find_latest_checkpoint(
        f"{tmp_path}/port") == 3
    assert got[-1]["loss"] < got[0]["loss"]


OPTIONS = {"none": {},
           "mean projection": dict(initialize_mean_embedder_projection=True),
           "identity expansion": dict(
               initialize_identity_expansion_layer=True),
           "computed embeddings": dict(compute_token_decoder_embeddings=True),
           "all": dict(initialize_mean_embedder_projection=True,
                       initialize_identity_expansion_layer=True,
                       compute_token_decoder_embeddings=True)}
METHODS = {"skip": (2, 4), "partition": (2, 3), "duplicate": (2, 2)}


@pytest.fixture(scope="module")
def trees():
    """(JAX block params, JAX vanilla params) by (layers, vanilla layers,
    dtype), made once."""
    cache = {}

    def get(layers, vl, dtype):
        key = (layers, vl, dtype)
        if key not in cache:
            cache[key] = (
                jax_bt.init_block_transformer_params(
                    jax.random.PRNGKey(0), block_cfg(jax_config, layers),
                    dtype=dtype),
                jax_vanilla.init_vanilla_params(
                    jax.random.PRNGKey(1), neox(jax_config, vl), dtype=dtype))
        return cache[key]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_load_block_from_vanilla_equals_jax(trees, method, option, dtype):
    layers, vl = METHODS[method]
    bp, vp = trees(layers, vl, jnp.dtype(dtype))
    want = flat(jax_uptrain.load_block_from_vanilla(
        bp, block_cfg(jax_config, layers), vp, neox(jax_config, vl),
        method=method, **OPTIONS[option]))
    got_tree = uptrain.load_block_from_vanilla(
        bridge.params_from_numpy(jax.device_get(bp), device="cpu"),
        block_cfg(torch_config, layers),
        bridge.params_from_numpy(jax.device_get(vp), device="cpu"),
        neox(torch_config, vl), method=method, **OPTIONS[option])
    got = dict(opt.tree_items(bridge.params_to_numpy(got_tree)))
    assert sorted(got) == sorted(want)
    computed = ("token_decoder", "embed_in", "weight")
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        if path == computed and "compute_token_decoder_embeddings" in \
                OPTIONS[option]:
            w32, g32 = w.astype(np.float32), got[path].astype(np.float32)
            tol = EMB_TOL if dtype == "float32" else EMB_TOL_BF16
            assert np.abs(g32 - w32).max() <= tol * np.abs(w32).max()
        else:
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    # every leaf its own storage: the train step adds to each in place
    leaves = opt.tree_leaves(got_tree)
    assert len({t.untyped_storage().data_ptr() for t in leaves}) == len(
        leaves)


def test_uptrain_methods_reject_what_jax_rejects():
    bp = {"embedder": {}, "block_decoder": {}, "token_decoder": {}}
    vp = {"embed_in": {"weight": torch.zeros(V, H)}, "layers": {}}
    for method, vl in (("skip", 3), ("duplicate", 3), ("bogus", 2)):
        with pytest.raises(ValueError):
            uptrain.load_block_from_vanilla(bp, block_cfg(torch_config, 2),
                                            vp, neox(torch_config, vl),
                                            method=method)


def test_vanilla_then_uptrain_then_train_on_the_cpu(tmp_path):
    """The card's smoke path at a small size: the vanilla entry point, its
    checkpoint's parameters partitioned into a block transformer whose
    projection-layer embedder takes the vanilla table, and 2 block train
    steps from there."""
    (tmp_path / "v.yaml").write_text(
        "name: tiny_vanilla\nmodel: gpt-neo-x\nmodel_config:\n"
        f"  num_hidden_layers: 4\n  hidden_size: {H}\n  vocab_size: {V}\n")
    vt = entry.main(["--config", str(tmp_path / "v.yaml"), "--synthetic",
                     "4000", "--steps", "2", "--max_length", "32",
                     "--batch_size", "2", "--output_dir",
                     str(tmp_path / "v"), "--cpu"])
    assert vt.device == "cpu" and vt.state.step == 2
    recs = [json.loads(l) for l in open(tmp_path / "v" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [2]
    vp = ckpt.restore_params(str(tmp_path / "v"), 2, device="cpu")
    cfg = block_cfg(torch_config, emb_hidden=H, projection="projection_layer")
    ds = packing.PackedDataset(make_dataset().corpus, 32, eos_token=0,
                               pad_token=0, block_length=4)
    bt = trainer.Trainer(cfg, trainer.TrainerConfig(
        output_dir=str(tmp_path / "b"), stop_steps=2, num_train_steps=10,
        num_warmup_steps=1, total_batch_size=2, max_length=32,
        logging_steps=1), ds, device="cpu")
    params = uptrain.load_block_from_vanilla(
        bt.state.params, cfg, vp, vt.model_cfg, method="partition",
        initialize_mean_embedder_projection=True,
        initialize_identity_expansion_layer=True)
    bt.state = trainer.ts.TrainState(params, bt.tx.init(params), 0)
    bt.train()
    recs = [json.loads(l) for l in open(tmp_path / "b" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert os.path.isdir(tmp_path / "b" / "checkpoint-2")
