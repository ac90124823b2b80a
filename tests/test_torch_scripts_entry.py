"""The port's entry scripts and offline asset scripts
(``block_transformer_tpu_torch/scripts/``: ``inference_demo``,
``measure_generation_time``, ``train_mfu``, ``train_ckpt``,
``longctx_85m``, ``kv_scheme_probe``, ``bench_packer``,
``retokenize_corpus``, ``build_longctx_assets``,
``build_real_task_fixtures``, ``build_pg_corpus``) against the JAX
package's ``scripts/``, on the CPU, at a tiny size: a block model of
hidden 64 and one layer a stack, the same JAX-initialised parameters on
both sides (``bridge.py``; where a script draws its own random parameters,
both sides' ``init_block_transformer_params`` / ``init_vanilla_params``
return that tree, and the named config is the tiny one on both sides).
The JAX scripts run through their ``main()`` with ``sys.argv`` set, and
with the persistent compilation cache some of them switch on kept off (no
file is written outside ``tmp_path``); where the JAX script keeps its logic
inside ``main()`` and a check needs a value it does not report, a spy on
the function it calls reads it.

Tolerances:
- ``inference_demo`` and ``measure_generation_time``: the timed run's
  greedy tokens equal. Both scripts ask for bf16 parameters and get the
  float32 tree on both sides (two frameworks' bf16 decodes may part at a
  near tie); the request is checked. The generation-time rows have the
  same keys, the CSV the same header, and ``--batch auto`` picks the same
  batch under the same given memory limit.
- ``train_mfu``: ``n_params`` and ``flops_per_step`` equal, the first loss
  within 1e-4 relative (float32).
- ``train_ckpt``: the same checkpoint steps; the first logged loss within
  1e-4 relative.
- ``longctx_85m``: the loss-by-position curves (block and vanilla) within
  1e-4 relative, the needle accuracies equal. The script's bf16 casts are
  left out on both sides for this (JAX's ``jnp.bfloat16`` is float32 for
  the call, the port's cast the identity): two bf16 forwards part by
  ~1e-3; the port's run with its cast is checked to forward bf16.
- ``kv_scheme_probe``: ``fake_quant`` bit-equal to JAX's for every scheme
  in float32 and bf16; each scheme's greedy tokens equal; a patch of
  ``neox.layer_qkv`` sees every K/V the bf16-cache generation writes, at
  the prefill and at every decode step of both decoders.
- ``bench_packer``: the batches equal, route by route.
- ``retokenize_corpus`` (byte to byte), ``build_longctx_assets`` (explicit
  ``--roots``), ``build_real_task_fixtures`` and ``build_pg_corpus``
  (synthetic essays): every output file byte-identical.
"""

import contextlib
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.data import packing as jax_packing
from block_transformer_tpu.eval import longctx as jax_longctx
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.models import vanilla as jax_vanilla
from block_transformer_tpu.train import optimizer as jax_opt
from block_transformer_tpu.train import train_step as jax_ts
from block_transformer_tpu.train import trainer as jax_trainer
from block_transformer_tpu.utils import checkpoint as jax_ckpt
from block_transformer_tpu.utils import hbm as jax_hbm
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.eval import longctx
from block_transformer_tpu_torch.inference import generate as gen
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.models import vanilla
from block_transformer_tpu_torch.scripts import (
    bench_packer, build_longctx_assets, build_pg_corpus,
    build_real_task_fixtures, decode_gate, inference_demo, kv_scheme_probe,
    longctx_85m, measure_generation_time, retokenize_corpus, train_ckpt,
    train_mfu)
from block_transformer_tpu_torch.train import optimizer as torch_opt
from block_transformer_tpu_torch.train import train_step as torch_ts
from block_transformer_tpu_torch.utils import checkpoint as ckpt
from block_transformer_tpu_torch.utils import hbm
from tests.test_torch_scripts_quality import (  # noqa: F401 (a fixture)
    build_argv, fixture_texts, jax_script, one_torch_thread,
    write_text_tree)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4
HIDDEN, LAYERS = 64, 1
CONTEXT = 1040            # longctx_85m: past the 1024 trained length


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A byte corpus of the fixture texts (``build_byte_corpus``): the
    train prefix (its holdout beside it)."""
    from block_transformer_tpu_torch.scripts import build_byte_corpus
    tmp = tmp_path_factory.mktemp("corpus")
    build_byte_corpus.main(build_argv(write_text_tree(tmp / "tree"),
                                      tmp / "pybytes"))
    return str(tmp / "pybytes")


def tiny_block(package, vocab_size=512, max_length=64):
    return package.make_block_config("t", HIDDEN, LAYERS,
                                     vocab_size=vocab_size,
                                     max_length=max_length)


def tiny_vanilla(package, vocab_size=512, max_position_embeddings=64):
    return package.NeoXConfig.from_hidden_layers(
        HIDDEN, LAYERS, num_heads=2, vocab_size=vocab_size,
        max_position_embeddings=max_position_embeddings)


def use_tiny_configs(monkeypatch, **kw):
    """Every named config is the tiny one on both sides; the scripts'
    keyword overrides (vocab, max length) still apply."""
    for package in (jax_config, torch_config):
        monkeypatch.setattr(package, "get_config",
                            lambda name, package=package, **k: tiny_block(
                                package, **{**kw, **k}))
        monkeypatch.setattr(
            package, "get_vanilla_config",
            lambda name, package=package, **k: tiny_vanilla(package, **k))


def jax_block_params(cfg_j):
    return jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(0), cfg_j))


def use_params(monkeypatch, pj, vj=None):
    """Both sides' random inits return ``pj`` (block) / ``vj`` (vanilla);
    returns {side: [dtypes asked for]}."""
    asked = {"jax": [], "port": []}

    def jax_init(key, cfg, dtype=jnp.float32):
        asked["jax"].append(jnp.dtype(dtype).name)
        return jax.tree.map(jnp.asarray, pj)

    def port_init(gen_, cfg, dtype=torch.float32, device="cuda"):
        asked["port"].append(str(dtype).replace("torch.", ""))
        return bridge.params_from_numpy(pj, device)

    monkeypatch.setattr(jax_bt, "init_block_transformer_params", jax_init)
    monkeypatch.setattr(bt, "init_block_transformer_params", port_init)
    if vj is not None:
        monkeypatch.setattr(jax_vanilla, "init_vanilla_params",
                            lambda key, cfg, dtype=jnp.float32: jax.tree.map(
                                jnp.asarray, vj))
        monkeypatch.setattr(vanilla, "init_vanilla_params",
                            lambda g, cfg, dtype=torch.float32,
                            device="cuda": bridge.params_from_numpy(
                                vj, device))
    return asked


@contextlib.contextmanager
def jax_main_context(monkeypatch, name, argv):
    """``scripts/<name>.py`` with ``sys.argv`` set to ``argv``; the JAX
    config updates its ``main`` makes (a persistent compilation cache, the
    platform) are not applied."""
    module = jax_script(name)
    real = jax.config.update
    keep_off = ("jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs", "jax_platforms")
    with monkeypatch.context() as mp:
        mp.setattr(jax.config, "update",
                   lambda k, v: None if k in keep_off else real(k, v))
        mp.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
        yield module


def run_jax_main(monkeypatch, name, argv):
    with jax_main_context(monkeypatch, name, argv) as module:
        return module.main()


def spy(monkeypatch, module, name, record):
    """Wrap ``module.name`` so every call's result is appended to
    ``record``."""
    real = getattr(module, name)

    def wrapped(*a, **k):
        out = real(*a, **k)
        record.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)


# ---------------------------------------------------------------------------
# inference_demo, measure_generation_time
# ---------------------------------------------------------------------------

def test_inference_demo_equals_jax(monkeypatch, capsys):
    use_tiny_configs(monkeypatch)
    pj = jax_block_params(tiny_block(jax_config))
    asked = use_params(monkeypatch, pj)
    runs = {"jax": [], "port": []}
    spy(monkeypatch, jax_gen, "generate_blocks", runs["jax"])
    spy(monkeypatch, gen, "generate_blocks", runs["port"])
    argv = ["--batch", "3", "--prompt_len", "10", "--max_length", "24"]
    run_jax_main(monkeypatch, "inference_demo", argv)
    jax_lines = capsys.readouterr().out.splitlines()
    report = inference_demo.main(argv + ["--cpu"])
    assert asked == {"jax": ["bfloat16"], "port": ["bfloat16"]}
    assert len(runs["jax"]) == len(runs["port"]) == 2   # warm-up, timed
    for got, want in zip(runs["port"], runs["jax"]):
        assert got.n_blocks == int(want.n_blocks)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
    n = report["n_blocks"] * 4
    np.testing.assert_array_equal(report["tokens"], np.asarray(
        runs["jax"][-1].tokens)[:, :report["n_blocks"]].reshape(3, n))
    want = next(ln for ln in jax_lines if ln.startswith("first sample"))
    assert f"first sample tokens: {report['tokens'][0].tolist()[:64]} ..." \
        == want
    assert report["n_params"] == jax_bt.count_params(pj)
    assert report["new_tokens"] == (24 - 8) * 3


def test_measure_generation_time_equals_jax(tmp_path, monkeypatch):
    """Block rows at ``--batch auto`` under a given memory limit (3 rows
    fit, 4 do not), vanilla rows at a fixed batch."""
    V = 50304                 # the scripts draw prompt ids up to 50254
    use_tiny_configs(monkeypatch, vocab_size=V)
    cfg_t = tiny_block(torch_config, vocab_size=V)
    pj = jax_block_params(tiny_block(jax_config, vocab_size=V))
    vj = jax.device_get(jax_vanilla.init_vanilla_params(
        jax.random.PRNGKey(1), tiny_vanilla(jax_config, vocab_size=V)))
    use_params(monkeypatch, pj, vj)
    prefill, decode = 8, 8
    est = [hbm.block_model_bytes(cfg_t, b, prefill, decode) for b in (3, 4)]
    limit = (est[0] + est[1]) / 2 / 0.8
    for module in (jax_hbm, hbm):
        monkeypatch.setattr(module, "hbm_bytes_limit", lambda: limit)
    runs = {"jax": [], "port": []}
    spy(monkeypatch, jax_gen, "generate_blocks", runs["jax"])
    spy(monkeypatch, gen, "generate_blocks", runs["port"])
    rows = {}
    for side in ("jax", "port"):
        out = tmp_path / side
        for model, batch in (("block_main_t", "auto"), ("vanilla_t", "2")):
            argv = ["--model", model, "--batch", batch, "--prefill",
                    prefill, "--decode", decode, "--dtype", "float32",
                    "--n_rep", "2", "--out", out]
            if side == "jax":
                run_jax_main(monkeypatch, "measure_generation_time", argv)
            else:
                rows[model] = measure_generation_time.main(
                    [*map(str, argv), "--cpu"]
                    + (["--profile"] if model.startswith("block") else []))
    assert len(runs["jax"]) == len(runs["port"]) == 3   # warm-up, 2 timed
    for got, want in zip(runs["port"], runs["jax"]):
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
    for model, batch in (("block_main_t", 3), ("vanilla_t", 2)):
        csvs = [(tmp_path / side / model / "generation_time.csv").read_text()
                .splitlines() for side in ("jax", "port")]
        assert csvs[0][0] == csvs[1][0] == ",".join(rows[model])
        assert len(csvs[0]) == len(csvs[1]) == 2
        jax_row = dict(zip(csvs[0][0].split(","), csvs[0][1].split(",")))
        assert int(jax_row["batch"]) == rows[model]["batch"] == batch
        for k in ("model", "prefill", "decode", "dtype"):
            assert jax_row[k] == str(rows[model][k])
    assert (tmp_path / "port" / "block_main_t" / "trace" /
            "generation.json").is_file()


# ---------------------------------------------------------------------------
# train_mfu, train_ckpt
# ---------------------------------------------------------------------------

def test_train_mfu_equals_jax(tmp_path, monkeypatch):
    use_tiny_configs(monkeypatch)
    use_params(monkeypatch, jax_block_params(tiny_block(jax_config,
                                                        max_length=32)))
    argv = ["--model", "t", "--batch", "2", "--max_length", "32",
            "--steps", "2", "--warmup", "0", "--corpus", ""]
    run_jax_main(monkeypatch, "train_mfu", argv + ["--out",
                                                   tmp_path / "jax.json"])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = train_mfu.main([*map(str, argv), "--cpu", "--out",
                          str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert sorted(got) == sorted(want)
    assert got["n_params"] == want["n_params"]
    assert got["flops_per_step"] == want["flops_per_step"]
    np.testing.assert_allclose(got["loss_first"], want["loss_first"],
                               rtol=RTOL)


def metrics_records(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_ckpt_equals_jax(tmp_path, monkeypatch, corpus):
    use_tiny_configs(monkeypatch)
    use_params(monkeypatch, jax_block_params(tiny_block(jax_config,
                                                        max_length=32)))
    mesh = jax_trainer.sh.make_mesh
    monkeypatch.setattr(jax_trainer.sh, "make_mesh",
                        lambda n_data, n_model: mesh(
                            n_data, n_model, devices=jax.devices()[:1]))
    argv = ["--model", "t", "--corpus", corpus, "--steps", "1", "--batch",
            "2", "--max_length", "32", "--n_checkpoints", "1"]
    run_jax_main(monkeypatch, "train_ckpt", argv + ["--out", tmp_path / "jax"])
    report = train_ckpt.main(argv + ["--out", str(tmp_path / "port"),
                                     "--cpu"])
    want_dir = tmp_path / "jax" / "t"
    assert report["out"] == str(tmp_path / "port" / "t")
    assert report["checkpoint_steps"] == \
        sorted(jax_ckpt.find_latest_checkpoint(want_dir) and
               [int(p.name.split("-")[1]) for p in want_dir.glob(
                   "checkpoint-*")]) == [1]
    assert [op["step"] for op in report["checkpoint_log"]] == [1]
    got, want = metrics_records(report["out"]), metrics_records(want_dir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1]
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=RTOL)
    # the run resumes from its latest checkpoint
    again = train_ckpt.main(argv + ["--out", str(tmp_path / "port"),
                                    "--cpu"])
    assert again["checkpoint_log"] == [{**again["checkpoint_log"][0],
                                        "op": "restore", "step": 1}]


# ---------------------------------------------------------------------------
# longctx_85m
# ---------------------------------------------------------------------------

def save_both(tmp_path, pj, name):
    """``pj`` as a JAX (orbax) and a port checkpoint at step 1; returns the
    two directories."""
    jdir, tdir = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    tx, _ = jax_opt.make_optimizer(peak_lr=3e-4, warmup_steps=250,
                                   total_steps=5000)
    params = jax.tree.map(jnp.asarray, pj)
    jax_ckpt.save_checkpoint(str(jdir), 1, jax_ts.TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.asarray(1, jnp.int32)))
    ckpt.save_checkpoint(str(tdir), 1, torch_ts.TrainState(
        bridge.params_from_numpy(pj, "cpu"), None, 1))
    return str(jdir), str(tdir)


def test_longctx_85m_equals_jax(tmp_path, monkeypatch, corpus):
    use_tiny_configs(monkeypatch)
    pj = jax_block_params(tiny_block(jax_config, max_length=CONTEXT))
    vj = jax.device_get(jax_vanilla.init_vanilla_params(
        jax.random.PRNGKey(1), tiny_vanilla(
            jax_config, max_position_embeddings=CONTEXT)))
    (jb, tb), (jv, tv) = save_both(tmp_path, pj, "b"), save_both(
        tmp_path, vj, "v")
    curves = {"jax": [], "port": []}
    spy(monkeypatch, jax_longctx, "loss_by_position_over_chunks",
        curves["jax"])
    spy(monkeypatch, longctx, "loss_by_position_over_chunks", curves["port"])
    common = ["--model", "t", "--context", CONTEXT, "--corpus",
              corpus + "_holdout", "--max_docs", "2", "--depths", "0,100",
              "--needle_templates", "1", "--vanilla", "vanilla_t",
              "--haystack", ROOT / "assets" / "needle_haystack.txt"]
    with monkeypatch.context() as mp:
        mp.setattr(jnp, "bfloat16", jnp.float32)
        run_jax_main(monkeypatch, "longctx_85m", common + [
            "--model_dir", jb, "--vanilla_dir", jv, "--out",
            tmp_path / "jax.json"])
    want = json.loads((tmp_path / "jax.json").read_text())
    with monkeypatch.context() as mp:
        mp.setattr(longctx_85m, "_bf16", lambda tree: tree)
        got = longctx_85m.main([*map(str, common), "--model_dir", tb,
                                "--vanilla_dir", tv, "--out",
                                str(tmp_path / "port.json"), "--cpu"])
    assert sorted(got) == sorted(want)
    assert len(curves["jax"]) == len(curves["port"]) == 2  # block, vanilla
    for (g, n), (w, m) in zip(curves["port"], curves["jax"]):
        assert n == m and len(g) == len(w)
        np.testing.assert_allclose(g, w, rtol=RTOL)
    for k, v in want.items():
        if k == "needle_accuracy_by_depth":
            assert {float(d): a for d, a in got[k].items()} == \
                {float(d): a for d, a in v.items()}
        elif isinstance(v, float) or isinstance(v, list):
            np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
        else:
            assert got[k] == v, k


def test_longctx_85m_forwards_bf16(tmp_path, monkeypatch, corpus):
    """The port's run as it is: the restored float32 tree is cast to bf16
    before the forward and the needle's generation."""
    use_tiny_configs(monkeypatch)
    pj = jax_block_params(tiny_block(jax_config, max_length=CONTEXT))
    _, tb = save_both(tmp_path, pj, "b")
    dtypes = []
    real = bt.block_transformer_forward

    def forward(params, *a, **k):
        dtypes.extend({t.dtype for t in torch_opt.tree_leaves(params)
                       if t.is_floating_point()})
        return real(params, *a, **k)

    monkeypatch.setattr(bt, "block_transformer_forward", forward)
    report = longctx_85m.main([
        "--model", "t", "--model_dir", tb, "--context", str(CONTEXT),
        "--corpus", corpus + "_holdout", "--max_docs", "2",
        "--skip_needle", "--out", str(tmp_path / "r.json"), "--cpu"])
    assert dtypes and set(dtypes) == {torch.bfloat16}
    assert report["checkpoint_step"] == 1 and report["n_chunks"] >= 2


# ---------------------------------------------------------------------------
# kv_scheme_probe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_probe():
    return jax_script("kv_scheme_probe")


def kv_sample(dtype, seed=0):
    """K/V-like values [2, 3, 5, 64] with a zero row, a constant row and
    values on half-steps of a scale (rounding ties)."""
    x = np.random.default_rng(seed).standard_normal((2, 3, 5, 64)) * 3
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = 1.5
    x[1, 2, 3] = np.arange(64) - 31.5
    return x.astype(np.float32) if dtype == "float32" else \
        x.astype(jnp.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", [s for s in kv_scheme_probe.SCHEMES
                                    if s != "bf16"])
def test_fake_quant_is_bit_equal_to_jax(jax_probe, scheme, dtype):
    assert kv_scheme_probe.SCHEMES == jax_probe.SCHEMES
    for half, q in zip(("k", "v"), kv_scheme_probe.SCHEMES[scheme]):
        x = kv_sample(dtype, seed=len(scheme) + (half == "v"))
        want = np.asarray(jax_probe.fake_quant(jnp.asarray(x), *q))
        got = bridge.tensor_to_numpy(kv_scheme_probe.fake_quant(
            bridge.tensor_from_numpy(x, "cpu"), *q))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                      err_msg=f"{scheme} {half}")


@pytest.mark.parametrize("schemes", ["sym4,bf16", "bf16,sym3"])
def test_kv_scheme_probe_refuses_bad_schemes(schemes, capsys):
    """bf16 (the reference) first, then known schemes; JAX's script fails
    on these only after decoding."""
    with pytest.raises(SystemExit) as exit_:
        kv_scheme_probe.main(["--schemes", schemes, "--cpu"])
    assert exit_.value.code == 2 and "--schemes" in capsys.readouterr().err


def test_kv_scheme_probe_tokens_equal_jax(tmp_path, monkeypatch, corpus,
                                          jax_probe):
    """Every scheme's greedy tokens, the JAX side decoded as its script's
    ``decode(scheme)`` does (``scripts/kv_scheme_probe.py:122-146``: the
    patched ``neox.layer_qkv``, the bf16 cache); the port's through its
    ``main``."""
    use_tiny_configs(monkeypatch)
    cfg_j = tiny_block(jax_config)
    pj = jax_block_params(cfg_j)
    _, tdir = save_both(tmp_path, pj, "b")
    batch, prompt_len, gen_tokens = 3, 24, 8
    prompts = decode_gate.sample_prompts(corpus + "_holdout", batch,
                                         prompt_len, 3)
    d = jax_gen.preprocess_inputs(cfg_j, prompts)
    B, N, L = d["input_ids"].shape
    max_blocks = N + gen_tokens // L
    params = jax.tree.map(jnp.asarray, pj)
    real = jax_neox.layer_qkv
    want = {}
    for scheme, (k_cfg, v_cfg) in jax_probe.SCHEMES.items():
        def patched(p, x, *, cfg, cos, sin, positions,
                    k_cfg=k_cfg, v_cfg=v_cfg):
            q, k, v = real(p, x, cfg=cfg, cos=cos, sin=sin,
                           positions=positions)
            if k_cfg is not None:
                k = jax_probe.fake_quant(k, *k_cfg)
            if v_cfg is not None:
                v = jax_probe.fake_quant(v, *v_cfg)
            return q, k, v

        with monkeypatch.context() as mp:
            mp.setattr(jax_neox, "layer_qkv", patched)
            jax_gen._generate_blocks_jit.clear_cache()
            res = jax_gen.generate_blocks(
                params, cfg_j, jnp.asarray(d["input_ids"]),
                jnp.asarray(d["attention_mask"]),
                jnp.asarray(d["block_attention_mask"]),
                max_blocks=max_blocks, greedy=True, kv_cache="bf16")
            want[scheme] = np.asarray(res.tokens).reshape(B, -1)[
                :, N * L:max_blocks * L]
    jax_gen._generate_blocks_jit.clear_cache()
    decoded = []
    spy(monkeypatch, decode_gate, "run_variant", decoded)
    report = kv_scheme_probe.main([
        "--model_dir", tdir, "--corpus", corpus + "_holdout", "--batch",
        str(batch), "--prompt_len", str(prompt_len), "--gen_tokens",
        str(gen_tokens), "--max_length", "64", "--out",
        str(tmp_path / "probe.json"), "--cpu"])
    assert len(decoded) == len(want)
    for got, (scheme, w) in zip(decoded, want.items()):
        np.testing.assert_array_equal(got, w, err_msg=scheme)
    assert sorted(report["schemes"]) == sorted(
        s for s in jax_probe.SCHEMES if s != "bf16")
    assert json.loads((tmp_path / "probe.json").read_text()) == report
    # the schemes moved something: INT4 K/V does not decode as bf16 does
    assert report["schemes"]["sym4"]["fp32_mean_logprob"] != \
        report["fp32_mean_logprob_ref"]


def test_layer_qkv_patch_sees_every_kv_write(monkeypatch):
    """Every K and V the bf16-cache generation writes (``neox._write_layer``:
    the block decoder's prefill and decode steps, the token decoder's
    prefix and token steps) is one that the module-level
    ``neox.layer_qkv`` returned: the probe's patch reaches them all."""
    cfg = tiny_block(torch_config)
    params = bridge.params_from_numpy(jax_block_params(tiny_block(
        jax_config)), "cpu")
    real_qkv, real_write = neox.layer_qkv, neox._write_layer
    returned, calls = [], []

    def counting_qkv(p, x, *, cfg, cos, sin, positions):
        q, k, v = real_qkv(p, x, cfg=cfg, cos=cos, sin=sin,
                           positions=positions)
        returned.append((k, v))
        calls.append((stacks.get(id(cfg), "other"), x.shape[1]))
        return q, k, v

    writes = []

    def checked_write(cache, i, write_pos, k, v):
        assert any(k is rk and v is rv for rk, rv in returned), \
            "a K/V write that layer_qkv did not return"
        writes.append(i)
        return real_write(cache, i, write_pos, k, v)

    stacks = {id(cfg.block_decoder): "block",
              id(cfg.token_decoder.neox): "token"}
    monkeypatch.setattr(neox, "layer_qkv", counting_qkv)
    monkeypatch.setattr(neox, "_write_layer", checked_write)
    N, max_blocks, L = 5, 8, cfg.block_length
    ids = np.random.default_rng(0).integers(1, 400, (2, N, L))
    res = gen.generate_blocks(params, cfg, ids, np.ones_like(ids),
                              np.ones((2, N), np.int64),
                              max_blocks=max_blocks, greedy=True,
                              kv_cache="bf16", device="cpu")
    assert res.n_blocks == max_blocks
    assert len(writes) == len(calls) > 0
    # each new block: the block decoder's step over the last block (its
    # prefill over the prompt first), then the token decoder's prefix step
    # over the expanded embeddings and L - 1 token steps; every layer
    new = max_blocks - N
    bl, tl = cfg.block_decoder.num_layers, cfg.token_decoder.neox.num_layers
    assert sorted(set(calls)) == sorted({
        ("block", N), ("block", 1), ("token", cfg.n_expanded_emb),
        ("token", 1)})
    assert calls.count(("block", N)) == bl
    assert calls.count(("block", 1)) == new * bl
    assert calls.count(("token", cfg.n_expanded_emb)) == new * tl
    assert calls.count(("token", 1)) == new * (L - 1) * tl


# ---------------------------------------------------------------------------
# bench_packer
# ---------------------------------------------------------------------------

def test_bench_packer_equals_jax(monkeypatch):
    batches = {"jax": [], "port": []}
    for side, cls in (("jax", jax_packing.PackedDataset),
                      ("port", packing.PackedDataset)):
        real = cls.get_batch

        def get_batch(self, idxs, use_native=True, real=real, side=side):
            out = real(self, idxs, use_native=use_native)
            batches[side].append((use_native, np.asarray(idxs).tolist(),
                                  out))
            return out

        monkeypatch.setattr(cls, "get_batch", get_batch)
    argv = ["--n_docs", "300", "--max_length", "128", "--batch", "4",
            "--n_batches", "3", "--reps", "1"]
    run_jax_main(monkeypatch, "bench_packer", argv)
    report = bench_packer.main(argv)
    want = {(n, str(i)): o for n, i, o in batches["jax"]}
    got = {(n, str(i)): o for n, i, o in batches["port"]}
    assert sorted(got) == sorted(want) and len(want) == 6
    for key, w in want.items():
        for k in w:
            np.testing.assert_array_equal(got[key][k], w[k], err_msg=key)
    assert report["equal"] and set(report["tok_per_s"]) == {"numpy", "cpp"}
    assert report["n_docs"] == 300 and report["samples"] > 4


# ---------------------------------------------------------------------------
# the offline asset scripts
# ---------------------------------------------------------------------------

def assert_same_files(got: Path, want: Path, names):
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


def test_retokenize_corpus_equals_jax(tmp_path, monkeypatch, corpus):
    argv = ["--src", corpus, "--src_tokenizer", "byte", "--dst_tokenizer",
            "byte", "--shard_docs", "3", "--max_docs", "8"]
    run_jax_main(monkeypatch, "retokenize_corpus",
                 argv + ["--out", tmp_path / "jax"])
    report = retokenize_corpus.main(argv + ["--out", str(tmp_path / "port")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert "index.json" in names and len(names) == 1 + 2 * 3
    assert_same_files(tmp_path / "port", tmp_path / "jax", names)
    assert report == {"docs": 8, "out": str(tmp_path / "port")}


def test_build_longctx_assets_equals_jax(tmp_path, monkeypatch):
    root = write_text_tree(tmp_path / "tree")
    argv = ["--roots", root, "--n_books", "2", "--min_chars", "6000",
            "--haystack_chars", "20000"]
    run_jax_main(monkeypatch, "build_longctx_assets",
                 argv + ["--out", tmp_path / "jax"])
    report = build_longctx_assets.main(
        [*map(str, argv), "--out", str(tmp_path / "port")])
    assert_same_files(tmp_path / "port", tmp_path / "jax",
                      ["books.jsonl", "haystack.txt"])
    assert report["books"] == 2 and report["haystack_chars"] == 20000


def write_essays(root: Path) -> Path:
    """Twelve synthetic essays of real prose (pairs of the fixture pages),
    and one under the loaders' 2000-character minimum."""
    root.mkdir(parents=True)
    texts = fixture_texts()
    for i in range(12):
        (root / f"essay{i:02d}.txt").write_text(
            texts[2 * i] + "\n\n  " + texts[2 * i + 1])
    (root / "short.txt").write_text(texts[30][:500])
    return root


def test_build_real_task_fixtures_and_pg_corpus_equal_jax(tmp_path,
                                                          monkeypatch):
    essays = write_essays(tmp_path / "essays")
    names = ["lambada_pg.jsonl", "wikitext_pg.jsonl", "trivia_real.jsonl",
             "gsm8k_style.jsonl", "META.json"]
    argv = ["--essays", essays, "--n_lambada", "20", "--n_wikitext", "4",
            "--holdout_every", "3"]
    run_jax_main(monkeypatch, "build_real_task_fixtures",
                 argv + ["--out", tmp_path / "jax"])
    report = build_real_task_fixtures.main(
        [*map(str, argv), "--out", str(tmp_path / "port")])
    assert_same_files(tmp_path / "port", tmp_path / "jax", names)
    assert report["essays"] == 12 and report["lambada_pg.jsonl"] == 20
    assert len(report["holdout_essays"]) == 4

    meta = tmp_path / "jax" / "META.json"
    argv = ["--essays", essays, "--holdout_every", "3", "--meta", meta]
    run_jax_main(monkeypatch, "build_pg_corpus",
                 argv + ["--out", tmp_path / "jax" / "pgbytes"])
    report = build_pg_corpus.main(
        [*map(str, argv), "--out", str(tmp_path / "port" / "pgbytes")])
    assert_same_files(tmp_path / "port", tmp_path / "jax",
                      ["pgbytes.bin", "pgbytes.idx", "pgbytes_holdout.bin",
                       "pgbytes_holdout.idx"])
    assert report["train_essays"] == 8
    # the holdout check: another rule than the fixtures' refuses to build
    with pytest.raises(SystemExit, match="holdout mismatch"):
        build_pg_corpus.main(["--essays", str(essays), "--holdout_every",
                              "4", "--meta", str(meta), "--out",
                              str(tmp_path / "bad" / "pgbytes")])
