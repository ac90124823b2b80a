"""The port's quality pipeline (``block_transformer_tpu_torch/scripts/``:
``build_byte_corpus``, ``quality_run``) against the JAX package's
``scripts/``, on the CPU, at a tiny size: a corpus written from the
fixture texts, a block model of hidden 64 and one layer a stack (max length
64), 8 held-out samples, the same JAX-initialised parameters on both sides
(``bridge.py``).

Tolerances: the corpus files byte for byte; each held-out perplexity within
1e-4 relative (two float32 models, summation orders apart); the harness
results within 1e-4, absolute or relative (perplexities exponentiate a
loglikelihood mean); the byte tasks' docs and the greedy decode agreement
equal. The end-to-end ``quality_run.main`` (two train steps, then every
phase) runs on the port alone and its report must have the JAX script's
layout, read from the script's source.
"""

import ast
import functools
import importlib
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import vanilla as jax_vanilla
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.ops import quant
from block_transformer_tpu_torch.scripts import build_byte_corpus
from block_transformer_tpu_torch.scripts import quality_run as qr

ROOT = Path(__file__).resolve().parents[1]
ASSETS = ROOT / "assets" / "real_tasks"
PPL_RTOL = 1e-4
RESULTS_TOL = 1e-4
MAX_LEN = 64
INT4_GROUP = 32
# the harness's byte tasks cut for time (same draws, fewer of them, the
# rolling-perplexity pages cut to PPL_CHARS)
SMALL_TASKS = dict(n_mc=6, n_ppl=2, ctx_chars=120, cont_chars=16)
PPL_CHARS = 300


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side in one intra-op thread: these tiny CPU models are
    launch-bound, and the suite runs files in parallel workers, where a
    pool of threads a worker oversubscribes the cores (measured: one test
    ran 25x longer under the suite than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_script(name: str):
    """``scripts/<name>.py`` of the JAX package, imported with the JAX
    config it changes at import (a persistent compilation cache) put
    back."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        return importlib.import_module(f"scripts.{name}")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def fixture_texts():
    texts = []
    for name, key in (("wikitext_pg", "page"), ("lambada_pg", "text")):
        with open(ASSETS / f"{name}.jsonl") as f:
            texts += [json.loads(line)[key] for line in f]
    return texts


def write_text_tree(root: Path) -> Path:
    """A tree of text files: the fixture texts (five lambada passages a
    file), nested, with suffixes the builder keeps and skips, and one file
    under its minimum size."""
    texts = fixture_texts()
    pages, passages = texts[:24], texts[24:]
    for i, page in enumerate(pages):
        sub = root / f"d{i % 3}" / ("deep" if i % 2 else "")
        sub.mkdir(parents=True, exist_ok=True)
        (sub / f"page{i}.{('txt', 'md', 'rst', 'py')[i % 4]}").write_text(
            page)
    for j in range(0, len(passages), 5):
        (root / f"lambada{j:03d}.txt").write_text(
            "\n\n".join(passages[j:j + 5]))
    (root / "skipped.json").write_text(pages[0])
    (root / "short.txt").write_text("too short")
    return root


def build_argv(root, out):
    return ["--out", str(out), "--roots", str(root), "--max_mb", "0.5",
            "--holdout_every", "4"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's corpus of the fixture tree: the train prefix."""
    tmp = tmp_path_factory.mktemp("corpus")
    root = write_text_tree(tmp / "tree")
    build_byte_corpus.main(build_argv(root, tmp / "pybytes"))
    return str(tmp / "pybytes")


def tiny_configs():
    kw = dict(vocab_size=qr.VOCAB, max_length=MAX_LEN)
    return (jax_config.make_block_config("t", 64, 1, **kw),
            torch_config.make_block_config("t", 64, 1, **kw))


@pytest.fixture(scope="module")
def models():
    """(JAX config, port config, JAX parameters, the port's bridged
    copy)."""
    cfg_j, cfg_t = tiny_configs()
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(0), cfg_j))
    return cfg_j, cfg_t, pj, bridge.params_from_numpy(pj, "cpu")


def holdouts(jqr, prefix):
    return (jqr.load_corpus(prefix + "_holdout"),
            qr.load_corpus(prefix + "_holdout"))


def trees(pj, pt, name):
    """The JAX and the port tree of ``name``, each quantized on its own
    side."""
    kw = {"fp32": None, "int8": dict(bits=8),
          "int4": dict(bits=4, group_size=INT4_GROUP)}[name]
    if kw is None:
        return pj, pt
    return (jax_quant.quantize_block_transformer(pj, **kw),
            quant.quantize_block_transformer(pt, **kw))


def small_tasks(module, monkeypatch):
    """``module.byte_tasks`` (the JAX script's or the port's) cut for
    time."""
    full = module.byte_tasks

    def byte_tasks(holdout):
        mc, ppl = full(holdout, **SMALL_TASKS)
        pages = [d[:PPL_CHARS] for d in ppl.docs()]
        ppl.docs = lambda: pages
        return [mc, ppl]

    monkeypatch.setattr(module, "byte_tasks", byte_tasks)


def assert_results_close(got, want):
    assert sorted(got) == sorted(want)
    for task, metrics in want.items():
        assert sorted(got[task]) == sorted(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(got[task][k], v, rtol=RESULTS_TOL,
                                       atol=RESULTS_TOL, err_msg=f"{task} {k}")


# ---------------------------------------------------------------------------
# build_byte_corpus
# ---------------------------------------------------------------------------

def test_build_byte_corpus_equals_jax(tmp_path, monkeypatch):
    jbc = jax_script("build_byte_corpus")
    root = write_text_tree(tmp_path / "tree")
    monkeypatch.setattr(sys, "argv", ["build_byte_corpus.py"] + build_argv(
        root, tmp_path / "jax" / "pybytes"))
    jbc.main()
    report = build_byte_corpus.main(build_argv(root,
                                               tmp_path / "port" / "pybytes"))
    for suffix in ("", "_holdout"):
        for ext in (".bin", ".idx"):
            name = f"pybytes{suffix}{ext}"
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name
    assert report["train_docs"] > 0 and report["holdout_docs"] > 0
    assert (build_byte_corpus.VOCAB, build_byte_corpus.OFFSET) == (
        jbc.VOCAB, jbc.OFFSET)


# ---------------------------------------------------------------------------
# quality_run: held-out perplexity, harness, decode agreement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fp32", "int8", "int4"])
def test_heldout_ppl_block_equals_jax(corpus, models, name):
    jqr = jax_script("quality_run")
    cfg_j, cfg_t, pj, pt = models
    hold_j, hold_t = holdouts(jqr, corpus)
    tj, tt = trees(pj, pt, name)
    want = jqr.heldout_ppl_block(tj, cfg_j, jqr.make_dataset(
        hold_j, MAX_LEN, cfg_j.block_length, seed=7), 8, 4)
    got = qr.heldout_ppl_block(tt, cfg_t, qr.make_dataset(
        hold_t, MAX_LEN, cfg_t.block_length, seed=7), 8, 4)
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)


def test_heldout_ppl_vanilla_equals_jax(corpus):
    jqr = jax_script("quality_run")
    kw = dict(vocab_size=qr.VOCAB, max_position_embeddings=MAX_LEN,
              num_heads=2)
    vcfg_j = jax_config.NeoXConfig.from_hidden_layers(64, 2, **kw)
    vcfg_t = torch_config.NeoXConfig.from_hidden_layers(64, 2, **kw)
    pj = jax.device_get(jax_vanilla.init_vanilla_params(
        jax.random.PRNGKey(1), vcfg_j))
    hold_j, hold_t = holdouts(jqr, corpus)
    want = jqr.heldout_ppl_vanilla(pj, vcfg_j, jqr.make_dataset(
        hold_j, MAX_LEN, 1, seed=7), 8, 4)
    got = qr.heldout_ppl_vanilla(bridge.params_from_numpy(pj, "cpu"),
                                 vcfg_t, qr.make_dataset(hold_t, MAX_LEN, 1,
                                                         seed=7), 8, 4)
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)


def test_byte_tasks_docs_equal_jax(corpus):
    jqr = jax_script("quality_run")
    hold_j, hold_t = holdouts(jqr, corpus)
    want, got = jqr.byte_tasks(hold_j), qr.byte_tasks(hold_t)
    assert [t.name for t in got] == [t.name for t in want]
    for g, w in zip(got, want):
        assert g.docs() == w.docs()


@pytest.mark.parametrize("name", ["fp32", "int8"])
def test_run_harness_equals_jax(corpus, models, monkeypatch, name):
    jqr = jax_script("quality_run")
    cfg_j, cfg_t, pj, pt = models
    hold_j, hold_t = holdouts(jqr, corpus)
    tj, tt = trees(pj, pt, name)
    small_tasks(jqr, monkeypatch)
    small_tasks(qr, monkeypatch)
    want = jqr.run_harness(tj, cfg_j, hold_j, MAX_LEN, 4)
    got = qr.run_harness(tt, cfg_t, hold_t, MAX_LEN, 4)
    assert_results_close(got, want)


def test_decode_agreement_equals_jax(corpus, models):
    jqr = jax_script("quality_run")
    cfg_j, cfg_t, pj, pt = models
    hold_j, hold_t = holdouts(jqr, corpus)
    q8j, q8t = trees(pj, pt, "int8")
    mix = dict(bits=8, token_decoder_bits=4, lm_head_bits=8,
               group_size=INT4_GROUP)
    kw = dict(n_prompts=4, prompt_len=32, gen_tokens=8)
    want = jqr.decode_agreement(
        pj, q8j, cfg_j, hold_j,
        params_mixed=jax_quant.quantize_block_transformer(pj, **mix), **kw)
    got = qr.decode_agreement(
        pt, q8t, cfg_t, hold_t,
        params_mixed=quant.quantize_block_transformer(pt, **mix), **kw)
    assert got == want


# ---------------------------------------------------------------------------
# quality_run.main end to end
# ---------------------------------------------------------------------------

def _subscript_path(node):
    """``results["a"]["b"]`` -> ("a", "b")."""
    path = []
    while isinstance(node, ast.Subscript):
        path.insert(0, node.slice.value)
        node = node.value
    return tuple(path)


def jax_report_layout():
    """The JAX script's report keys, from its source: ``main``'s
    ``results`` dict and the keys ``decode_agreement`` writes
    (``scripts/quality_run.py:253-294``, ``:422-466``)."""
    tree = ast.parse((ROOT / "scripts" / "quality_run.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    layout = {}
    for node in ast.walk(fns["main"]):
        if not isinstance(node, ast.Assign):
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name) and tgt.id == "results":
            layout.update({k.value: None for k in node.value.keys})
        elif isinstance(tgt, ast.Subscript) and isinstance(
                node.value, ast.Dict):
            layout[_subscript_path(tgt)[0]] = {
                k.value for k in node.value.keys}
        elif isinstance(tgt, ast.Subscript):
            path = _subscript_path(tgt)
            if len(path) == 1:
                layout.setdefault(path[0], None)
            else:
                layout[path[0]].add(path[1])
    layout["decode_agreement"] = {
        _subscript_path(n.targets[0])[0]
        for n in ast.walk(fns["decode_agreement"])
        if isinstance(n, ast.Assign) and isinstance(n.targets[0],
                                                    ast.Subscript)}
    return layout


def test_quality_run_main_has_the_jax_layout(corpus, tmp_path, monkeypatch):
    """Two train steps of each model, then every phase, on the CPU (the
    harness's tasks and the decode agreement's prompts cut for time)."""
    jqr = jax_script("quality_run")
    names = sorted(t.name for t in jqr.byte_tasks(holdouts(jqr, corpus)[0]))
    small_tasks(qr, monkeypatch)
    monkeypatch.setattr(qr, "decode_agreement", functools.partial(
        qr.decode_agreement, n_prompts=2, prompt_len=32, gen_tokens=8))
    out = tmp_path / "quality"
    report = qr.main(["--cpu", "--corpus", corpus, "--out", str(out),
                      "--steps", "2", "--batch", "2", "--max_length",
                      str(MAX_LEN), "--eval_samples", "4", "--eval_batch",
                      "4"])
    layout = jax_report_layout()
    assert sorted(report) == sorted(layout)
    for key, sub in layout.items():
        if sub is not None:
            assert sorted(report[key]) == sorted(sub), key
    for variant, results in report["harness"].items():
        assert sorted(results) == names, variant
    assert (report["block_checkpoint_step"],
            report["vanilla_checkpoint_step"]) == (2, 2)
    with open(out / "quality.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert "INT8 gate" in (out / "QUALITY.md").read_text()
    for name in ("block_main_b4_5", "vanilla_31"):
        assert (out / name / "checkpoint-2" / "state.pt").exists()
    assert all(np.isfinite(v) for v in report["ppl"].values())
    assert os.path.exists(out / "block_main_b4_5" / "metrics.jsonl")
    assert not torch.backends.cuda.matmul.allow_tf32
