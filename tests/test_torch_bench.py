"""The port's benchmark (``block_transformer_tpu_torch/bench.py``) against
the JAX benchmark (``bench.py``), on the CPU, at a tiny size: a block model
of hidden 64 and one layer a stack, a vanilla baseline of hidden 64 and one
layer (every named config is the tiny one on both sides, vocab 50304: the
benchmark draws ids up to 50254), the same JAX-initialised float32
parameters on both sides (``bridge.py``; both sides' random inits return
that tree, whatever dtype they ask for). The JAX benchmark runs as the JAX
tests run it, its persistent compilation cache under ``tmp_path``. Every
case takes one timed rep (``BT_BENCH_REPS=1``) and no stage decomposition
(``BT_BENCH_DECOMP=0``) but the decomposition's own cases.

Held equal (tokens and keys are exact; no figure is compared, they are
timings):
- ``_quant_kwargs`` for every ``--quantize`` x ``BT_SKIP_QUANT_HEAD`` x
  ``BT_INT4_GROUP`` set or not;
- ``bench_block`` for each KV cache: what ``generate_blocks`` is called
  with (ids, masks, ``max_blocks``, ``greedy``, ``kv_cache``), its greedy
  tokens, the batch and the detail's keys (below 16 rows both record that
  no decomposition ran);
- the decomposition's fallback: one out-of-memory error halves the probe
  batch and is recorded as JAX records its error; any other error raises;
- ``bench_vanilla``: the ``quantize_model_params`` tree, and the greedy
  tokens of every step, against JAX's prefill and decode steps run alone,
  whose last token is the one JAX's ``full_generate`` returns;
- ``main``: the JSON line's ``metric`` and whether ``vs_baseline`` is a
  number or null, the detail file's tree of keys; it is written to the
  path given alone, and no benchmark file appears at the repository's root;
- ``bench_engine``, through ``main --engine`` (the contiguous INT8 cache)
  and ``main --engine_only --engine_kv paged``, both rows (throughput and
  latency mode), a dispatch a block (``BT_ENGINE_SYNC_BLOCKS=1``): the
  engines' keyword arguments (the paged pool's size among them), every
  request's tokens, the latency keys, dispatches and wasted tokens.
"""

import contextlib
import hashlib
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from block_transformer_tpu import config as jax_config
from block_transformer_tpu.inference import engine as jax_engine
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.models import vanilla as jax_vanilla
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bench
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch import profile_generate as pg
from block_transformer_tpu_torch.inference import engine as torch_engine
from block_transformer_tpu_torch.inference import generate as gen
from block_transformer_tpu_torch.models import vanilla
from block_transformer_tpu_torch.ops import quant
from block_transformer_tpu_torch.scripts import mixed48_stage_probe
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.utils import roofline

ROOT = Path(__file__).resolve().parents[1]
HIDDEN, LAYERS = 64, 1
BATCH, PREFILL, DECODE = 2, 32, 8


# the JAX runs' helpers of tests/test_torch_scripts_probes.py, copied: that
# module's imports cost the collection of this one ~20 s


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side in one intra-op thread (tiny models are launch-bound;
    parallel test workers would oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def jax_cache_in(path):
    """JAX config updates inside: the persistent compilation cache goes to
    ``path`` and platform updates are dropped; the cache settings are put
    back after."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    real = jax.config.update

    def update(k, v):
        if k == "jax_platforms":
            return
        real(k, str(path) if k == "jax_compilation_cache_dir" else v)

    jax.config.update = update
    try:
        yield
    finally:
        jax.config.update = real
        for k, v in saved.items():
            real(k, v)


def run_jax_main(monkeypatch, module, argv, path):
    with jax_cache_in(path), monkeypatch.context() as mp:
        mp.setenv("JAX_CACHE_DIR", str(path))
        mp.setattr(sys, "argv", [module.__name__, *map(str, argv)])
        return module.main()


def tiny_block(package):
    return package.make_block_config("t", HIDDEN, LAYERS)


def tiny_vanilla(package):
    return package.NeoXConfig.from_hidden_layers(HIDDEN, LAYERS, num_heads=2)


def use_tiny_configs(monkeypatch):
    """Every named config is the tiny one on both sides (vocab 50304)."""
    for package in (jax_config, torch_config):
        monkeypatch.setattr(package, "get_config",
                            lambda name, package=package, **k:
                            tiny_block(package))
        monkeypatch.setattr(package, "get_vanilla_config",
                            lambda name, package=package, **k:
                            tiny_vanilla(package))


def use_params(monkeypatch, pj, vj):
    """Both sides' random inits return the float32 trees ``pj`` (block) and
    ``vj`` (vanilla), whatever dtype the benchmark asks for."""
    monkeypatch.setattr(jax_bt, "init_block_transformer_params",
                        lambda key, cfg, dtype=None: jax.tree.map(
                            jnp.asarray, pj))
    monkeypatch.setattr(bt, "init_block_transformer_params",
                        lambda g, cfg, dtype=None, device="cpu":
                        bridge.params_from_numpy(pj, device))
    monkeypatch.setattr(jax_vanilla, "init_vanilla_params",
                        lambda key, cfg, dtype=None: jax.tree.map(
                            jnp.asarray, vj))
    monkeypatch.setattr(vanilla, "init_vanilla_params",
                        lambda g, cfg, dtype=None, device="cpu":
                        bridge.params_from_numpy(vj, device))


@pytest.fixture(autouse=True)
def one_rep(monkeypatch):
    monkeypatch.setenv("BT_BENCH_REPS", "1")
    monkeypatch.setenv("BT_BENCH_DECOMP", "0")


@pytest.fixture(scope="module")
def trees():
    """(JAX block parameters, JAX vanilla parameters), float32, numpy."""
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(0), tiny_block(jax_config)))
    vj = jax.device_get(jax_vanilla.init_vanilla_params(
        jax.random.PRNGKey(1), tiny_vanilla(jax_config)))
    return pj, vj


@pytest.fixture
def tiny(monkeypatch, trees):
    use_tiny_configs(monkeypatch)
    use_params(monkeypatch, *trees)


def jax_call(tmp_path, fn, *args, **kw):
    with jax_cache_in(tmp_path):
        return fn(*args, **kw)


def leaves(tree, path=()) -> dict:
    """{path of keys: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    return {p: leaf for k, v in items for p, leaf in leaves(
        v, path + (k,)).items()}


def key_tree(d):
    return {k: key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


# ---------------------------------------------------------------------------
# _quant_kwargs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [None, "32"])
@pytest.mark.parametrize("skip_head", [False, True])
@pytest.mark.parametrize("quantize", ["int8", "int4", "mixed48"])
def test_quant_kwargs_equal_jax(monkeypatch, quantize, skip_head, group):
    if group is None:
        monkeypatch.delenv("BT_INT4_GROUP", raising=False)
    else:
        monkeypatch.setenv("BT_INT4_GROUP", group)
    assert bench._quant_kwargs(quantize, skip_head) == \
        jax_bench._quant_kwargs(quantize, skip_head)


# ---------------------------------------------------------------------------
# bench_block
# ---------------------------------------------------------------------------

def spy_generate(monkeypatch):
    """{side: [(ids, attention mask, block mask, keywords, tokens)]} of
    every ``generate_blocks`` call (the port's ``device`` left out)."""
    calls = {"jax": [], "port": []}
    real_j, real_t = jax_gen.generate_blocks, gen.generate_blocks

    def jax_spy(params, cfg, ids, att, bam, **kw):
        res = real_j(params, cfg, ids, att, bam, **kw)
        calls["jax"].append((*map(np.asarray, (ids, att, bam)), kw,
                             np.asarray(res.tokens)))
        return res

    def port_spy(params, cfg, ids, att, bam, *, device, **kw):
        res = real_t(params, cfg, ids, att, bam, device=device, **kw)
        calls["port"].append((*(t.cpu().numpy() for t in (ids, att, bam)),
                              kw, res.tokens.cpu().numpy()))
        return res

    monkeypatch.setattr(jax_gen, "generate_blocks", jax_spy)
    monkeypatch.setattr(gen, "generate_blocks", port_spy)
    return calls


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_bench_block_equals_jax(monkeypatch, tmp_path, tiny, kv):
    monkeypatch.setenv("BT_BENCH_DECOMP", "1")    # below 16 rows: none runs
    calls = spy_generate(monkeypatch)
    args = ("m", BATCH, PREFILL, DECODE, "bfloat16", "int8", kv)
    _, b_j, d_j = jax_call(tmp_path, jax_bench.bench_block, *args)
    tps, b_t, d_t = bench.bench_block(*args, device="cpu")
    assert b_t == b_j == BATCH and tps > 0
    assert sorted(d_t) == sorted(d_j)
    assert d_t["decomposition_error"] == d_j["decomposition_error"] == \
        "all probe batches failed"
    assert d_t["reps"] == d_j["reps"] == 1
    assert len(calls["port"]) == len(calls["jax"]) == 2   # warm-up, a rep
    for got, want in zip(calls["port"], calls["jax"]):
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3] == {"max_blocks": (PREFILL + DECODE) // 4,
                                     "greedy": True, "kv_cache": kv}
        np.testing.assert_array_equal(got[4], want[4])


def stub_generate(monkeypatch):
    """Both sides' ``generate_blocks`` return the prompt as the tokens: the
    decomposition's cases time nothing."""
    monkeypatch.setattr(jax_gen, "generate_blocks", lambda params, cfg, ids,
                        *a, **k: jax_gen.GenerationResult(ids, 0, ids[:, 0, 0]))
    monkeypatch.setattr(gen, "generate_blocks", lambda params, cfg, ids, *a,
                        **k: gen.GenerationResult(ids, 0, ids[:, 0, 0]))


def fake_decomposition(calls, error):
    """A decomposition that raises ``error`` at its first call and returns
    fixed stage times after; records each call's batch."""
    def run(params, cfg, batch, *a, **k):
        calls.append(batch)
        if len(calls) == 1:
            raise error
        return {"prefill_ms": 2.0, "token_decoder_ms_per_block_step": 1.0,
                "block_decoder_ms_per_block_step": 0.5}
    return run


def test_decomposition_falls_back_on_out_of_memory(monkeypatch, tmp_path,
                                                   tiny):
    monkeypatch.setenv("BT_BENCH_DECOMP", "1")
    msg = "out of memory at 32 rows"
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jax_bench, "_two_level_decomposition",
                        fake_decomposition(seen["jax"], RuntimeError(msg)))
    monkeypatch.setattr(bench, "_two_level_decomposition", fake_decomposition(
        seen["port"], torch.cuda.OutOfMemoryError(msg)))
    stub_generate(monkeypatch)
    args = ("m", 32, 16, 4, "bfloat16", "int8", "int8")
    _, _, d_j = jax_call(tmp_path, jax_bench.bench_block, *args)
    _, _, d_t = bench.bench_block(*args, device="cpu")
    assert seen["port"] == seen["jax"] == [32, 16]
    assert d_t["decomposition_fallbacks"] == d_j["decomposition_fallbacks"] \
        == [{"batch": 32, "error": msg}]
    for key in ("decomposition_batch", "prefill_ms",
                "token_decoder_ms_per_block_step",
                "block_decoder_ms_per_block_step"):
        assert d_t[key] == d_j[key]
    assert "decomposition_error" not in d_t
    # the MFU fields come from the port's roofline at the probe batch
    summary = roofline.mfu_summary(
        torch_config.get_config("m"), batch=16, prefill=16, decode=4,
        kv_cache="int8", quantize="int8", bd_ms=0.5, td_ms=1.0,
        prefill_ms=2.0)
    assert {k: d_t[k] for k in summary} == summary


def test_decomposition_raises_any_other_error(monkeypatch, tiny):
    monkeypatch.setenv("BT_BENCH_DECOMP", "1")
    seen = []
    monkeypatch.setattr(bench, "_two_level_decomposition", fake_decomposition(
        seen, RuntimeError("a kernel failed to launch")))
    stub_generate(monkeypatch)
    with pytest.raises(RuntimeError, match="failed to launch") as err:
        bench.bench_block("m", 32, 16, 4, "bfloat16", "int8", "int8",
                          device="cpu")
    assert not isinstance(err.value, torch.cuda.OutOfMemoryError)
    assert seen == [32]


def test_bench_block_runs_the_decomposition_at_16_rows(monkeypatch, tiny):
    monkeypatch.setenv("BT_BENCH_DECOMP", "1")
    monkeypatch.setattr(bench, "ITERS", 2)
    _, batch, d = bench.bench_block("m", 16, 16, 8, "bfloat16", "int8",
                                    "int8", device="cpu")
    assert batch == d["decomposition_batch"] == 16
    assert "decomposition_error" not in d
    for key in ("prefill_ms", "token_decoder_ms_per_block_step",
                "block_decoder_ms_per_block_step", "mfu_decode",
                "hbm_util_decode", "mfu_prefill", "mfu_decode_headline"):
        assert np.isfinite(d[key]), key
    assert not any(k.startswith("device_") for k in d)    # the CPU


# ---------------------------------------------------------------------------
# _two_level_decomposition (the one copy: the stage probe runs it)
# ---------------------------------------------------------------------------

def test_the_stage_probe_runs_the_benchmarks_decomposition():
    assert mixed48_stage_probe._two_level_decomposition is \
        bench._two_level_decomposition


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_decomposition_runs_for_every_cache_kind(trees, kv):
    cfg = tiny_block(torch_config)
    params = bridge.params_from_numpy(trees[0], "cpu")
    d = bench._two_level_decomposition(params, cfg, batch=2, prefill=32,
                                       decode=16, dtype=torch.float32,
                                       kv_cache=kv, iters=2)
    assert sorted(d) == sorted(["prefill_ms", "token_decoder_ms_per_block_step",
                                "block_decoder_ms_per_block_step"])
    assert d["token_decoder_ms_per_block_step"] > 0
    assert d["block_decoder_ms_per_block_step"] >= 0


# ---------------------------------------------------------------------------
# bench_vanilla
# ---------------------------------------------------------------------------

def jax_greedy(params, cfg, ids, decode, kv):
    """JAX's ``full_generate`` a step a call: [B, decode + 1] tokens."""
    cache = jax_neox.make_kv_cache(cfg, ids.shape[0], ids.shape[1] + decode,
                                   kv, dtype=jnp.bfloat16)
    prefill = jax.jit(lambda p, i, c: jax_vanilla.vanilla_prefill(p, cfg, i, c))
    step = jax.jit(lambda p, t, c: jax_vanilla.vanilla_decode_step(p, cfg, t,
                                                                   c))
    logits, cache = prefill(params, ids, cache)
    out = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for _ in range(decode):
        logits, cache = step(params, out[-1], cache)
        out.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return np.stack([np.asarray(t) for t in out], 1)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_bench_vanilla_equals_jax(monkeypatch, tmp_path, tiny, trees, kv):
    asked = {"jax": [], "port": []}
    port_trees, port_tokens, jax_final = [], [], []
    real_qj, real_qt = jax_quant.quantize_model_params, \
        quant.quantize_model_params
    real_gen, real_ready = pg.vanilla_generate, jax.block_until_ready

    def jax_q(params, **kw):
        asked["jax"].append(kw)
        return real_qj(params, **kw)

    def port_q(params, **kw):
        asked["port"].append(kw)
        port_trees.append(real_qt(params, **kw))
        return port_trees[-1]

    monkeypatch.setattr(jax_quant, "quantize_model_params", jax_q)
    monkeypatch.setattr(quant, "quantize_model_params", port_q)
    monkeypatch.setattr(pg, "vanilla_generate", lambda *a, **k: (
        port_tokens.append(real_gen(*a, **k)) or port_tokens[-1]))
    args = ("v", BATCH, PREFILL, DECODE, "bfloat16", "int8", kv)
    with monkeypatch.context() as mp:
        mp.setattr(jax, "block_until_ready",
                   lambda x: jax_final.append(np.asarray(real_ready(x))) or x)
        _, b_j, d_j = jax_call(tmp_path, jax_bench.bench_vanilla, *args)
    tps, b_t, d_t = bench.bench_vanilla(*args, device="cpu")
    assert b_t == b_j == BATCH and tps > 0
    assert sorted(d_t) == sorted(d_j)
    assert (d_t["quantize"], d_t["kv_cache"]) == ("int8", kv)
    assert asked["port"] == asked["jax"] == [{"bits": 8, "group_size": 128}]
    cfg_j = tiny_vanilla(jax_config)
    qj = jax_quant.quantize_model_params(jax.tree.map(jnp.asarray, trees[1]),
                                         **asked["jax"][0])
    want_tree = bridge.params_from_numpy(jax.device_get(qj), "cpu")
    got_leaves, want_leaves = leaves(port_trees[0]), leaves(want_tree)
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, leaf in got_leaves.items():
        assert torch.equal(leaf, want_leaves[path]), path
    ids = np.random.default_rng(0).integers(1, 50254, size=(BATCH, PREFILL))
    want = jax_greedy(qj, cfg_j, jnp.asarray(ids, jnp.int32), DECODE, kv)
    assert len(jax_final) == len(port_tokens) == 2       # warm-up, a rep
    for final, tokens in zip(jax_final, port_tokens):
        np.testing.assert_array_equal(want[:, -1], final)
        np.testing.assert_array_equal(tokens.numpy(), want)


# ---------------------------------------------------------------------------
# bench_engine
# ---------------------------------------------------------------------------

def spy_engines(monkeypatch, module, made):
    """Every engine ``module`` builds: (its keyword arguments, itself)."""
    real = module.ContinuousBatchingEngine

    class Spy(real):
        def __init__(self, *args, **kw):
            made.append((kw, self))
            super().__init__(*args, **kw)

    monkeypatch.setattr(module, "ContinuousBatchingEngine", Spy)


def served(eng):
    return sorted((r.uid, [int(t) for t in r.generated], r.error)
                  for r in eng.completed)


def check_engines(made, detail_t, detail_j, kv):
    """Both engine rows of ``main --engine`` (throughput, then latency
    mode): the engines' keyword arguments, every request's tokens, and
    the rows' keys and counts, the port's against JAX's."""
    assert len(made["port"]) == len(made["jax"]) == 2
    rows_t = (detail_t, detail_t["latency_mode_row"])
    rows_j = (detail_j, detail_j["latency_mode_row"])
    for (kw_t, eng_t), (kw_j, eng_j), row_t, row_j in zip(
            made["port"], made["jax"], rows_t, rows_j):
        assert kw_t.pop("device") == "cpu"
        assert kw_t == kw_j and kw_j["kv_cache"] == kv
        assert ("pool_pages" in kw_j) == (kv == "paged")
        assert served(eng_t) == served(eng_j)
        assert len(eng_t.completed) == 4 and all(
            len(r.generated) == DECODE for r in eng_t.completed)
        for key in ("engine_tokens", "dispatches", "tokens_wasted", "reps",
                    "n_slots", "latency_mode"):
            assert row_t[key] == row_j[key], key
        assert sorted(row_t["latency"]) == sorted(row_j["latency"])
        assert row_t["latency"]["completed"] == 2
    assert made["port"][1][0]["latency_mode"] is True


def test_full_pool_pages_is_the_jax_benchmarks_pool():
    cfg = tiny_block(torch_config)
    for n_slots, max_blocks in ((2, 12), (16, 546), (3, 40)):
        cap = max_blocks * cfg.n_embedding_tokens
        cap = -(-cap // 128) * 128 if cap >= 128 else cap
        ps = min(256, cap)
        want = n_slots * ((-(-cap // ps) * ps) // ps) + 1
        assert pg.full_pool_pages(cfg, n_slots, max_blocks) == want


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

ROOT_FILES = ("BENCHMARK.json", "BENCH_DETAIL.json")


def root_state():
    return {name: hashlib.sha256((ROOT / name).read_bytes()).hexdigest()
            if (ROOT / name).exists() else None for name in ROOT_FILES}


def last_json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# the engine rows serve the contiguous INT8 cache (--kv's) with --engine,
# the paged pool (sized to the work) with --engine_only, a dispatch a block
@pytest.mark.parametrize("flags", [
    [], ["--engine"], ["--engine", "--engine_only", "--engine_kv", "paged"]],
    ids=["static", "engine", "engine_only"])
def test_main_equals_jax(monkeypatch, tmp_path, capsys, tiny, flags):
    before = root_state()
    monkeypatch.setenv("BT_ENGINE_SYNC_BLOCKS", "1")
    made = {"jax": [], "port": []}
    spy_engines(monkeypatch, jax_engine, made["jax"])
    spy_engines(monkeypatch, torch_engine, made["port"])
    argv = ["--model", "m", "--vanilla", "v", "--batch", str(BATCH),
            "--prefill", str(PREFILL), "--decode", str(DECODE),
            "--engine_slots", "2", *flags]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    run_jax_main(monkeypatch, jax_bench,
                 [*argv, "--detail_out", jax_dir / "detail.json"],
                 tmp_path / "cache")
    want = last_json_line(capsys)
    record = bench.main([*argv, "--cpu", "--detail_out",
                         str(port_dir / "detail.json")])
    got = last_json_line(capsys)
    assert got == record["line"]
    assert got["metric"] == want["metric"]
    assert got["unit"] == want["unit"] == "tok/s"
    if "--engine_only" in flags:
        assert got["vs_baseline"] is want["vs_baseline"] is None
    else:
        assert got["vs_baseline"] > 0 and want["vs_baseline"] > 0
    assert got["value"] > 0
    with open(jax_dir / "detail.json") as f:
        want_detail = json.load(f)
    with open(port_dir / "detail.json") as f:
        assert json.load(f) == json.loads(json.dumps(record["detail"]))
    assert key_tree(record["detail"]) == key_tree(want_detail)
    if "--engine" in flags:
        check_engines(made, record["detail"]["engine"], want_detail["engine"],
                      "paged" if "paged" in flags else "int8")
    else:
        assert not made["port"] and not made["jax"]
    assert os.listdir(port_dir) == ["detail.json"]
    assert root_state() == before and not (ROOT / "BENCHMARK.json").exists()


def test_main_writes_its_detail_under_build_by_default():
    assert bench.DETAIL_OUT == os.path.join("build", "BENCH_DETAIL.json")
    assert "build/" in (ROOT / ".gitignore").read_text().splitlines()


def test_main_refuses_to_run_without_a_card_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(["--batch", "2", "--detail_out",
                    str(tmp_path / "detail.json")])
    assert not (tmp_path / "detail.json").exists()
