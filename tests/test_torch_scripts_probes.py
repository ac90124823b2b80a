"""The port's ten speed probes (``block_transformer_tpu_torch/scripts/``:
``w8a8_probe``, ``w8a8_probe2``, ``w8a8_probe3``, ``int4kv_probe``,
``kernel_microbench``, ``prefill_profile``, ``mixed48_stage_probe``,
``paged_admit_probe``, ``engine_cpu_ratio``, ``w8a8_decode_gate``) against
the JAX package's ``scripts/``, on the CPU, at tiny sizes: module
constants patched on both sides, a block model of hidden 64 and one layer
a stack where a script builds one (the named config swapped for it on both
sides, the same JAX-initialised parameters through ``bridge.py``). The JAX
scripts are imported, and run, with their persistent compilation cache
pointed at ``tmp_path``.

Tolerances:
- The W8A8 probes' bodies on the same numpy inputs in float32: the port's
  bodies return x's dtype where JAX's return bf16, so each port output is
  rounded to bf16 and held to JAX's within one bf16 step (2^-8 relative;
  two for ``w8a8_probe2``'s bf16 body, rounded twice in JAX); W8A8's
  quantized activations and scales, the W8A8 outputs and
  ``int8_pure_body`` bit for bit; the chains (JAX's run op by op, where
  division is IEEE: under ``jit`` XLA multiplies by a reciprocal) within
  1e-5 relative.
- ``int4kv_probe``'s three chains (10 steps over 8 slots, so the writes
  wrap): outputs within 1e-5 relative; after one step (its write quantizes
  the same q on both sides; later ones each side's own attention output)
  the INT8 cache's values and scales bit for bit, the INT4 cache's
  dequantized values equal.
- ``kernel_microbench``: ``--cpu_interpret`` gives JAX's op rows, each with
  the port's three variants; each variant's output within 1e-5 relative of
  JAX's Pallas kernel (interpret) on the port's own draws; K2's bound
  counts only the cache rows the mask lets the query see.
- ``prefill_profile``: each stage's output (read by a spy on each side)
  within 1e-4 of max|JAX| in float32 (the INT8 cache's quantization may
  move a value by one step where it sits on a rounding boundary); the bf16
  KV stage and the matmul floor, bf16 on both sides, within 2^-6.
- ``mixed48_stage_probe``: the port's benchmark's
  ``_two_level_decomposition`` (which the probe runs) has ``bench.py``'s
  keys; each stage's outputs (read by spies) equal JAX's: the token
  stage's sum of greedy tokens exactly, the block and prefill stages
  within 1e-4 relative.
- ``paged_admit_probe``: the paged engine's greedy tokens equal JAX's; an
  admit inside ``paged_probe_nocopy()`` leaves the pool unchanged, one
  outside copies the prompt in; the report has JAX's keys.
- ``engine_cpu_ratio`` and ``w8a8_decode_gate``: JAX's report keys, greedy
  tokens equal (the static batch, and the gate's W8A8-off decode), fp32
  scores within 1e-4 relative (as ``test_decode_gate_equals_jax``).
"""

import contextlib
import importlib
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
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.ops import decode_attention as jax_da
from block_transformer_tpu.ops import dequant_matmul as jax_dm
from block_transformer_tpu.ops import flash_attention as jax_fa
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bench as torch_bench
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import engine as torch_engine
from block_transformer_tpu_torch.inference import generate as gen
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.ops import quant
from block_transformer_tpu_torch.scripts import (
    engine_cpu_ratio, int4kv_probe, kernel_microbench, paged_admit_probe,
    prefill_profile, w8a8_decode_gate)
from block_transformer_tpu_torch.utils import profiling, roofline
from tests.test_torch_scripts_gates import (  # noqa: F401 (fixtures)
    GEN_TOKENS, PROMPT_LEN, checkpoints, corpus, jax_decode, jax_fp32_lp,
    jax_prompts)
from tests.test_torch_scripts_quality import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
HIDDEN, LAYERS = 64, 1
BF16_STEP = 2.0 ** -8


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


def jax_probe(name, path):
    with jax_cache_in(path):
        return importlib.import_module(f"scripts.{name}")


def port_probe(name):
    return importlib.import_module(
        f"block_transformer_tpu_torch.scripts.{name}")


def run_jax_main(monkeypatch, module, argv, path):
    with jax_cache_in(path), monkeypatch.context() as mp:
        mp.setenv("JAX_CACHE_DIR", str(path))
        mp.setattr(sys, "argv", [module.__name__, *map(str, argv)])
        return module.main()


def close(got, want, rtol=RTOL):
    """Within ``rtol`` of max|want|, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max(), scale)


def tiny_block(package, vocab_size=50304, **kw):
    return package.make_block_config("t", HIDDEN, LAYERS,
                                     vocab_size=vocab_size, **kw)


def use_tiny_configs(monkeypatch, **over):
    for package in (jax_config, torch_config):
        monkeypatch.setattr(package, "get_config",
                            lambda name, package=package, **k: tiny_block(
                                package, **{**over, **k}))


@pytest.fixture(scope="module")
def tiny_params():
    """(JAX config, port config, JAX float32 parameters, the bridged
    copy), vocab 50304 (the scripts draw ids up to 50254)."""
    cfg_j, cfg_t = tiny_block(jax_config), tiny_block(torch_config)
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(0), cfg_j))
    return cfg_j, cfg_t, pj, bridge.params_from_numpy(pj, "cpu")


def use_params(monkeypatch, pj):
    """Both sides' random inits return the float32 tree ``pj``, whatever
    dtype the script asks for."""
    monkeypatch.setattr(jax_bt, "init_block_transformer_params",
                        lambda key, cfg, dtype=None: jax.tree.map(
                            jnp.asarray, pj))
    monkeypatch.setattr(bt, "init_block_transformer_params",
                        lambda g, cfg, dtype=None, device="cpu":
                        bridge.params_from_numpy(pj, device))


def bf16_close(got: torch.Tensor, want, steps: int = 1):
    """The port's output rounded to bf16 against JAX's bf16 output: within
    ``steps`` bf16 steps of each element's magnitude."""
    g = got.to(torch.bfloat16).float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.all(np.abs(g - w) <= steps * BF16_STEP * np.abs(w) + 1e-30)


# ---------------------------------------------------------------------------
# w8a8_probe, w8a8_probe2, w8a8_probe3
# ---------------------------------------------------------------------------

def w8a8_draws(M, K, N, w_scale=1.0, w_mul=16):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * w_scale).astype(np.float32)
    w_q = np.clip(np.round(w * w_mul), -127, 127).astype(np.int8)
    return x, w, w_q


def jax_w8a8_quant(x):
    """The probes' activation quantization, op by op."""
    amax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    sx = (amax.astype(jnp.float32) / 127.0) + 1e-12
    return jnp.round(x.astype(jnp.float32) / sx).astype(jnp.int8), sx[:, 0]


@pytest.mark.parametrize("probe", ["w8a8_probe", "w8a8_probe3"])
def test_w8a8_probe_bodies_equal_jax(probe, monkeypatch, tmp_path):
    jm, pm = jax_probe(probe, tmp_path), port_probe(probe)
    M, K, N = 16, 32, 64
    for m in (jm, pm):
        monkeypatch.setattr(m, "M", M)
        monkeypatch.setattr(m, "ITERS", 3)
        if probe == "w8a8_probe":
            monkeypatch.setattr(m, "K", K)
            monkeypatch.setattr(m, "N", N)
    x, w, w_q = w8a8_draws(M, K, N)
    s = np.full((N,), 1 / 16.0, np.float32)
    xq, sx = jax_w8a8_quant(jnp.asarray(x))
    from block_transformer_tpu_torch.kernels import w8a8
    txq, tsx = w8a8.w8a8_quant(torch.as_tensor(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx))
    for body, wa in (("bf16_body", w), ("convert_body", w_q),
                     ("w8a8_body", w_q)):
        args_j = (jnp.asarray(x), jnp.asarray(wa), jnp.asarray(s))
        args_t = tuple(torch.as_tensor(a) for a in (x, wa, s))
        want = getattr(jm, body)(*args_j)
        got = getattr(pm, body)(*args_t)
        if body == "w8a8_body":         # identical float32, one rounding
            np.testing.assert_array_equal(
                got.to(torch.bfloat16).float().numpy(),
                np.asarray(want.astype(jnp.float32)))
        else:
            bf16_close(got, want)
        with jax.disable_jit():
            chain_j = np.asarray(jm.chain(getattr(jm, body))(*args_j))
        close(pm.chain(getattr(pm, body))(*args_t).numpy(), chain_j)


def test_w8a8_probe2_bodies_equal_jax(monkeypatch, tmp_path):
    jm, pm = jax_probe("w8a8_probe2", tmp_path), port_probe("w8a8_probe2")
    M, K = 16, 32
    for m in (jm, pm):
        monkeypatch.setattr(m, "M", M)
        monkeypatch.setattr(m, "K", K)
        monkeypatch.setattr(m, "ITERS", 3)
    x, w, w_q = w8a8_draws(M, K, K, w_scale=0.01, w_mul=1600)
    xq = np.clip(np.round(x * 16), -127, 127).astype(np.int8)
    bf16_close(pm.bf16_body(torch.as_tensor(x), torch.as_tensor(w)),
               jm.bf16_body(jnp.asarray(x), jnp.asarray(w)), steps=2)
    got = pm.w8a8_body(torch.as_tensor(x), torch.as_tensor(w_q))
    want = jm.w8a8_body(jnp.asarray(x), jnp.asarray(w_q))
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    for steps in (1, 3):                # the body, then a chain of three
        monkeypatch.setattr(jm, "ITERS", steps)
        monkeypatch.setattr(pm, "ITERS", steps)
        want = jm.chain(jm.int8_pure_body)(jnp.asarray(xq), jnp.asarray(w_q))
        got = pm.chain(pm.int8_pure_body)(torch.as_tensor(xq),
                                          torch.as_tensor(w_q))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# int4kv_probe
# ---------------------------------------------------------------------------

def test_int4kv_chains_equal_jax(monkeypatch, tmp_path):
    jm = jax_probe("int4kv_probe", tmp_path)
    B, H, CAP, D, ITERS = 2, 2, 8, 16, 10
    for m in (jm, int4kv_probe):
        for k, v in dict(B=B, H=H, CAP=CAP, D=D, ITERS=ITERS).items():
            monkeypatch.setattr(m, k, v)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    Kf = rng.standard_normal((B, H, CAP, D)).astype(np.float32)
    Vf = rng.standard_normal((B, H, CAP, D)).astype(np.float32)
    scales = np.full((B, H, CAP), 0.02, np.float32)

    def ints(a, mul, lim):
        return np.clip(np.round(a * mul), -lim, lim).astype(np.int8)

    T = torch.as_tensor
    with jax.disable_jit():
        want = jm.chain_bf16()(jnp.asarray(q), jnp.asarray(Kf),
                               jnp.asarray(Vf))
    close(int4kv_probe.chain_bf16()(T(q), T(Kf.copy()), T(Vf)).numpy(),
          np.asarray(want))

    written = []
    real_dus = jax.lax.dynamic_update_slice

    def dus(operand, update, idx):
        out = real_dus(operand, update, idx)
        written.append(out)
        return out

    packed = []
    real_pack = quant.pack_kv_int4

    def pack(v):
        out = real_pack(v)
        packed.append(out)
        return out

    monkeypatch.setattr(jax.lax, "dynamic_update_slice", dus)
    monkeypatch.setattr(quant, "pack_kv_int4", pack)
    for qdtype, tdtype, qmax, mul, lim in (
            (jnp.int8, torch.int8, 127.0, 50, 127),
            (jnp.int4, torch.uint8, 7.0, 3.5, 7)):
        k, v = ints(Kf, mul, lim), ints(Vf, mul, lim)
        # ITERS steps: the outputs; one step (its write quantizes the same
        # q on both sides; later steps quantize each side's own attention
        # output): the cache bit for bit
        for steps in (ITERS, 1):
            monkeypatch.setattr(jm, "ITERS", steps)
            monkeypatch.setattr(int4kv_probe, "ITERS", steps)
            written.clear()
            packed.clear()
            with jax.disable_jit():
                want = jm.chain_quant(qdtype, qmax)(
                    jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(scales), jnp.asarray(scales))
            K_t, ks_t = T(k.copy()), T(scales.copy())
            got = int4kv_probe.chain_quant(tdtype, qmax)(
                T(q), K_t, T(v), ks_t, T(scales.copy()))
            close(got.numpy(), np.asarray(want))
        K_j = [w for w in written if w.ndim == 4][-1]
        ks_j = np.asarray([w for w in written if w.ndim == 3][-1])
        np.testing.assert_array_equal(ks_t.numpy(), ks_j)
        if tdtype == torch.int8:
            np.testing.assert_array_equal(K_t.numpy(), np.asarray(K_j))
        else:                   # the cache packs K first: its final state
            np.testing.assert_array_equal(
                quant.dequantize_kv(packed[0], ks_t, torch.float32).numpy(),
                np.asarray(K_j.astype(jnp.float32)) * ks_j[..., None])


# ---------------------------------------------------------------------------
# kernel_microbench
# ---------------------------------------------------------------------------

def test_microbench_cpu_interpret_rows_equal_jax(monkeypatch, tmp_path):
    jm = jax_probe("kernel_microbench", tmp_path)
    run_jax_main(monkeypatch, jm, ["--cpu_interpret", "--out",
                                   tmp_path / "jax.json"], tmp_path)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)["results"]
    got = kernel_microbench.main(["--cpu_interpret", "--out",
                                  str(tmp_path / "port.json")])
    ops = list(dict.fromkeys(r["op"] for r in want))
    assert list(dict.fromkeys(r["op"] for r in got["results"])) == ops
    for op in ops:
        assert [r["variant"] for r in got["results"] if r["op"] == op] == [
            "kernel", "plain", "library"]
    for r in got["results"]:
        assert {"op", "variant", "us", "GB/s", "TFLOP/s"} <= set(r)
    assert got["platform"] == "cpu"


@pytest.mark.parametrize("kind", ["int8", "int4", "decode", "flash"])
def test_microbench_variants_equal_jax(kind):
    """The port's draws go to JAX's Pallas kernels (interpret) and to each
    of the port's variants."""
    mb = kernel_microbench
    f32 = torch.float32
    if kind in ("int8", "int4"):
        L, M, K, N = 2, 8, 256, 128
        if kind == "int8":
            got = mb.int8_matmul_inputs(L, M, K, N, f32, "cpu")
            variants = mb.int8_matmul_variants(*got)
            ref = jax_dm.int8_matmul_stacked
        else:
            got = mb.int4_matmul_inputs(L, M, K, N, f32, "cpu")
            variants = mb.int4_matmul_variants(*got)
            ref = jax_dm.int4_matmul_stacked
        assert got[1].shape == (L, K if kind == "int8" else K // 2, N)
        for i in range(L):
            want = np.asarray(ref(*(jnp.asarray(a.numpy()) for a in got), i,
                                  interpret=True))
            for call in variants.values():
                close(call(got[0], i).numpy(), want)
    elif kind == "decode":
        L, B, H, cap, D, S = 2, 2, 2, 128, 64, 1
        q0, kq, ks, vq, vs, mask = mb.decode_attention_inputs(
            L, B, H, cap, D, S, f32, "cpu")
        valid = cap - 64
        kv_valid = jnp.asarray((np.arange(cap)[None] < valid).astype(
            np.int32).repeat(B, 0))
        jmask = jax_masks.decode_mask(jnp.int32(valid - S), cap, S, kv_valid)
        variants = mb.decode_attention_variants(kq, ks, vq, vs, mask, f32)
        for i in range(L):
            want = np.asarray(jax_da.decode_attention_int8_stacked(
                *(jnp.asarray(a.numpy()) for a in (q0, kq, ks, vq, vs)), i,
                jmask, interpret=True))
            for call in variants.values():
                close(call(q0, i).numpy(), want)
    else:
        B, H, Q, D = 1, 2, 128, 64
        q0, k, v, mask = mb.flash_prefill_inputs(B, H, Q, D, f32, "cpu")
        pos = jnp.arange(Q, dtype=jnp.int32)
        want = np.asarray(jax_fa.flash_attention(
            *(jnp.asarray(a.numpy()) for a in (q0, k, v)),
            jax_masks.causal_mask(pos, pos), interpret=True))
        for call in mb.flash_prefill_variants(k, v, mask).values():
            close(call(q0, 0).numpy(), want)


def test_microbench_decode_bound_counts_the_visible_rows():
    """K2's bound reads only the cache rows the mask lets the query see
    (and q and the output); ``GB/s`` keeps JAX's count of the whole
    cache."""
    L, B, H, cap, D, S = 1, 2, 2, 128, 64, 1
    results = []
    kernel_microbench.bench_decode_attention(results, L, B, H, cap, D, S, 1,
                                             torch.float32, "cpu")
    valid = cap - 64
    want_bytes = 2 * B * H * valid * (D + 4) + 2 * B * H * S * D * 4
    for r in results:
        assert r["bound_by"] == "bytes"
        assert r["bound_us"] == pytest.approx(
            want_bytes / roofline.PEAK_HBM_GBPS * 1e6)
        assert r["GB/s"] == pytest.approx(
            B * H * cap * (2 * D + 8) / (r["us"] * 1e-6) / 1e9)


# ---------------------------------------------------------------------------
# prefill_profile
# ---------------------------------------------------------------------------

def test_prefill_profile_stages_equal_jax(monkeypatch, tmp_path,
                                          tiny_params):
    _, _, pj, _ = tiny_params
    use_tiny_configs(monkeypatch)
    use_params(monkeypatch, pj)
    argv = ["--batch", "2", "--prefill", "32", "--chunk_blocks", "2"]
    jax_out = {}
    real_leaves = jax.tree.leaves

    def leaves(tree, *a, **k):
        frame = sys._getframe(1)
        if frame.f_code.co_name == "sync":      # the script's sync(x)
            jax_out[frame.f_back.f_locals["name"]] = np.asarray(
                jax.tree.map(lambda t: t.astype(jnp.float32), tree))
        return real_leaves(tree, *a, **k)

    jm = jax_probe("prefill_profile", tmp_path)
    with monkeypatch.context() as mp:
        mp.setattr(jax.tree, "leaves", leaves)
        run_jax_main(monkeypatch, jm, argv, tmp_path)
    port_out = {}
    real_timeit = prefill_profile._timeit

    def timeit(report, name, fn, *a):
        out = real_timeit(report, name, fn, *a)
        port_out[name] = out.float().numpy()
        return out

    monkeypatch.setattr(prefill_profile, "_timeit", timeit)
    report = prefill_profile.main(argv + ["--cpu"])
    assert list(report["stages"]) == list(port_out)
    assert set(jax_out) <= set(port_out)
    assert {"embedder", "block prefill (full)", "block prefill (chunked)",
            "block prefill (fresh)", "matmul floor"} <= set(jax_out)
    for name, want in jax_out.items():
        bf16 = name in ("block prefill (bf16 KV)", "matmul floor")
        close(port_out[name], want, 2.0 ** -6 if bf16 else 1e-4)
    assert report["matmul_floor_route"] == "plain"      # the CPU


# ---------------------------------------------------------------------------
# mixed48_stage_probe
# ---------------------------------------------------------------------------

def test_two_level_decomposition_equals_jax(monkeypatch):
    import bench as jax_bench
    cfg_j = tiny_block(jax_config, vocab_size=512)
    cfg_t = tiny_block(torch_config, vocab_size=512)
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(4), cfg_j))
    kw = dict(bits=8, token_decoder_bits=4, lm_head_bits=8, group_size=32)
    qj = jax_quant.quantize_block_transformer(pj, **kw)
    qt = quant.quantize_block_transformer(
        bridge.params_from_numpy(pj, "cpu"), **kw)
    args = (2, 32, 8)
    rec_j, rec_t = [], []
    real_j, real_t = jax.block_until_ready, profiling.block_until_ready
    with monkeypatch.context() as mp:
        mp.setattr(jax, "block_until_ready",
                   lambda x: rec_j.append(np.asarray(real_j(x))) or x)
        want = jax_bench._two_level_decomposition(
            qj, cfg_j, *args, jnp.float32, "int4", iters=2)
    monkeypatch.setattr(profiling, "block_until_ready",
                        lambda x: rec_t.append(real_t(x).numpy()) or x)
    got = torch_bench._two_level_decomposition(
        qt, cfg_t, *args, torch.float32, "int4", iters=2)
    assert sorted(got) == sorted(want)
    assert all(np.isfinite(v) for v in got.values())
    assert len(rec_t) == len(rec_j) == 10
    # prefill x4, token x2, cache-only x2, block x2
    for i, (g, w) in enumerate(zip(rec_t, rec_j)):
        if i in (4, 5):         # the sum of every greedy token
            assert int(g) == int(w)
        else:
            close(g, w, 1e-4)


# ---------------------------------------------------------------------------
# paged_admit_probe
# ---------------------------------------------------------------------------

def engine_tokens(eng, prompts, decode):
    for p in prompts:
        eng.submit(p, decode)
    done = eng.run()
    return sorted((r.uid, list(r.generated)) for r in done)


def test_paged_admit_engine_equals_jax(monkeypatch, tmp_path, tiny_params):
    cfg_j, cfg_t, pj, pt = tiny_params
    jm = jax_probe("paged_admit_probe", tmp_path)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 50254, size=16) for _ in range(2)]
    eng_j = jm.build_engine("paged", 2, 16, 8, jax.tree.map(jnp.asarray, pj),
                            cfg_j)
    eng_t = paged_admit_probe.build_engine("paged", 2, 16, 8, pt, cfg_t,
                                           device="cpu")
    assert engine_tokens(eng_t, prompts, 8) == engine_tokens(eng_j, prompts,
                                                             8)
    # the probe's switch: no page copy inside, the copy outside
    for nocopy in (True, False):
        eng = paged_admit_probe.build_engine("paged", 2, 16, 8, pt, cfg_t,
                                             device="cpu")
        before = [t.clone() for t in (eng.cache.k, eng.cache.k_scale)]
        with (torch_engine.paged_probe_nocopy() if nocopy
              else contextlib.nullcontext()):
            for p in prompts:
                eng.submit(p, 8)
            eng._admit()
        same = all(torch.equal(a, b) for a, b in zip(
            before, (eng.cache.k, eng.cache.k_scale)))
        assert same == nocopy


def test_paged_admit_probe_report(monkeypatch, tmp_path, tiny_params):
    _, _, pj, _ = tiny_params
    use_tiny_configs(monkeypatch)
    use_params(monkeypatch, pj)
    out = paged_admit_probe.main([
        "--cpu", "--slots", "2", "--prefill", "16", "--decode", "8",
        "--reps", "1", "--out", str(tmp_path / "admit.json")])
    text = (ROOT / "scripts" / "paged_admit_probe.py").read_text()
    for key in ("model", "slots", "prefill", "decode", "contiguous",
                "paged", "paged_nocopy", "page_copy_s",
                "paged_residual_vs_contig_s"):
        assert f'"{key}"' in text and key in out
    for name in ("contiguous", "paged"):
        fit = out[name]["window_fit"]
        assert [w for w, _ in fit["windows"]] == [1, 2, 4, 8]
        assert np.isfinite(fit["fixed_per_dispatch_s"])
    assert os.path.exists(tmp_path / "admit.json")


# ---------------------------------------------------------------------------
# engine_cpu_ratio, w8a8_decode_gate
# ---------------------------------------------------------------------------

def test_engine_cpu_ratio_equals_jax(monkeypatch, tmp_path, tiny_params):
    cfg_j, cfg_t, pj, _ = tiny_params
    use_tiny_configs(monkeypatch)
    use_params(monkeypatch, pj)
    argv = ["--slots", "2", "--prefill", "16", "--decode", "8", "--reps",
            "1"]
    static = {"jax": [], "port": []}
    real_j, real_t = jax_gen.generate_blocks, gen.generate_blocks
    monkeypatch.setattr(jax_gen, "generate_blocks", lambda *a, **k: (
        static["jax"].append(np.asarray(real_j(*a, **k).tokens))
        or real_j(*a, **k)))
    monkeypatch.setattr(gen, "generate_blocks", lambda *a, **k: (
        static["port"].append(real_t(*a, **k).tokens.numpy())
        or real_t(*a, **k)))
    jm = jax_probe("engine_cpu_ratio", tmp_path)
    run_jax_main(monkeypatch, jm, argv + ["--out", tmp_path / "jax.json"],
                 tmp_path)
    got = engine_cpu_ratio.main(argv + ["--cpu", "--out",
                                        str(tmp_path / "port.json")])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert set(want) <= set(got) and set(got) - set(want) == {"card"}
    assert got["backend"] == want["backend"] == "cpu"
    np.testing.assert_array_equal(static["port"][0], static["jax"][0])
    assert np.isfinite(got["engine_pct_of_static"])


def test_w8a8_decode_gate_equals_jax(corpus, checkpoints, tmp_path):
    out, cfg, pj = checkpoints
    hold = corpus + "_holdout"
    report = w8a8_decode_gate.main([
        "--cpu", "--model_dir", str(out / "block_main_b4_5"), "--corpus",
        hold, "--batch", "4", "--prompt_len", str(PROMPT_LEN),
        "--gen_tokens", str(GEN_TOKENS), "--max_length", "64", "--out",
        str(tmp_path / "gate.json")])
    text = (ROOT / "scripts" / "w8a8_decode_gate.py").read_text()
    keys = ["batch", "gen_tokens", "greedy_agreement", "rows_identical",
            "first_divergence_token_mean", "pass_977",
            "fp32_mean_logprob_w8a8_on", "fp32_mean_logprob_w8a8_off",
            "fp32_logprob_delta"]
    assert sorted(report) == sorted(keys)
    for key in keys[:6] + ["fp32_mean_logprob_", "fp32_logprob_delta"]:
        assert f'"{key}' in text
    # on the CPU no linear takes W8A8: both variants decode alike
    assert report["greedy_agreement"] == 1.0
    prompts = jax_prompts(hold, 4, PROMPT_LEN, 3)
    want = jax_decode(jax_quant.quantize_block_transformer(pj, bits=8), cfg,
                      prompts, "int8", GEN_TOKENS)
    spec = {"model_dir": str(out / "block_main_b4_5"), "max_length": 64,
            "gen_tokens": GEN_TOKENS, "prompts": prompts, "device": "cpu"}
    for m_min in (w8a8_decode_gate.W8A8_OFF, 384):
        np.testing.assert_array_equal(
            w8a8_decode_gate.run_variant(spec, m_min), want)
    np.testing.assert_allclose(
        report["fp32_mean_logprob_w8a8_off"],
        jax_fp32_lp(pj, cfg, prompts, want, GEN_TOKENS), rtol=1e-4)
