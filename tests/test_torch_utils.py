"""The port's utilities against the JAX package's, on the CPU: the
device-memory arithmetic (``utils/hbm.py``) at a given limit, the FLOP and
byte models (``utils/roofline.py``) with the H100's peaks in place of the
TPU's, ``count_params``, ``run_id`` and the profiling helpers. The
arithmetic is the same Python on the same numbers, so it must be equal."""

import os

import jax
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.utils import hbm as jax_hbm
from block_transformer_tpu.utils import roofline as jax_roofline
from block_transformer_tpu.utils import run_id as jax_run_id
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.utils import hbm
from block_transformer_tpu_torch.utils import profiling
from block_transformer_tpu_torch.utils import roofline
from block_transformer_tpu_torch.utils import run_id

GIB = 2 ** 30
MODELS = ["block_main_b4_5", "block_main_b4_85", "block_main_b4_1.2b"]
QUANTIZE = [None, "int8", "int4", "mixed48"]
KV = ["bf16", "int8", "int4"]


def _cfgs(name):
    return jax_config.get_config(name), torch_config.get_config(name)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("quantize", QUANTIZE)
def test_hbm_model_bytes_equal_jax(name, quantize):
    jcfg, tcfg = _cfgs(name)
    for kv in KV:
        for batch, prefill, decode in ((1, 128, 128), (64, 2048, 128),
                                       (384, 512, 1024)):
            assert hbm.block_model_bytes(
                tcfg, batch, prefill, decode, kv_cache=kv,
                quantize=quantize) == jax_hbm.block_model_bytes(
                jcfg, batch, prefill, decode, kv_cache=kv, quantize=quantize)
    for q in (None, "int8", "int4"):
        vj = jax_config.get_vanilla_config("vanilla_410")
        vt = torch_config.get_vanilla_config("vanilla_410")
        assert hbm.vanilla_model_bytes(vt, 32, 2048, 128, kv_cache="int8",
                                       quantize=q) == \
            jax_hbm.vanilla_model_bytes(vj, 32, 2048, 128, kv_cache="int8",
                                        quantize=q)


@pytest.mark.parametrize("limit_gib", [10, 15.75, 80])
def test_auto_batch_at_a_given_limit_equals_jax(limit_gib):
    jcfg, tcfg = _cfgs("block_main_b4_1.2b")
    lim = int(limit_gib * GIB)
    for q, kv in (("int8", "int8"), ("int8", "int4"), (None, "bf16")):
        got = hbm.auto_batch(lambda b: hbm.block_model_bytes(
            tcfg, b, 2048, 128, kv_cache=kv, quantize=q), limit=lim)
        want = jax_hbm.auto_batch(lambda b: jax_hbm.block_model_bytes(
            jcfg, b, 2048, 128, kv_cache=kv, quantize=q), limit=lim)
        assert got == want
    assert hbm.auto_batch(lambda b: b * GIB, limit=1000 * GIB) == 768
    for q in (None, "none", "int8", "int4"):
        assert hbm.weight_bytes(q) == jax_hbm.weight_bytes(q)


def test_hbm_limit_without_a_card_takes_only_a_given_default():
    if torch.cuda.is_available():
        assert hbm.hbm_bytes_limit() == \
            torch.cuda.get_device_properties(0).total_memory
        return
    assert hbm.hbm_bytes_limit(default=5 * GIB) == 5 * GIB
    with pytest.raises(RuntimeError, match="no card"):
        hbm.hbm_bytes_limit()


@pytest.mark.parametrize("name", MODELS)
def test_roofline_models_equal_jax(name):
    jcfg, tcfg = _cfgs(name)
    for q in QUANTIZE:
        for kv in KV:
            for batch, prefill, decode in ((8, 2048, 128), (256, 512, 512)):
                assert roofline.decode_stage_model(
                    tcfg, batch, prefill, decode, kv, q) == \
                    jax_roofline.decode_stage_model(
                        jcfg, batch, prefill, decode, kv, q)
    for batch, prefill in ((8, 2048), (32, 512)):
        assert roofline.prefill_model(tcfg, batch, prefill) == \
            jax_roofline.prefill_model(jcfg, batch, prefill)
    vj = jax_config.get_vanilla_config("vanilla_410")
    vt = torch_config.get_vanilla_config("vanilla_410")
    assert roofline.vanilla_decode_model(vt, 8, 2048, 128) == \
        jax_roofline.vanilla_decode_model(vj, 8, 2048, 128)


def test_mfu_summary_uses_the_h100_peaks():
    """The same utilizations as JAX's once each is rescaled from JAX's
    (TPU v5e) peak to the H100's data-sheet peak; no ``*_effective`` key."""
    assert (roofline.PEAK_BF16_FLOPS, roofline.PEAK_INT8_OPS,
            roofline.PEAK_HBM_GBPS) == (989e12, 1979e12, 3.35e12)
    assert not hasattr(roofline, "EFFECTIVE_HBM_GBPS")
    jcfg, tcfg = _cfgs("block_main_b4_1.2b")
    kw = dict(batch=8, prefill=2048, decode=128, kv_cache="int8",
              quantize="int8", bd_ms=1.3, td_ms=4.1, prefill_ms=30.0,
              headline_tok_per_s=400.0, headline_batch=8)
    got = roofline.mfu_summary(tcfg, **kw)
    want = jax_roofline.mfu_summary(jcfg, **kw)
    assert sorted(got) == sorted(k for k in want
                                 if not k.endswith("_effective"))
    for k, v in got.items():
        if k.startswith("mfu"):
            scale = jax_roofline.PEAK_BF16_FLOPS / roofline.PEAK_BF16_FLOPS
        else:
            scale = jax_roofline.PEAK_HBM_GBPS / roofline.PEAK_HBM_GBPS
        assert v == pytest.approx(want[k] * scale, rel=1e-12), k
    m = roofline.decode_stage_model(tcfg, 8, 2048, 128, "int8", "int8")
    assert got["mfu_block_decoder_decode"] == pytest.approx(
        m["bd_flops"] / 1.3e-3 / 989e12, rel=1e-12)


@pytest.mark.parametrize("name", ["block_main_b4_5", "tiny"])
def test_count_params_equals_jax(name):
    if name == "tiny":
        jcfg = jax_config.make_block_config("t", 64, 1, vocab_size=96)
        tcfg = torch_config.make_block_config("t", 64, 1, vocab_size=96)
    else:
        jcfg, tcfg = _cfgs(name)
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(0), jcfg))
    pt = bt.init_block_transformer_params(0, tcfg, device="cpu")
    assert bt.count_params(pt) == jax_bt.count_params(pj)
    assert bt.count_params(bridge.params_from_numpy(pj, "cpu")) == \
        jax_bt.count_params(pj)


def test_run_id_behaves_as_jax(tmp_path):
    for mod in (run_id, jax_run_id):
        rid = mod.generate_run_id()
        assert len(rid) == 8 and rid.isalnum() and rid == rid.lower()
        assert len(mod.generate_run_id(12)) == 12
    d = str(tmp_path / "run")
    first = run_id.get_or_create_run_id(d)
    assert run_id.get_or_create_run_id(d) == first
    assert jax_run_id.get_or_create_run_id(d) == first
    with open(os.path.join(d, "run_id.txt")) as f:
        assert f.read() == first


def test_timed_and_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    calls = []

    def fn(a, scale=1.0):
        calls.append(1)
        return {"y": (a @ a) * scale, "n": [a.sum()]}

    res, secs = profiling.timed(fn, x, n_rep=3, scale=2.0)
    assert len(calls) == 4 and secs > 0
    torch.testing.assert_close(res["y"], (x @ x) * 2.0)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        fn(x)
    assert os.path.isfile(tmp_path / "tr" / "trace.json")
    assert any("mm" in e.key for e in prof.key_averages())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.device_memory_stats()


def test_decompose_generation_runs_each_phase():
    """The phases at a small configuration on the CPU: positive seconds
    that add up (host seconds here, no device figure)."""
    cfg = torch_config.make_block_config("t", 64, 1, vocab_size=96)
    params = bt.init_block_transformer_params(0, cfg, device="cpu")
    d = profiling.decompose_generation(params, cfg, batch=2, n_blocks=4,
                                       n_rep=1)
    assert set(d) == {"block_decoder_s", "token_decoder_s", "embedder_s",
                      "total_per_block_s", "tokens_per_sec_est"}
    parts = d["block_decoder_s"] + d["token_decoder_s"] + d["embedder_s"]
    assert all(v > 0 for v in d.values())
    assert d["total_per_block_s"] == pytest.approx(parts)
    assert d["tokens_per_sec_est"] == pytest.approx(
        2 * cfg.block_length / parts)
