"""The port's INT4 weights (quantization, K4's plain version, ``kernel_q4``
linears, generation and the engine) against the JAX package, on the CPU.

Quantization must agree bit for bit: both sides compute in float32 and round
half to even. K4's plain version is held to the Pallas kernel in interpret
mode within rtol 1e-5 and atol 1e-5 of the output's largest magnitude (the
same float32 products, summed in another order, with the group scale applied
to each weight instead of each tile's partial product). Models run in
float32 on the same parameters (the JAX tree bridged to tensors), so greedy
tokens must be equal and logits agree within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.test_block_parity import make_cfg
from tests.test_torch_engine import BUDGETS, MAX_BLOCKS, PROMPTS, _serve
from block_transformer_tpu import config as jax_config
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.inference.engine import (
    ContinuousBatchingEngine as JaxEngine)
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.ops import dequant_matmul as jax_dm
from block_transformer_tpu.ops import linear as jax_linear
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import engine as torch_engine
from block_transformer_tpu_torch.inference import generate as torch_gen
from block_transformer_tpu_torch.kernels import dequant_matmul as k4
from block_transformer_tpu_torch.models import block_transformer as torch_bt
from block_transformer_tpu_torch.ops import linear as torch_linear
from block_transformer_tpu_torch.ops import quant as torch_quant


def _bits(x):
    return np.asarray(x).tobytes()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(a: np.ndarray):
    """The same array for JAX and for the port."""
    return jnp.asarray(a), bridge.tensor_from_numpy(a, device="cpu")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _weights(shape, dtype, seed=0):
    """Random weights (std 0.05) with all-zero groups (scale floor 1e-8)
    and, in column 2 of the first group, values that land on .5 ties: the
    group's max 0.875 gives the exact scale 0.125, and 0.3125, -0.4375 and
    0.1875 scale to 2.5, -3.5 and 1.5."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    K = shape[-2]
    w[..., :K // 2, 1] = 0.0               # the groups of the first half
    w[..., :, 3] = 0.0                     # every group of a column
    w[..., :4, 2] = [0.875, 0.3125, -0.4375, 0.1875]
    return w.astype(dtype)


@pytest.mark.parametrize("group_size", [128, 64, 0, 48])
@pytest.mark.parametrize("shape", [(256, 40), (3, 256, 40)])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quantize_int4_bit_exact(dtype, shape, group_size):
    """Packed bytes, scales, unpacked values and dequantized weights equal
    JAX's; group size 48 does not divide K/2 = 128 (one group)."""
    w = _weights(shape, dtype)
    wj, wt = _pair(w)
    stacked = len(shape) == 3
    qfn = lambda a: jax_quant.quantize_int4(a, group_size)   # noqa: E731
    pj, sj = (jax.vmap(qfn) if stacked else qfn)(wj)
    pt, st = torch_quant.quantize_int4(wt, group_size)
    assert pt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(pt.shape) == pj.shape and tuple(st.shape) == sj.shape
    G = {128: 2, 64: 4, 0: 1, 48: 1}[group_size]
    assert st.shape[-2] == G
    assert _bits(pj) == _bits(pt.numpy())
    assert _bits(sj) == _bits(st.numpy())
    uj = (jax.vmap(jax_quant.unpack_int4) if stacked
          else jax_quant.unpack_int4)(pj)
    assert _bits(uj) == _bits(torch_quant.unpack_int4(pt).numpy())
    deq = lambda p, s: jax_quant.dequantize_int4(p, s, jnp.float32)  # noqa: E731
    dj = (jax.vmap(deq) if stacked else deq)(pj, sj)
    dt = torch_quant.dequantize_int4(pt, st, torch.float32)
    assert _bits(dj) == _bits(dt.numpy())


def test_unpack_and_dequantize_int4_every_byte():
    """All 256 byte values, 0x88 among them (two -8 nibbles), and a legacy
    per-channel [N] scale."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    assert (packed == np.int8(-120)).any()              # 0x88
    scale = np.random.default_rng(1).uniform(0.01, 0.1, 16).astype(np.float32)
    pj, pt = _pair(packed)
    uj = np.asarray(jax_quant.unpack_int4(pj))
    ut = torch_quant.unpack_int4(pt).numpy()
    assert _bits(uj) == _bits(ut)
    assert ut.min() == -8 and ut.max() == 7
    assert ut[0, 8] == -8 and ut[16, 8] == -8           # byte 0x88
    for s in (scale, scale[None].repeat(2, 0)):          # [N] and [G=2, N]
        sj, st = _pair(s)
        dj = jax_quant.dequantize_int4(pj, sj, jnp.float32)
        dt = torch_quant.dequantize_int4(pt, st, torch.float32)
        assert _bits(dj) == _bits(dt.numpy())


def _tree_bits_equal(tree_j, tree_t):
    """Every leaf equal in dtype and bits; returns the kernel_q4 / kernel_q8
    node counts."""
    flat_j = jax.tree_util.tree_flatten_with_path(tree_j)[0]
    back = bridge.params_to_numpy(tree_t)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    counts = {"kernel_q4": 0, "kernel_q8": 0}
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        assert node.dtype == np.asarray(leaf).dtype, path
        assert node.shape == np.asarray(leaf).shape, path
        assert _bits(node) == _bits(leaf), path
        if path[-1].key in counts:
            counts[path[-1].key] += 1
    return counts


@pytest.mark.parametrize("kwargs,q4,q8", [
    (dict(bits=4), 10, 0),
    (dict(bits=4, group_size=32), 10, 0),
    (dict(bits=8, token_decoder_bits=4, lm_head_bits=8), 5, 5),     # mixed48
    (dict(bits=8, token_decoder_bits=4, lm_head_bits=8, group_size=32), 5, 5),
    (dict(bits=4, skip_lm_head=True), 9, 0),
])
def test_quantize_block_transformer_int4_bit_exact(kwargs, q4, q8):
    """Leaf by leaf: 4 linears in each stack, the expansion layer and the
    LM head."""
    cfg = jax_config.make_block_config("t", 128, 2, vocab_size=512)
    params = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(1), cfg))
    qj = jax.device_get(jax_quant.quantize_block_transformer(params,
                                                             **kwargs))
    qt = torch_quant.quantize_block_transformer(
        bridge.params_from_numpy(params, device="cpu"), **kwargs)
    assert _tree_bits_equal(qj, qt) == {"kernel_q4": q4, "kernel_q8": q8}
    head = qt["token_decoder"]["embed_out"]
    assert ("kernel" in head) == bool(kwargs.get("skip_lm_head"))


def test_quantize_model_params_skip_paths():
    """A string skips a node whose path holds it; a tuple skips a node whose
    path holds all of its strings."""
    tree = {"a": {"x": {"kernel": torch.ones(4, 4)}},
            "b": {"x": {"kernel": torch.ones(4, 4)},
                  "y": {"kernel": torch.ones(4, 4)}}}
    out = torch_quant.quantize_model_params(tree, 4, skip_paths=(("b", "x"),))
    assert "kernel_q4" in out["a"]["x"] and "kernel_q4" in out["b"]["y"]
    assert "kernel" in out["b"]["x"]
    out = torch_quant.quantize_model_params(tree, 8, skip_paths=("x",))
    assert "kernel" in out["a"]["x"] and "kernel_q8" in out["b"]["y"]
    with pytest.raises(ValueError, match="bits"):
        torch_quant.quantize_linear({"kernel": torch.ones(4, 4)}, 2)


def _int4_weights(rng, lead, Kh, N, G):
    w = rng.integers(-128, 128, lead + (Kh, N)).astype(np.int8)   # -8 nibbles
    s = rng.uniform(0.01, 0.1, lead + (G, N)).astype(np.float32)
    return w, s


@pytest.mark.parametrize("M,layer,G,legacy", [
    (8, 2, 1, True),        # per-channel [L, N] scale
    (8, 1, 1, False),       # [L, 1, N]
    (20, 1, 4, False),      # groups of 128 rows
    (5, 0, 2, False),       # groups of 256 rows = K/2
])
def test_k4_plain_matches_pallas_stacked(M, layer, G, legacy):
    rng = np.random.default_rng(G + layer)
    L, Kh, N = 3, 256, 256
    x = rng.standard_normal((M, 2 * Kh)).astype(np.float32)
    w, s = _int4_weights(rng, (L,), Kh, N, G)
    if legacy:
        s = s[:, 0]
    want = jax_dm.int4_matmul_stacked(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(s), layer, interpret=True)
    got = k4.int4_matmul_stacked(_t(x), _t(w), _t(s), layer)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    _close(got.numpy(), want)


@pytest.mark.parametrize("Kh,N,G", [
    (100, 200, 1),          # ragged packed rows and columns, per-channel
    (100, 200, 4),          # ragged, groups of 50 rows (JAX: plain dot)
    (128, 200, 2),          # ragged N only
])
def test_k4_plain_matches_pallas_unstacked_ragged(Kh, N, G):
    rng = np.random.default_rng(Kh + G)
    M = 3
    x = rng.standard_normal((M, 2 * Kh)).astype(np.float32)
    w, s = _int4_weights(rng, (), Kh, N, G)
    want = jax_dm.int4_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                              interpret=True)
    got = k4.int4_matmul(_t(x), _t(w), _t(s))
    assert tuple(got.shape) == (M, N)
    _close(got.numpy(), want)


def test_apply_linear_int4_stacked_and_one_layer():
    """``kernel_q4`` nodes with biases, 3-D activations: within 1e-5."""
    cfg = jax_config.NeoXConfig(vocab_size=512, hidden_size=128, num_layers=2,
                                num_heads=4, intermediate_size=512)
    params = jax_neox.init_neox_params(jax.random.PRNGKey(4), cfg)
    pj = jax.device_get(jax_quant.quantize_model_params(params, bits=4,
                                                        group_size=32))
    pt = bridge.params_from_numpy(pj, device="cpu")
    rng = np.random.default_rng(4)
    for name, K in (("qkv", 128), ("down", 512)):
        part = "attn" if name == "qkv" else "mlp"
        x = rng.standard_normal((2, 3, K)).astype(np.float32)
        for layer in (0, 1):
            want = jax_linear.apply_linear(
                jnp.asarray(x),
                jax_linear.StackedLinear(pj["layers"][part][name], layer))
            got = torch_linear.apply_linear(
                _t(x), torch_linear.StackedLinear(pt["layers"][part][name],
                                                  layer))
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    want = jax_linear.apply_linear(jnp.asarray(x), pj["embed_out"])
    got = torch_linear.apply_linear(_t(x), pt["embed_out"])
    assert pt["embed_out"]["scale"].shape == (4, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bridge_carries_int4_leaves():
    """kernel_q4 stays int8 and its group scales float32 [L, G, N], also
    when a dtype is asked for the float leaves."""
    cfg = jax_config.make_block_config("t", 128, 2, vocab_size=512)
    pj = jax.device_get(jax_quant.quantize_block_transformer(
        jax_bt.init_block_transformer_params(jax.random.PRNGKey(5), cfg),
        bits=4, group_size=32))
    for dtype in (None, torch.bfloat16):
        pt = bridge.params_from_numpy(pj, device="cpu", dtype=dtype)
        up = pt["token_decoder"]["layers"]["mlp"]["down"]
        assert up["kernel_q4"].dtype == torch.int8
        assert tuple(up["kernel_q4"].shape) == (2, 256, 128)
        assert up["scale"].dtype == torch.float32
        assert tuple(up["scale"].shape) == (2, 16, 128)
        assert up["bias"].dtype == (dtype or torch.float32)
        assert _bits(up["kernel_q4"].numpy()) == _bits(
            pj["token_decoder"]["layers"]["mlp"]["down"]["kernel_q4"])


QUANTIZE = {
    "int4": dict(bits=4, group_size=32),
    "mixed48": dict(bits=8, token_decoder_bits=4, lm_head_bits=8,
                    group_size=32),
}


def _models(seed, kind):
    cfg = jax_config.make_block_config("t", 128, 2, vocab_size=512)
    tcfg = torch_config.make_block_config("t", 128, 2, vocab_size=512)
    params = jax_quant.quantize_block_transformer(
        jax_bt.init_block_transformer_params(jax.random.PRNGKey(seed), cfg),
        **QUANTIZE[kind])
    params = jax.device_get(params)
    return cfg, tcfg, params, bridge.params_from_numpy(params, device="cpu")


@pytest.mark.parametrize("kind", sorted(QUANTIZE))
def test_block_transformer_forward_logits_int4(kind):
    """Logits within 1e-4 abs."""
    cfg, tcfg, pj, pt = _models(6, kind)
    rng = np.random.default_rng(6)
    B, N, L = 2, 4, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, 0], att[1, 0] = 0, 0
    bam = att.any(-1).astype(np.int32)
    oj = jax_bt.block_transformer_forward(pj, cfg, *map(jnp.asarray,
                                                        (ids, att, bam)))
    ot = torch_bt.block_transformer_forward(pt, tcfg, *map(_t,
                                                           (ids, att, bam)))
    np.testing.assert_allclose(ot.logits.numpy(), np.asarray(oj.logits),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", sorted(QUANTIZE))
def test_generate_blocks_int4_greedy_tokens_equal(kind):
    """INT8 global KV cache, B=2 with a left-padded row, 3 prompt blocks,
    max_blocks 7."""
    cfg, tcfg, pj, pt = _models(7, kind)
    rng = np.random.default_rng(7)
    B, N, L = 2, 3, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, 0], att[1, 0] = 0, 0
    bam = att.any(-1).astype(np.int32)
    rj = jax_gen.generate_blocks(pj, cfg, jnp.asarray(ids), jnp.asarray(att),
                                 jnp.asarray(bam), max_blocks=7,
                                 kv_cache="int8")
    rt = torch_gen.generate_blocks(pt, tcfg, ids, att, bam, max_blocks=7,
                                   kv_cache="int8", device="cpu")
    assert rt.n_blocks == int(rj.n_blocks) == 7
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    np.testing.assert_array_equal(rt.unfinished.numpy(),
                                  np.asarray(rj.unfinished))


def test_engine_int4_weights_equal_jax_engine():
    """The serving engine with INT4 weights (group 32) and the contiguous
    INT8 cache: greedy tokens and every ``stats`` counter equal the JAX
    engine's on the traffic of ``tests/test_torch_engine.py``."""
    cfg = make_cfg()
    tcfg = torch_config.BlockTransformerConfig.from_dict(
        dataclasses.asdict(cfg))
    pj = jax.device_get(jax_quant.quantize_block_transformer(
        jax_bt.init_block_transformer_params(jax.random.PRNGKey(0), cfg),
        bits=4, group_size=32))
    pt = bridge.params_from_numpy(pj, device="cpu")
    kw = dict(n_slots=3, max_blocks=MAX_BLOCKS, kv_cache="int8",
              sync_blocks=3, bucket_blocks=2)
    jax_eng = JaxEngine(pj, cfg, **kw)
    port_eng = torch_engine.ContinuousBatchingEngine(pt, tcfg, device="cpu",
                                                     **kw)
    want, got = _serve(jax_eng), _serve(port_eng)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(r.generated for r in got[:-1]) and got[-1].error
    assert len(got) == len(PROMPTS) and len(got[5].generated) == BUDGETS[5]
    assert dataclasses.asdict(port_eng.stats) == dataclasses.asdict(
        jax_eng.stats)
