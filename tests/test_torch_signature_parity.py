"""The port's functions that took JAX's signatures, held against JAX on the
CPU on the same numpy inputs: the six additive-bias builders of
``ops/masks.py`` (on the inputs of JAX's ``tests/test_masks.py`` and a few
more, exactly), ``decode_block_tokens(n_tokens=...)`` (greedy tokens and
``alive`` equal), ``QuantKVCache.create`` called positionally,
``neox.dense`` on float, INT8 and INT4 linears and the one-layer
``decode_attention_int8``.
``make_train_batch(ds, idxs, block_length, distribution)`` is held to JAX's
in ``tests/test_torch_data.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.ops import decode_attention as jax_da
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import generate as torch_gen
from block_transformer_tpu_torch.kernels import decode_attention as k2
from block_transformer_tpu_torch.models import neox as torch_neox
from block_transformer_tpu_torch.ops import masks as torch_masks


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _i32(a):
    return np.asarray(a, dtype=np.int32)


VALID = _i32([[1, 1, 1, 0, 0, 0], [0, 1, 1, 1, 1, 0]])
# (builder, JAX's arguments as numpy, keyword arguments): the calls of JAX's
# tests/test_masks.py, then batched and padded forms
BIAS_CASES = [
    *[("block_causal_bias", (np.arange(16) // n, np.arange(16) // n), {})
      for n in (1, 2, 4)],
    ("block_decoder_self_attention_bias", (_i32([[1, 1, 0]]), 2), {}),
    ("token_decoder_self_attention_bias", (_i32([[1, 1, 0]]), 2), {}),
    ("decode_step_bias", (3, 8, 1), {}),
    ("block_decode_step_bias", (2, 6, 1, _i32([[1, 1, 1, 0, 0, 0]])),
     {"n_embedding_tokens": 1}),
    ("causal_bias", (_i32([[2, 3, 4], [0, 1, 5]]), np.arange(6), VALID), {}),
    ("block_causal_bias", (_i32([1, 1, 2]), np.arange(6) // 2, 2, VALID),
     {}),
    ("block_decoder_self_attention_bias", (_i32([[1, 0, 1], [0, 1, 1]]), 4),
     {}),
    ("token_decoder_self_attention_bias", (_i32([[0, 1, 1, 1], [1, 1, 0,
                                                                0]]), 3), {}),
    ("decode_step_bias", (2, 6, 3, VALID, 2), {}),
    ("block_decode_step_bias", (3, 6, 3, VALID), {"n_embedding_tokens": 2}),
]


@pytest.mark.parametrize("name,args,kw", BIAS_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(BIAS_CASES)])
def test_bias_builders_equal_jax(name, args, kw):
    want = np.asarray(getattr(jax_masks, name)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args],
        **kw))
    targs = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    if name == "decode_step_bias":
        kw = {**kw, "device": "cpu"}
    got = getattr(torch_masks, name)(*targs, **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def _models(seed, **kw):
    cfg = jax_config.make_block_config("t", 128, 2, vocab_size=512, **kw)
    tcfg = torch_config.make_block_config("t", 128, 2, vocab_size=512, **kw)
    params = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(seed), cfg))
    return cfg, tcfg, params, bridge.params_from_numpy(params, device="cpu")


@pytest.mark.parametrize("n_tokens", [None, 1, 2, 3])
def test_decode_block_tokens_n_tokens_equal_jax(n_tokens):
    """A block of ``n_tokens`` tokens (None: the block length, 4) from the
    same block embeddings: greedy tokens and ``alive`` equal to JAX's."""
    cfg, tcfg, pj, pt = _models(3)
    be = np.random.default_rng(3).standard_normal(
        (3, cfg.n_embedding_tokens, 128)).astype(np.float32)
    tj, aj = jax_gen.decode_block_tokens(jax.tree.map(jnp.asarray, pj), cfg,
                                         jnp.asarray(be), n_tokens=n_tokens)
    tt, at = torch_gen.decode_block_tokens(pt, tcfg, _t(be),
                                           n_tokens=n_tokens)
    assert tt.shape == (3, n_tokens or cfg.block_length)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_decode_block_tokens_n_tokens_refused_on_the_rerun_route():
    """JAX asserts n_tokens is None for every other token decoder; the port
    raises before it touches the parameters."""
    tcfg = torch_config.make_block_config("t", 128, 2, vocab_size=512)
    tcfg = dataclasses.replace(tcfg, token_decoder=dataclasses.replace(
        tcfg.token_decoder, decoding_strategy="summation"))
    with pytest.raises(ValueError, match="n_tokens"):
        torch_gen.decode_block_tokens(None, tcfg, None, n_tokens=2)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_kv_cache_create_positional(bits):
    """JAX's positional call ``create(cfg, B, cap, None, bits)``: the same
    shapes (INT4 values packed two a byte along D), float32 scales, and
    ``dtype`` ignored."""
    cfg = jax_config.NeoXConfig.from_hidden_layers(128, 2, vocab_size=512)
    tcfg = torch_config.NeoXConfig.from_hidden_layers(128, 2, vocab_size=512)
    cj = jax_neox.QuantKVCache.create(cfg, 2, 16, None, bits)
    ct = torch_neox.QuantKVCache.create(tcfg, 2, 16, None, bits,
                                        device="cpu")
    assert ct.bits == bits and ct.length == 0
    D = cfg.head_dim
    assert tuple(ct.k.shape) == cj.k.shape[:-1] + (
        D if bits == 8 else D // 2,)
    assert ct.k.dtype == (torch.int8 if bits == 8 else torch.uint8)
    for got, want in ((ct.k_scale, cj.k_scale), (ct.v_scale, cj.v_scale)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    other = torch_neox.QuantKVCache.create(tcfg, 2, 16, torch.bfloat16, bits,
                                           device="cpu")
    assert [(t.shape, t.dtype) for t in other[:4]] == [
        (t.shape, t.dtype) for t in ct[:4]]


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_dense_equals_jax(bits):
    """``dense`` on a float32 linear with a bias, and on its INT8 and INT4
    (groups of 32 rows) quantizations by JAX's ``quantize_linear``, against
    JAX's ``dense`` on the same numpy inputs, 3-D activations."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    node = {"kernel": (0.05 * rng.standard_normal((128, 256))).astype(
        np.float32), "bias": rng.standard_normal(256).astype(np.float32)}
    if bits is not None:
        node = jax.device_get(jax_quant.quantize_linear(
            jax.tree.map(jnp.asarray, node), bits, group_size=32))
        assert f"kernel_q{bits}" in node
    want = jax_neox.dense(jnp.asarray(x), jax.tree.map(jnp.asarray, node))
    got = torch_neox.dense(_t(x), bridge.params_from_numpy(node,
                                                           device="cpu"))
    assert tuple(got.shape) == want.shape == (2, 3, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_decode_attention_int8_one_layer_equals_jax():
    """The one-layer form against JAX's (Pallas, interpret mode)."""
    rng = np.random.default_rng(5)
    B, H, S, cap, D = 2, 2, 1, 128, 32
    kq = rng.integers(-127, 128, (B, H, cap, D)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, H, cap, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (B, H, cap)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (B, H, cap)).astype(np.float32)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    valid = np.ones((B, cap), np.int32)
    valid[0, :5] = 0
    q_idx, kv_idx = np.full(S, 60, np.int32), np.arange(cap, dtype=np.int32)
    want = jax_da.decode_attention_int8(
        *map(jnp.asarray, (q, kq, ks, vq, vs)),
        jax_masks.AttnMask(jnp.asarray(q_idx), jnp.asarray(kv_idx),
                           jnp.asarray(valid)), interpret=True)
    got = k2.decode_attention_int8(
        *map(_t, (q, kq, ks, vq, vs)),
        torch_masks.AttnMask(_t(q_idx), _t(kv_idx), _t(valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
