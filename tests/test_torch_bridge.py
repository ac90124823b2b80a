"""The PyTorch port's bridge and config copy against the JAX package.

Round trips of parameter trees (float32, bf16, INT8) and KV caches through
``block_transformer_tpu_torch.bridge`` must keep every leaf's shape, dtype
and bits; the port's copy of ``config.py`` must describe the same models.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.models import neox as torch_neox

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8, "int32": torch.int32}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_params_round_trip(kind):
    cfg = jax_config.make_block_config("t", 128, 2, vocab_size=512)
    dtype = jnp.bfloat16 if kind == "bfloat16" else jnp.float32
    params = jax_bt.init_block_transformer_params(jax.random.PRNGKey(0), cfg,
                                                  dtype)
    if kind == "int8":
        params = jax_quant.quantize_block_transformer(params, bits=8)
    tree = jax.device_get(params)
    port = bridge.params_from_numpy(tree, device="cpu")
    back = bridge.params_to_numpy(port)
    src, mid, out = (list(_leaves(t)) for t in (tree, port, back))
    assert [p for p, _ in src] == [p for p, _ in mid] == [p for p, _ in out]
    for (path, a), (_, t), (_, b) in zip(src, mid, out):
        a = np.asarray(a)
        assert t.dtype == _TORCH_DTYPE[a.dtype.name], path
        assert tuple(t.shape) == a.shape, path
        assert _same_bits(a, b), path
    kinds = {np.asarray(a).dtype.name for _, a in src}
    assert kind in kinds


@pytest.mark.parametrize("quantized", [True, False])
def test_cache_round_trip(quantized):
    cfg = jax_config.NeoXConfig(hidden_size=64, num_layers=2, num_heads=2,
                                vocab_size=64)
    rng = np.random.default_rng(0)
    shape = (2, 3, 2, 16, 32)
    if quantized:
        cache = jax_neox.QuantKVCache(
            jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
            jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
            jnp.asarray(rng.random(shape[:-1]), jnp.float32),
            jnp.asarray(rng.random(shape[:-1]), jnp.float32),
            jnp.int32(7))
    else:
        cache = jax_neox.KVCache(
            jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
            jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
            jnp.int32(7))
    del cfg
    port = bridge.cache_from_numpy(jax.device_get(cache), device="cpu")
    assert isinstance(port, torch_neox.QuantKVCache if quantized
                      else torch_neox.KVCache)
    assert port.length == 7
    back = bridge.cache_to_numpy(port)
    again = type(cache)(**{k: jnp.asarray(v) for k, v in back.items()})
    for f in cache._fields:
        assert _same_bits(np.asarray(getattr(cache, f)),
                          np.asarray(getattr(again, f))), f


@pytest.mark.parametrize("name", sorted(jax_config._BLOCK_MAIN))
def test_config_copy_matches(name):
    assert torch_config._BLOCK_MAIN[name] == jax_config._BLOCK_MAIN[name]
    assert (dataclasses.asdict(torch_config.get_config(name))
            == dataclasses.asdict(jax_config.get_config(name)))


def test_config_copy_small_and_derived():
    kw = dict(vocab_size=512, block_length=8, n_embedding_tokens=2)
    j = jax_config.make_block_config("t", 128, 2, **kw)
    t = torch_config.make_block_config("t", 128, 2, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("n_expanded_emb", "vocab_size", "eos_token_id",
                 "pad_token_id", "bos_token_id"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.block_decoder.head_dim == j.block_decoder.head_dim
    assert t.block_decoder.rotary_dim == j.block_decoder.rotary_dim
    assert (torch_config.BlockTransformerConfig.from_json(j.to_json())
            == t)
    assert set(torch_config._BLOCK_MAIN) == set(jax_config._BLOCK_MAIN)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("family", ["cls_cross_attention", "gpt_neo"])
def test_family_params_round_trip(family, quantized):
    """The ablation families' trees (a RoBERTa-CLS embedder with a T5
    token decoder; GPT-Neo block and token decoders), float32 and with
    INT8 decoders, cross JAX -> port -> numpy with every leaf's path,
    shape, dtype and bits unchanged."""
    from test_torch_families import models
    _, _, tree, port = models(family, quantized=quantized)
    back = bridge.params_to_numpy(port)
    src, mid, out = (list(_leaves(t)) for t in (tree, port, back))
    assert [p for p, _ in src] == [p for p, _ in mid] == [p for p, _ in out]
    for (path, a), (_, t), (_, b) in zip(src, mid, out):
        a = np.asarray(a)
        assert t.dtype == _TORCH_DTYPE[a.dtype.name], path
        assert _same_bits(a, b), path
    tops = {p[:2] for p, _ in src}
    assert (("embedder", "roberta") in tops and ("token_decoder", "t5") in tops
            if family == "cls_cross_attention" else
            ("token_decoder", "gpt_neo") in tops)


@pytest.mark.parametrize("moments", ["fresh bf16", "updated float32"])
def test_bf16_train_state_round_trip(moments):
    """A JAX train state with bf16 parameters: optax's moments are bf16
    before the first update and float32 after one fed float32 gradients
    (the trainer's accumulator). Both cross to the port and back with
    every leaf's dtype and bits; a state whose moments changed dtype goes
    back into a ``like`` of fresh bf16 moments with its float32 ones."""
    from block_transformer_tpu.train import optimizer as jax_opt
    from block_transformer_tpu.train import train_step as jax_ts
    cfg = jax_config.make_block_config("t", 64, 1, vocab_size=96)
    tx, _ = jax_opt.make_optimizer(1e-3, 1, 10)
    params = jax_bt.init_block_transformer_params(jax.random.PRNGKey(0), cfg,
                                                  jnp.bfloat16)
    fresh = jax.device_get(jax_ts.TrainState(params, tx.init(params),
                                             np.int32(0)))
    state = fresh
    if moments == "updated float32":
        grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32),
                             params)
        _, opt_state = tx.update(grads, tx.init(params), params)
        state = jax.device_get(jax_ts.TrainState(params, opt_state,
                                                 np.int32(1)))
    want = "bfloat16" if moments == "fresh bf16" else "float32"
    adam = state.opt_state[1][0]
    assert {np.asarray(a).dtype.name for a in jax.tree.leaves(adam.mu)} == {
        want}
    port = bridge.train_state_from_numpy(state, device="cpu")
    assert {str(t.dtype) for _, t in _leaves(port.params)} == {
        "torch.bfloat16"}
    assert {str(t.dtype) for _, t in _leaves(port.opt_state.mu)} == {
        f"torch.{want}"}
    back = bridge.train_state_to_numpy(port, like=fresh)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert _same_bits(np.asarray(a), np.asarray(b))
