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
