"""The port's vanilla GPT-NeoX baseline against the JAX package, on the CPU.

A small float32 configuration with the same parameters on both sides (the
JAX tree bridged to tensors): float, INT8 and INT4 (group 32) weights; INT8
and float ("bf16" kind, here in float32) KV caches. Logits agree within
1e-4 abs (float32 models that differ in summation order and
transcendentals), and greedy tokens are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.models import vanilla as jax_vanilla
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch import profile_generate as pg
from block_transformer_tpu_torch.models import neox as torch_neox
from block_transformer_tpu_torch.models import vanilla as torch_vanilla

ATOL = 1e-4
WEIGHTS = {"float": None, "int8": dict(bits=8),
           "int4": dict(bits=4, group_size=32)}


@pytest.mark.parametrize("name", sorted(jax_config._VANILLA))
def test_get_vanilla_config_equal(name):
    want = dataclasses.asdict(jax_config.get_vanilla_config(name))
    got = dataclasses.asdict(torch_config.get_vanilla_config(name))
    assert got == want
    over = dict(vocab_size=512, max_position_embeddings=64)
    assert dataclasses.asdict(
        torch_config.get_vanilla_config(name, **over)) == dataclasses.asdict(
            jax_config.get_vanilla_config(name, **over))


def test_get_vanilla_config_unknown_name():
    with pytest.raises(KeyError, match="vanilla_410"):
        torch_config.get_vanilla_config("vanilla_1b")


def _models(weights, seed=0):
    cfg = jax_config.NeoXConfig.from_hidden_layers(
        128, 2, vocab_size=512, num_heads=4, max_position_embeddings=64)
    tcfg = torch_config.NeoXConfig(**dataclasses.asdict(cfg))
    params = jax_vanilla.init_vanilla_params(jax.random.PRNGKey(seed), cfg)
    if WEIGHTS[weights]:
        params = jax_quant.quantize_model_params(params, **WEIGHTS[weights])
    params = jax.device_get(params)
    return cfg, tcfg, params, bridge.params_from_numpy(params, device="cpu")


def _ids(rng, cfg, B, S):
    return rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
def test_vanilla_forward_logits(weights):
    """Causal forward with a left-padded row."""
    cfg, tcfg, pj, pt = _models(weights, seed=1)
    rng = np.random.default_rng(1)
    ids = _ids(rng, cfg, 2, 9)
    att = np.ones_like(ids)
    att[1, :3] = 0
    want = jax_vanilla.vanilla_forward(pj, cfg, jnp.asarray(ids),
                                       jnp.asarray(att))
    got = torch_vanilla.vanilla_forward(pt, tcfg, torch.from_numpy(ids),
                                        torch.from_numpy(att))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_vanilla_prefill_decode_greedy(weights, kv):
    """Prefill 12 tokens (a left-padded row), then 6 greedy decode steps:
    each step's logits within 1e-4 and the greedy tokens equal."""
    cfg, tcfg, pj, pt = _models(weights, seed=2)
    rng = np.random.default_rng(2)
    B, S, steps = 2, 12, 6
    ids = _ids(rng, cfg, B, S)
    att = np.ones_like(ids)
    att[0, :2] = 0
    cap = S + steps
    cj = jax_neox.make_kv_cache(cfg, B, cap, kv, dtype=jnp.float32)
    ct = torch_neox.make_kv_cache(tcfg, B, cap, kv, dtype=torch.float32,
                                  device="cpu")
    lj, cj = jax_vanilla.vanilla_prefill(pj, cfg, jnp.asarray(ids), cj,
                                         jnp.asarray(att))
    lt, ct = torch_vanilla.vanilla_prefill(pt, tcfg, torch.from_numpy(ids),
                                           ct, torch.from_numpy(att))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    tj, tt = jnp.argmax(lj, -1).astype(jnp.int32), lt.argmax(-1).to(
        torch.int32)
    for _ in range(steps):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        lj, cj = jax_vanilla.vanilla_decode_step(pj, cfg, tj, cj)
        lt, ct = torch_vanilla.vanilla_decode_step(pt, tcfg, tt, ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0)
        tj, tt = jnp.argmax(lj, -1).astype(jnp.int32), lt.argmax(-1).to(
            torch.int32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert ct.length == int(cj.length) == cap


@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_vanilla_generate_matches_jax_loop(weights):
    """``profile_generate.vanilla_generate`` (prefill, then greedy decode
    steps with an INT8 cache) gives the tokens of the same loop in JAX,
    ``bench.py``'s ``full_generate``."""
    cfg, tcfg, pj, pt = _models(weights, seed=3)
    ids = _ids(np.random.default_rng(3), cfg, 2, 10)
    steps = 5
    cache = jax_neox.make_kv_cache(cfg, 2, 10 + steps, "int8",
                                   dtype=jnp.float32)
    logits, cache = jax_vanilla.vanilla_prefill(pj, cfg, jnp.asarray(ids),
                                                cache)
    want = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for _ in range(steps):
        logits, cache = jax_vanilla.vanilla_decode_step(pj, cfg, want[-1],
                                                        cache)
        want.append(jnp.argmax(logits, -1).astype(jnp.int32))
    got = pg.vanilla_generate(pt, tcfg, torch.from_numpy(ids), steps)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, steps + 1)
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([np.asarray(t) for t in want], 1))


def test_vanilla_model_quantizes_as_bench():
    """``vanilla_model`` quantizes every linear (group 128 for INT4) and
    leaves the embedding and layer norms in float."""
    cfg, params = pg.vanilla_model(0, "vanilla_31", quantize="int4",
                                   dtype=torch.float32, device="cpu")
    assert cfg.hidden_size == 256 and cfg.num_heads == 8
    qkv = params["layers"]["attn"]["qkv"]
    assert qkv["kernel_q4"].shape == (6, 128, 768)
    assert qkv["scale"].shape == (6, 2, 768)             # groups of 128 rows
    assert params["layers"]["mlp"]["down"]["scale"].shape == (6, 8, 256)
    assert params["embed_out"]["scale"].shape == (2, 50304)
    assert params["embed_in"]["weight"].dtype == torch.float32
