"""The PyTorch port's GPT-Neo stacks and GPT-Neo block decoder against the
JAX package, on the CPU.

Tiny sizes, float32, the same numpy inputs and (bridged) parameters on
both sides. Tolerances are stated per test: float32 stacks with unscaled
scores that differ in summation order and in tanh agree to ~1e-6 on
activations of order 1; tokens are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.models import gpt_neo as jax_gn
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch.inference import generate as torch_gen
from block_transformer_tpu_torch.models import gpt_neo as torch_gn
from block_transformer_tpu_torch.models import neox as torch_neox
from block_transformer_tpu_torch.ops import masks as torch_masks

from test_torch_families import V, block_inputs, models

ATOL = 1e-5
HID, HEADS = 32, 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _gpt_neo(window, layer_types=(), seed=0):
    cfg = jax_gn.GPTNeoConfig(vocab_size=V, hidden_size=HID, num_layers=3,
                              num_heads=HEADS, intermediate_size=4 * HID,
                              max_position_embeddings=64, window_size=window,
                              attention_layers=layer_types)
    tcfg = torch_gn.GPTNeoConfig(**cfg.__dict__)
    pj = jax.device_get(jax_gn.init_gpt_neo_params(jax.random.PRNGKey(seed),
                                                   cfg))
    return cfg, tcfg, pj, bridge.params_from_numpy(pj, device="cpu")


@pytest.mark.parametrize("window,layer_types", [
    (3, ()), (3, ("local", "local", "global")), (64, ())])
def test_gpt_neo_forward(window, layer_types):
    """The LM over 10 tokens with a padded slot: global and local layers
    (a window of 3 is smaller than S; 64 is not), logits within 1e-4."""
    cfg, tcfg, pj, pt = _gpt_neo(window, layer_types)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, V, (2, 10)).astype(np.int32)
    att = np.ones_like(ids)
    att[1, 2] = 0
    want = jax_gn.gpt_neo_forward(pj, cfg, jnp.asarray(ids), jnp.asarray(att))
    got = torch_gn.gpt_neo_forward(pt, tcfg, _t(ids), _t(att))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_gpt_neo_block_decoder_forward():
    """The block decoder (block-causal, 2 embedding tokens a block, a
    padding block, local band of 2 blocks) within ATOL."""
    cfg, tcfg, pj, pt = _gpt_neo(2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, HID)).astype(np.float32)
    bam = np.ones((2, 6), np.int32)
    bam[0, 0] = 0
    want = jax_gn.gpt_neo_block_decoder_forward(pj, cfg, jnp.asarray(x),
                                                jnp.asarray(bam), 2)
    got = torch_gn.gpt_neo_block_decoder_forward(pt, tcfg, _t(x), _t(bam), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_gpt_neo_stack_cached_prefill_then_decode():
    """A 6-position prefill, then three 1-position steps, through the
    cached stack (window 3 < the 9 positions, layers global, local,
    global) from the same empty cache on both sides: every step's hidden
    within ATOL and the final cache within ATOL."""
    cfg, tcfg, pj, pt = _gpt_neo(3)
    pjj = jax.tree.map(jnp.asarray, pj)
    ncfg = jax_neox.NeoXConfig(vocab_size=V, hidden_size=HID, num_layers=3,
                               num_heads=HEADS)
    B, cap = 2, 12
    cj = jax_neox.KVCache.create(ncfg, B, cap, dtype=jnp.float32)
    ct = torch_neox.KVCache(torch.zeros(3, B, HEADS, cap, HID // HEADS),
                            torch.zeros(3, B, HEADS, cap, HID // HEADS), 0)
    valid = np.ones((B, cap), np.int32)
    valid[1, 0] = 0
    rng = np.random.default_rng(2)
    for S in (6, 1, 1, 1):
        x = rng.standard_normal((B, S, HID)).astype(np.float32)
        start = ct.length
        mj = jax_masks.decode_mask(jnp.int32(start), cap, S,
                                   jnp.asarray(valid))
        mt = torch_masks.decode_mask(start, cap, S, _t(valid), device="cpu")
        pos = np.arange(start, start + S, dtype=np.int32)
        hj, cj = jax_gn.gpt_neo_stack_cached(pjj, cfg, jnp.asarray(x), mj,
                                             jnp.asarray(pos), cj)
        ht, ct = torch_gn.gpt_neo_stack_cached(pt, tcfg, _t(x), mt, _t(pos),
                                               ct)
        assert ct.length == int(cj.length) == start + S
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL,
                                   rtol=0)
    for a, b in ((ct.k, cj.k), (ct.v, cj.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


def test_gpt_neo_stack_cached_refuses_a_quantized_cache():
    _, tcfg, _, pt = _gpt_neo(3)
    cache = torch_neox.QuantKVCache.create(
        torch_neox.NeoXConfig(hidden_size=HID, num_layers=3,
                              num_heads=HEADS), 1, 8, device="cpu")
    mask = torch_masks.decode_mask(0, 8, 1, device="cpu")
    with pytest.raises(TypeError):
        torch_gn.gpt_neo_stack_cached(pt, tcfg, torch.zeros(1, 1, HID), mask,
                                      torch.zeros(1, dtype=torch.int32),
                                      cache)


@pytest.mark.parametrize("chunk_blocks", [128, 2])
def test_gpt_neo_generate_blocks_streaming_prefill(chunk_blocks):
    """The GPT-Neo family through ``generate_blocks``: the prefill always
    streams (one chunk, or chunks of 2 blocks padded to 4 with the cache
    rewound), then the cached block decoder: tokens equal to JAX's."""
    cj, ct, pj, pt = models("gpt_neo", seed=7)
    ids, att, bam, _ = block_inputs(7, N=3)
    kw = dict(max_blocks=8, prefill_chunk_blocks=chunk_blocks)
    rj = jax_gen.generate_blocks(pj, cj, *map(jnp.asarray, (ids, att, bam)),
                                 **kw)
    rt = torch_gen.generate_blocks(pt, ct, ids, att, bam, device="cpu", **kw)
    assert rt.n_blocks == int(rj.n_blocks)
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    np.testing.assert_array_equal(rt.unfinished.numpy(),
                                  np.asarray(rj.unfinished))


@pytest.mark.parametrize("kv_cache", ["int8", "int4"])
def test_gpt_neo_quantized_cache_raises(kv_cache):
    """A quantized global cache with the GPT-Neo block decoder raises in
    the port where it raises in JAX."""
    cj, ct, pj, pt = models("gpt_neo")
    ids, att, bam, _ = block_inputs(0)
    with pytest.raises(NotImplementedError):
        jax_gen.generate_blocks(pj, cj, *map(jnp.asarray, (ids, att, bam)),
                                max_blocks=5, kv_cache=kv_cache)
    with pytest.raises(NotImplementedError):
        torch_gen.generate_blocks(pt, ct, ids, att, bam, max_blocks=5,
                                  kv_cache=kv_cache, device="cpu")
