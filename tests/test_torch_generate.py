"""The PyTorch port's generation against the JAX package, on the CPU.

Greedy tokens must be equal, not close: the port runs the same float32
model on the same parameters, and random initialization makes near-ties
between the top two logits rare. Sampling cannot be compared draw for draw
(jax.random and torch.Generator differ), so its filtered logits are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import generate as torch_gen


def _models(seed, quantized):
    cfg = jax_config.make_block_config("t", 128, 2, vocab_size=512)
    tcfg = torch_config.make_block_config("t", 128, 2, vocab_size=512)
    params = jax_bt.init_block_transformer_params(jax.random.PRNGKey(seed),
                                                  cfg)
    if quantized:
        params = jax_quant.quantize_block_transformer(params, bits=8)
    params = jax.device_get(params)
    return cfg, tcfg, params, bridge.params_from_numpy(params, device="cpu")


def test_generate_blocks_int8_greedy_tokens_equal():
    """INT8 weights, INT8 global KV cache, B=2 with one left-padded row,
    3 prompt blocks, max_blocks 7."""
    cfg, tcfg, pj, pt = _models(0, quantized=True)
    rng = np.random.default_rng(0)
    B, N, L = 2, 3, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, 0], att[1, 0] = 0, 0
    ids[1, 1, :1], att[1, 1, :1] = 0, 0
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


def test_generate_flat_ids_equal():
    """Flat prompts of different lengths (left pad to a block boundary),
    float weights, the default cache."""
    cfg, tcfg, pj, pt = _models(1, quantized=False)
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, cfg.vocab_size, (2, 7)).astype(np.int32)
    mask = np.ones_like(prompt)
    mask[0, :2] = 0
    want = jax_gen.generate(pj, cfg, prompt, mask, max_length=21)
    got = torch_gen.generate(pt, tcfg, prompt, mask, max_length=21,
                             device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 5, 1.0), (0.7, 0, 0.9), (1.3, 20, 0.5)])
def test_sample_filtered_logits_equal(temperature, top_k, top_p,
                                      monkeypatch):
    """JAX's ``_sample`` hands its filtered logits to
    ``jax.random.categorical``; capture them there and compare with the
    port's ``filter_logits`` on the same logits (-inf pattern exactly,
    values to float32 precision)."""
    logits = np.random.default_rng(2).standard_normal((4, 64)).astype(
        np.float32) * 3
    seen = []

    def capture(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.zeros(lg.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jax_gen._sample(jnp.asarray(logits), False, temperature,
                    jax.random.PRNGKey(0), top_k, top_p)
    want = seen[0]
    got = torch_gen.filter_logits(torch.from_numpy(logits), temperature,
                                  top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got).any() and np.isfinite(got).any(axis=-1).all()
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-6)
    samples = torch_gen._sample(torch.from_numpy(logits), False, temperature,
                                torch.Generator().manual_seed(0), top_k,
                                top_p)
    kept = np.isfinite(got[np.arange(4), samples.numpy()])
    assert kept.all()


def test_sample_greedy_is_argmax():
    logits = np.random.default_rng(3).standard_normal((5, 33)).astype(
        np.float32)
    got = torch_gen._sample(torch.from_numpy(logits), True, 1.0, None)
    want = jax_gen._sample(jnp.asarray(logits), True, 1.0, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
