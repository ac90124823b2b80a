"""The PyTorch port's model layers against the JAX package, on the CPU.

Small sizes, float32, the same numpy inputs and parameters on both sides
(the JAX tree goes through ``bridge.params_from_numpy``). Tolerances are
stated per test: float32 models that differ in summation order and in
transcendental implementations (rotary tables, exp, erf) agree to ~1e-6 on
activations of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.ops import linear as jax_linear
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.models import block_transformer as torch_bt
from block_transformer_tpu_torch.models import neox as torch_neox
from block_transformer_tpu_torch.ops import linear as torch_linear
from block_transformer_tpu_torch.ops import masks as torch_masks

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _neox_pair(seed=0, quantized=True):
    cfg = jax_config.NeoXConfig(vocab_size=512, hidden_size=128, num_layers=2,
                                num_heads=4, intermediate_size=512,
                                max_position_embeddings=64)
    tcfg = torch_config.NeoXConfig(**{f: getattr(cfg, f) for f in
                                      cfg.__dataclass_fields__})
    params = jax_neox.init_neox_params(jax.random.PRNGKey(seed), cfg)
    if quantized:
        params = jax_quant.quantize_model_params(params, bits=8)
    params = jax.device_get(params)
    return cfg, tcfg, params, bridge.params_from_numpy(params, device="cpu")


def test_apply_linear_quantized_stacked():
    _, _, pj, pt = _neox_pair()
    x = np.random.default_rng(0).standard_normal((2, 3, 128)).astype(np.float32)
    for name in ("qkv", "out"):
        for layer in (0, 1):
            want = jax_linear.apply_linear(
                jnp.asarray(x),
                jax_linear.StackedLinear(pj["layers"]["attn"][name], layer))
            got = torch_linear.apply_linear(
                _t(x), torch_linear.StackedLinear(pt["layers"]["attn"][name],
                                                  layer))
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    want = jax_linear.apply_linear(jnp.asarray(x), pj["embed_out"])
    got = torch_linear.apply_linear(_t(x), pt["embed_out"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _assert_cache_close(cj, ct):
    """Values may differ by one int8 step where a float32 difference of
    ~1e-7 falls on a rounding boundary; scales agree to float32 precision."""
    d = bridge.cache_to_numpy(ct)
    assert int(d["length"]) == int(cj.length)
    for f in ("k", "v"):
        diff = np.abs(d[f].astype(np.int32) - np.asarray(getattr(cj, f),
                                                          np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, f
    for f in ("k_scale", "v_scale"):
        np.testing.assert_allclose(d[f], np.asarray(getattr(cj, f)),
                                   rtol=1e-5, atol=1e-8)


def test_neox_stack_quant_cache_prefill_then_decode():
    """Prefill 5 positions into an INT8 cache, then 3 single-position
    decode steps; hidden states within 1e-4 and caches as above."""
    cfg, tcfg, pj, pt = _neox_pair(seed=1)
    rng = np.random.default_rng(1)
    B, cap = 2, 16
    cj = jax_neox.QuantKVCache.create(cfg, B, cap)
    ct = torch_neox.QuantKVCache.create(tcfg, B, cap, device="cpu")
    valid = np.ones((B, cap), np.int32)
    valid[1, :2] = 0                                   # left-padded row
    for S in (5, 1, 1, 1):
        x = rng.standard_normal((B, S, 128)).astype(np.float32)
        start = int(cj.length)
        mj = jax_masks.decode_mask(cj.length, cap, S, jnp.asarray(valid))
        mt = torch_masks.decode_mask(ct.length, cap, S, _t(valid),
                                     device="cpu")
        pos = start + np.arange(S, dtype=np.int32)
        hj, cj = jax_neox.neox_stack(pj, jnp.asarray(x), cfg=cfg, mask=mj,
                                     positions=jnp.asarray(pos), cache=cj)
        ht, ct = torch_neox.neox_stack(pt, _t(x), cfg=tcfg, mask=mt,
                                       positions=_t(pos), cache=ct)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL,
                                   rtol=ATOL)
        _assert_cache_close(cj, ct)


@pytest.mark.parametrize("q_tile", [4, 64])
def test_neox_prefill_fresh(q_tile):
    """Fresh prefill of a block-causal prompt with a left-padded row, query
    tiles that do not divide S (4) or cover it (64)."""
    cfg, tcfg, pj, pt = _neox_pair(seed=2)
    rng = np.random.default_rng(2)
    B, S, cap = 2, 10, 16
    x = rng.standard_normal((B, S, 128)).astype(np.float32)
    valid = np.ones((B, S), np.int32)
    valid[0, :3] = 0
    mj = jax_masks.block_decode_mask(jnp.int32(0), S, S, jnp.asarray(valid))
    mt = torch_masks.block_decode_mask(0, S, S, _t(valid))
    pos = np.arange(S, dtype=np.int32)
    hj, cj = jax_neox.neox_prefill_fresh(
        pj, jnp.asarray(x), cfg=cfg, mask=mj, positions=jnp.asarray(pos),
        cache=jax_neox.QuantKVCache.create(cfg, B, cap), q_tile=q_tile)
    ht, ct = torch_neox.neox_prefill_fresh(
        pt, _t(x), cfg=tcfg, mask=mt, positions=_t(pos),
        cache=torch_neox.QuantKVCache.create(tcfg, B, cap, device="cpu"),
        q_tile=q_tile)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL,
                               rtol=ATOL)
    _assert_cache_close(cj, ct)


def _block_inputs(rng, cfg, B=2, N=4):
    L = cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, 0], att[1, 0] = 0, 0                       # a padding block
    ids[0, 1, :2], att[0, 1, :2] = 0, 0               # padding tokens
    return ids, att, att.any(-1).astype(np.int32)


@pytest.mark.parametrize("quantized", [False, True])
def test_block_transformer_forward_logits_and_loss(quantized):
    """Logits within 1e-4 abs; token CE loss within 1e-5 relative."""
    cfg = jax_config.make_block_config("t", 128, 2, vocab_size=512)
    tcfg = torch_config.make_block_config("t", 128, 2, vocab_size=512)
    pj = jax_bt.init_block_transformer_params(jax.random.PRNGKey(3), cfg)
    if quantized:
        pj = jax_quant.quantize_block_transformer(pj, bits=8)
    pj = jax.device_get(pj)
    pt = bridge.params_from_numpy(pj, device="cpu")
    ids, att, bam = _block_inputs(np.random.default_rng(3), cfg)
    labels = np.where(att == 1, ids, -100).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (ids, att, bam)]
    targs = [_t(a) for a in (ids, att, bam)]
    oj = jax_bt.block_transformer_forward(pj, cfg, *jargs)
    ot = torch_bt.block_transformer_forward(pt, tcfg, *targs)
    assert ot.logits.dtype == torch.float32
    assert tuple(ot.logits.shape) == oj.logits.shape
    np.testing.assert_allclose(ot.logits.numpy(), np.asarray(oj.logits),
                               atol=ATOL, rtol=0)
    lj = jax_bt.block_transformer_forward(pj, cfg, *jargs,
                                          labels=jnp.asarray(labels))
    lt = torch_bt.block_transformer_forward(pt, tcfg, *targs,
                                            labels=_t(labels))
    np.testing.assert_allclose(lt.loss.item(), float(lj.loss), rtol=1e-5)
    np.testing.assert_allclose(lt.loss_by_position.numpy(),
                               np.asarray(lj.loss_by_position), rtol=1e-5,
                               atol=1e-6)
