"""GPTQ in the PyTorch port (``ops/gptq.py``) against the JAX package, on
the CPU.

Tolerances: ``gptq_round`` is float64 in JAX's order of operations, with
LAPACK's inverse and Cholesky on both sides, so Q is held entry for entry
and the scales within 1e-6 relative; the packing is bit for bit. The
whole-model driver propagates float32 activations through the quantized
layers, so its Q may move by one step where a row sits at a rounding
boundary: at least 99.9% of Q entries equal, the rest within +-1, and the
other leaves (scales, and what GPTQ keeps) within 1e-5 relative. The four
contracts of ``tests/test_gptq.py`` are held on the port alone.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from block_transformer_tpu.ops import gptq as jax_gptq
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch.models import block_transformer as torch_bt
from block_transformer_tpu_torch.ops import gptq
from block_transformer_tpu_torch.ops import quant
from block_transformer_tpu_torch.train import optimizer as torch_opt
from tests.test_block_parity import L, VOCAB, make_cfg
from tests.test_torch_qat import jax_params, torch_cfg

SCALE_RTOL = 1e-6


def _correlated_inputs(rng, M, K):
    base = rng.standard_normal((M, K // 4))
    mix = rng.standard_normal((K // 4, K))
    return (base @ mix + 0.1 * rng.standard_normal((M, K))).astype(np.float32)


def _problem(seed, K=256, N=96, M=1024, dead=()):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((K, N)).astype(np.float32)
    X = _correlated_inputs(rng, M, K)
    X[:, list(dead)] = 0.0
    return W, (X.T @ X).astype(np.float64), X


@pytest.mark.parametrize("bits,gs,act_order,dead", [
    (4, 128, False, ()), (4, 64, False, ()), (8, 128, False, ()),
    (4, 64, True, ()), (4, 128, False, (3, 40, 200)),
    (8, 0, True, (5,)), (4, 32, False, ())])
def test_gptq_round_equals_jax(bits, gs, act_order, dead):
    W, H, _ = _problem(bits + gs, dead=dead)
    kw = dict(bits=bits, group_size=gs, act_order=act_order)
    Qj, sj = jax_gptq.gptq_round(W, H, **kw)
    Qt, st = gptq.gptq_round(torch.from_numpy(W), torch.from_numpy(H), **kw)
    assert Qt.dtype == torch.int32 and st.dtype == torch.float32
    np.testing.assert_array_equal(Qt.numpy(), Qj)
    np.testing.assert_allclose(st.numpy(), sj, rtol=SCALE_RTOL, atol=0)
    if dead:
        assert not Qt.numpy()[list(dead)].any()


def test_pack_gptq_int4_bit_exact():
    Q = np.random.default_rng(0).integers(-7, 8, (128, 24)).astype(np.int32)
    s = np.random.default_rng(1).random((2, 24)).astype(np.float32)
    pj, sj = jax_gptq.pack_gptq_int4(Q, s)
    pt, st = gptq.pack_gptq_int4(torch.from_numpy(Q), torch.from_numpy(s))
    assert pt.dtype == torch.int8
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(quant.unpack_int4(pt).numpy(), Q)


# -- the JAX file's contracts, on the port --------------------------------

def test_gptq_round_beats_rtn():
    W, H, X = _problem(0, K=256, N=128, M=2048)
    Q, scale = gptq.gptq_round(torch.from_numpy(W), torch.from_numpy(H),
                               bits=4, group_size=128)
    w_gptq = (Q.double() * scale.double().repeat_interleave(
        256 // scale.shape[0], 0)).numpy()
    w_rtn = gptq.rtn_weight(torch.from_numpy(W), 4, 128).numpy()
    err_gptq = np.linalg.norm(X @ (W - w_gptq))
    err_rtn = np.linalg.norm(X @ (W - w_rtn))
    assert err_gptq < 0.9 * err_rtn, (err_gptq, err_rtn)
    Ht = torch.from_numpy(H)
    assert gptq.output_error(torch.from_numpy(W), torch.from_numpy(w_gptq),
                             Ht) == pytest.approx(
        err_gptq / np.linalg.norm(X @ W), rel=1e-6)


def test_gptq_pack_matches_kernel_format():
    W, H, _ = _problem(1, K=256, N=128, M=512)
    leaf = gptq.gptq_quantize_linear_weight(torch.from_numpy(W),
                                            torch.from_numpy(H), bits=4,
                                            group_size=128)
    packed, scale = leaf["kernel_q4"], leaf["scale"]
    ref_packed, ref_scale = quant.quantize_int4(torch.from_numpy(W), 128)
    assert packed.shape == ref_packed.shape and packed.dtype == torch.int8
    assert scale.shape == ref_scale.shape
    vals = quant.unpack_int4(packed)
    assert vals.min() >= -7 and vals.max() <= 7
    deq = quant.dequantize_int4(packed, scale, torch.float32)
    manual = vals.float() * scale.repeat_interleave(256 // scale.shape[0], 0)
    torch.testing.assert_close(deq, manual, rtol=1e-5, atol=1e-5)


def test_gptq_int8_per_channel():
    W, H, X = _problem(2, K=128, N=64, M=512)
    Q, scale = gptq.gptq_round(torch.from_numpy(W), torch.from_numpy(H),
                               bits=8)
    assert tuple(scale.shape) == (64,)
    assert Q.min() >= -127 and Q.max() <= 127
    err_gptq = np.linalg.norm(X @ (W - (Q.float() * scale).numpy()))
    w_rtn = gptq.rtn_weight(torch.from_numpy(W), 8, 0).numpy()
    assert err_gptq <= np.linalg.norm(X @ (W - w_rtn)) * 1.001


def _calib(seed, B=2, N=6):
    r = np.random.default_rng(seed)
    ids = r.integers(1, VOCAB, size=(B, N, L))
    att = np.ones_like(ids)
    return ids, att, att.any(-1).astype(np.int64)


def _logits(tree, cfg, batch):
    return torch_bt.block_transformer_forward(
        tree, cfg, *(torch.from_numpy(a) for a in batch)).logits


def test_gptq_mixed_bits_and_skip_head():
    cfg = torch_cfg(make_cfg())
    params = bridge.params_from_numpy(jax_params(8), device="cpu")
    calib = [_calib(8, N=5)]
    tree = gptq.gptq_quantize_block_transformer(
        params, cfg, calib, bits=8, token_decoder_bits=4, lm_head_bits=8,
        device="cpu")
    assert "kernel_q8" in tree["block_decoder"]["layers"]["attn"]["qkv"]
    assert "kernel_q4" in tree["token_decoder"]["layers"]["attn"]["qkv"]
    assert "kernel_q4" in tree["token_decoder"]["expansion"]
    assert "kernel_q8" in tree["token_decoder"]["embed_out"]
    tree2 = gptq.gptq_quantize_block_transformer(params, cfg, calib, bits=4,
                                                 skip_lm_head=True,
                                                 device="cpu")
    assert "kernel" in tree2["token_decoder"]["embed_out"]
    assert torch.isfinite(_logits(tree, cfg, calib[0])).all()


@functools.lru_cache(maxsize=None)
def _driver_trees():
    """(JAX's GPTQ tree, the port's, the port's stats), INT4 g128 on
    ``make_cfg`` from 4 calibration batches."""
    params = jax_params(7)
    calib = [_calib(s) for s in range(4)]
    want = jax.device_get(jax_gptq.gptq_quantize_block_transformer(
        params, make_cfg(), calib, bits=4, group_size=128))
    stats = {}
    got = gptq.gptq_quantize_block_transformer(
        bridge.params_from_numpy(params, device="cpu"), torch_cfg(make_cfg()),
        calib, bits=4, group_size=128, device="cpu", stats=stats)
    return want, got, stats


def test_gptq_driver_equals_jax():
    want, got, stats = _driver_trees()
    flat_got = dict(torch_opt.tree_items(got))
    flat_want = {tuple(k.key for k in p): np.asarray(v) for p, v in
                 jax.tree_util.tree_leaves_with_path(want)}
    assert sorted(flat_got) == sorted(flat_want)
    n = equal = 0
    for path, w in flat_want.items():
        g = bridge.tensor_to_numpy(flat_got[path])
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path[-1] == "kernel_q4":
            a = quant.unpack_int4(torch.from_numpy(w.copy())).numpy().astype(int)
            b = quant.unpack_int4(torch.from_numpy(g)).numpy().astype(int)
            assert np.abs(a - b).max() <= 1, path
            n, equal = n + a.size, equal + int((a == b).sum())
        else:                   # scales, and the leaves GPTQ keeps
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                       err_msg=str(path))
    assert equal >= 0.999 * n, (equal, n)
    layers = stats["layer_errors"]
    assert len(layers) == 2 * 2 * 4            # 2 trunks x 2 layers x 4
    assert all(e["gptq"] < e["rtn"] for e in layers), layers
    assert all(stats[f"{t} rounding_s"] > 0
               for t in ("block_decoder", "token_decoder", "lm_head"))


def test_gptq_driver_beats_rtn_logits():
    """The port's GPTQ tree tracks the float logits closer than its RTN
    tree, on a held-out batch."""
    _, got, _ = _driver_trees()
    cfg = torch_cfg(make_cfg())
    params = bridge.params_from_numpy(jax_params(7), device="cpu")
    rtn = quant.quantize_block_transformer(params, bits=4, group_size=128)
    held_out = _calib(99)
    ref = _logits(params, cfg, held_out)
    mse = {name: float(((_logits(t, cfg, held_out) - ref) ** 2).mean())
           for name, t in (("gptq", got), ("rtn", rtn))}
    assert np.isfinite(mse["gptq"]) and mse["gptq"] < mse["rtn"], mse
