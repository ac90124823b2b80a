"""The port's optimizer and train step (``train/optimizer.py``,
``train/train_step.py``, ``data/packing.py``, the train-state bridge)
against the JAX package and optax, on the CPU.

Tolerances:
- the schedule: float32 on both sides, within 1e-7 relative;
- the optimizer fed the same gradients: float32 ops in optax's order, the
  global norm summed in another order, so each parameter leaf within 1e-6
  relative after 5 steps (clipping triggered and not);
- ``make_train_step`` from a JAX state bridged before each of 3 steps
  (plain and QAT ``mixed48``): loss and ``grad_norm`` within 1e-5
  relative; each leaf's update within 1e-4 relative in Frobenius norm over
  the coordinates whose gradient is exactly zero or rises above float32
  noise, ``sqrt(nu) > 1e-6 * max sqrt(nu)`` in the leaf (Adam's second
  moment after the step, JAX's), at least half of each leaf. Adam divides
  each gradient by its own root mean square, so a gradient that is zero in
  exact arithmetic moves its weight by the sign of its rounding noise. The
  key bias on the dimensions RoPE leaves alone is such a quarter of the
  qkv bias (softmax ignores a shift common to all keys), where JAX under
  ``jax.jit`` and JAX op by op differ as well; one such coordinate in an
  MLP kernel (a unit GELU shuts) can exceed the bound over the whole
  leaf. JAX's QAT step takes its fake-quant values op by op
  (``tests.test_torch_qat.jax_fake_quant``).
The layout helpers and the bridge are exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu.data import packing as jax_packing
from block_transformer_tpu.train import optimizer as jax_opt
from block_transformer_tpu.train import train_step as jax_ts
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.kernels import flash_attention
from block_transformer_tpu_torch.ops import attention as attention_ops
from block_transformer_tpu_torch.ops import masks
from block_transformer_tpu_torch.ops import quant as torch_quant
from block_transformer_tpu_torch.train import optimizer as torch_opt
from block_transformer_tpu_torch.train import train_step as torch_ts
from tests.test_block_parity import make_cfg
from tests.test_torch_kernels_gpu import GUARDED, grad_guard_cases
from tests.test_torch_qat import (jax_fake_quant, jax_params, torch_cfg,
                                  train_batch)

SCHEDULE_RTOL = 1e-7
OPT_RTOL = 1e-6
STEP_RTOL = 1e-5
UPDATE_RTOL = 1e-4
NOISE_FLOOR = 1e-6


def _flat(tree):
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 3, 10), (1e-4, 1, 10),
                                               (1e-3, 3000, 572000),
                                               (6e-4, 0, 50)])
def test_schedule_equals_optax(peak, warmup, total):
    _, want = jax_opt.make_optimizer(peak, warmup, total)
    _, got = torch_opt.make_optimizer(peak, warmup, total)
    mid = warmup + (total - warmup) // 2
    for count in sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1, mid,
                         total - 1, total, total + 7}):
        w = float(want(count))
        assert abs(got(count) - w) <= SCHEDULE_RTOL * abs(w), (count, w)
    assert got(0) == 0.0 or warmup == 0


def _small_tree(rng):
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"layers": {"ln1": {"scale": a(2, 8), "bias": a(2, 8)},
                       "attn": {"qkv": {"kernel": a(2, 8, 24),
                                        "bias": a(2, 24)}}},
            "final_ln": {"scale": a(8), "bias": a(8)},
            "embed_in": {"weight": a(16, 8)},
            "embed_out": {"kernel": a(8, 16)}}


def test_decay_mask_equals_jax():
    tree = _small_tree(np.random.default_rng(0))
    want = _flat(jax_opt._decay_mask(tree))
    assert torch_opt._decay_mask(tree) == {k: bool(v)
                                           for k, v in want.items()}


@pytest.mark.parametrize("clip", ["triggered", "not triggered"])
def test_optimizer_steps_equal_optax(clip):
    rng = np.random.default_rng(1)
    params = _small_tree(rng)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * (3.0 if clip == "triggered" else 0.01), params)
        for _ in range(5)]
    tx, _ = jax_opt.make_optimizer(1e-2, 2, 10)
    ttx, _ = torch_opt.make_optimizer(1e-2, 2, 10)
    state = tx.init(params)
    tparams = bridge.params_from_numpy(params, device="cpu")
    tstate = ttx.init(tparams)
    norms = []
    for g in grads:
        norms.append(float(jax.numpy.sqrt(sum(
            np.sum(x * x) for x in jax.tree.leaves(g)))))
        upd, state = tx.update(g, state, params)
        params = jax.device_get(jax.tree.map(lambda p, u: p + u, params,
                                             upd))
        tupd, tstate = ttx.update(bridge.params_from_numpy(g, device="cpu"),
                                  tstate, tparams)
        tparams = torch_opt.tree_map(lambda p, u: p + u, tparams, tupd)
    assert all((n > 1.0) == (clip == "triggered") for n in norms)
    assert tstate.count == 5
    got = dict(torch_opt.tree_items(bridge.params_to_numpy(tparams)))
    for path, w in _flat(params).items():
        err = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
        assert err <= OPT_RTOL, (path, err)
    for name in ("mu", "nu"):
        want = _flat(getattr(state[1][0], name))
        mine = dict(torch_opt.tree_items(bridge.params_to_numpy(
            getattr(tstate, name))))
        for path, w in want.items():
            err = np.linalg.norm(mine[path] - w) / np.linalg.norm(w)
            assert err <= OPT_RTOL, (name, path, err)


def test_batch_layout_equals_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 96, (3, 24))
    att = np.ones_like(ids)
    ids[1, :9], att[1, :9] = 0, 0
    att[2, -3:] = 0
    want = jax_packing.split_blocks(ids, att, 4)
    got = packing.split_blocks(ids, att, 4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(packing.add_labels(ids, att),
                                  jax_packing.add_labels(ids, att))
    batch = packing.make_train_batch_from_rows(ids, att, 4)
    np.testing.assert_array_equal(batch["labels"].reshape(3, 24),
                                  jax_packing.add_labels(ids, att))
    assert all(v.dtype == np.int32 for v in batch.values())


def _jax_state(seed, tx):
    """``create_train_state``'s state, from the cached jitted init."""
    params = jax_params(seed)
    return jax_ts.TrainState(params, jax.device_get(tx.init(params)),
                             np.int32(0))


def test_train_state_bridge_round_trip():
    tx, _ = jax_opt.make_optimizer(1e-3, 1, 10)
    state = _jax_state(0, tx)
    step = jax.jit(jax_ts.make_train_step(make_cfg(), tx))
    batch = {k: jnp.asarray(v) for k, v in train_batch(0).items()}
    state = jax.device_get(step(state, batch)[0])       # count 1, mu != 0
    back = bridge.train_state_to_numpy(
        bridge.train_state_from_numpy(state, device="cpu"), like=state)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(back.step) == 1 and int(back.opt_state[1][0].count) == 1


def _update_errors(p0, p_a, p_b, nu):
    """Per leaf that moved: ||(b - p0) - (a - p0)|| / ||a - p0|| over the
    coordinates of ``nu`` zero or above its noise floor, and their
    share."""
    out = {}
    for path, w0 in p0.items():
        ua, ub = p_a[path] - w0, p_b[path] - w0
        rms = np.sqrt(nu[path])
        live = (rms == 0) | (rms > NOISE_FLOOR * rms.max())
        n = np.linalg.norm(ua[live])
        if n > 0:
            out[path] = (float(np.linalg.norm((ub - ua)[live]) / n),
                         float(live.mean()))
    return out


@pytest.mark.parametrize("recipe", [None, "mixed48"])
def test_train_steps_match_jax(recipe):
    cfg = make_cfg()
    tx, _ = jax_opt.make_optimizer(1e-3, 1, 10)
    ttx, _ = torch_opt.make_optimizer(1e-3, 1, 10)
    deltas, transform = (lambda p: None), (lambda p, d: p)
    tt = None
    if recipe is not None:
        kw = dict(torch_quant.RECIPES[recipe], group_size=16)
        deltas, transform = jax_fake_quant(kw)
        tt = functools.partial(torch_quant.fake_quant_block_transformer,
                               **kw)
    j_step = jax.jit(lambda st, b, d: jax_ts.make_train_step(
        cfg, tx, param_transform=lambda p: transform(p, d))(st, b))
    t_step = torch_ts.make_train_step(torch_cfg(cfg), ttx, param_transform=tt)
    batch = train_batch(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = packing.to_device(batch, "cpu")
    state = _jax_state(4, tx)
    for _ in range(3):
        p0 = _flat(state.params)
        tstate, tm = t_step(bridge.train_state_from_numpy(state, "cpu"), tb)
        new, jm = jax.device_get(j_step(state, jb, deltas(state.params)))
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= STEP_RTOL * abs(
                float(jm[k])), (k, float(tm[k]), float(jm[k]))
        port = dict(torch_opt.tree_items(bridge.params_to_numpy(
            tstate.params)))
        errors = _update_errors(p0, _flat(new.params), port,
                                _flat(new.opt_state[1][0].nu))
        for path, (err, share) in errors.items():
            assert err <= UPDATE_RTOL and share >= 0.5, (path, err, share)
        assert tstate.step == int(new.step)
        state = new


def test_remat_leaves_values_unchanged():
    cfg = torch_cfg(make_cfg())
    params = bridge.params_from_numpy(_jax_state(5, jax_opt.make_optimizer(
        1e-3, 1, 10)[0]).params, device="cpu")
    batch = packing.to_device(train_batch(5), "cpu")
    out = []
    for remat in (False, True):
        live = {p: v.detach().clone().requires_grad_(True)
                for p, v in torch_opt.tree_items(params)}
        loss, _ = torch_ts.make_loss_fn(cfg, remat=remat)(
            torch_opt.tree_unflatten(live), batch)
        out.append((loss.detach(), torch.autograd.grad(loss,
                                                       list(live.values()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_attention_under_autograd_takes_the_plain_path(monkeypatch):
    calls = []
    real = flash_attention.flash_attention
    monkeypatch.setattr(flash_attention, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 16, 32), generator=g) for _ in range(3))
    pos = torch.arange(16, dtype=torch.int32)
    mask = masks.causal_mask(pos, pos)
    want = attention_ops.attention_xla(q, k, v, mask)
    with torch.no_grad():
        attention_ops.attention(q, k, v, mask)
    assert len(calls) == 1                   # inference: K3's wrapper
    q.requires_grad_(True)
    got = attention_ops.attention(q, k, v, mask)
    assert len(calls) == 1 and got.grad_fn is not None
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.no_grad():
        attention_ops.attention(q, k, v, mask)
    assert len(calls) == 2


@pytest.mark.parametrize("tag", GUARDED)
def test_wrappers_refuse_grad_on_the_cpu_too(tag):
    _, call = grad_guard_cases("cpu")[tag]
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    with torch.no_grad():
        call(True)
    call(False)
