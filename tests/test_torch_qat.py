"""QAT in the PyTorch port (``ops/quant.py``: ``_qdq_int8``, ``_qdq_int4``,
``_ste``, ``fake_quant_*``, ``RECIPES``) against the JAX package, on the CPU.

Tolerances: the fake-quant round trips and the fake-quant trees are float32
ops in the same order on both sides, so they are held bit for bit (as is
the round trip against the port's own ``quantize_*`` + ``dequantize_*``).
The QAT loss and its gradients (``train.train_step.make_loss_fn`` with
``param_transform``) are float32 models that differ in summation order:
loss within 1e-5 relative of ``jax.value_and_grad``, and each gradient leaf
within 1e-5 relative in Frobenius norm, on ``tests/test_block_parity``'s
``make_cfg``.

JAX's side runs under ``jax.jit``, with its fake-quant values taken op by
op (``jax_fake_quant``): compiled, XLA may turn the division by the
constant 7.0 or 127.0 into a product by its reciprocal, which moves a
weight across a rounding boundary now and then (one INT4 step on a qkv
kernel in one of the seeds tried), off the grid ``quantize_*`` rounds onto;
op by op JAX and the port agree bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu.train import train_step as jax_ts
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.ops import quant as torch_quant
from block_transformer_tpu_torch.train import optimizer as torch_opt
from block_transformer_tpu_torch.train import train_step as torch_ts
from scripts.qat_finetune import RECIPES as JAX_RECIPES
from tests.test_block_parity import L, VOCAB, make_cfg

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5


def torch_cfg(cfg):
    """The JAX package's BlockTransformerConfig -> the port's, field by
    field."""
    d = dataclasses.asdict(cfg)
    tc = torch_config
    td = d["token_decoder"]
    return tc.BlockTransformerConfig(**{
        **d, "embedder": tc.EmbedderConfig(**d["embedder"]),
        "block_decoder": tc.NeoXConfig(**d["block_decoder"]),
        "token_decoder": tc.TokenDecoderConfig(
            **{**td, "neox": tc.NeoXConfig(**td["neox"])})})


def train_batch(seed, B=2, T=24):
    """Token rows with a left-padded row, in the train step's layout."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, (B, T))
    att = np.ones_like(ids)
    ids[1, :5], att[1, :5] = 0, 0
    return packing.make_train_batch_from_rows(ids, att, L)


@functools.lru_cache(maxsize=None)
def jax_params(seed):
    """JAX's random parameters for ``make_cfg`` (numpy leaves)."""
    return jax.device_get(jax.jit(jax_bt.init_block_transformer_params,
                                  static_argnums=1)(jax.random.PRNGKey(seed),
                                                    make_cfg()))


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48), (256, 8)])
def test_qdq_int8_bit_exact(shape):
    w = _w(shape)
    fn = jax_quant._qdq_int8 if len(shape) == 2 else jax.vmap(
        jax_quant._qdq_int8)
    want = np.asarray(fn(jnp.asarray(w)))
    got = torch_quant._qdq_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    roundtrip = torch_quant.dequantize_int8(
        *torch_quant.quantize_int8(torch.from_numpy(w)), torch.float32)
    np.testing.assert_array_equal(got.numpy(), roundtrip.numpy())


@pytest.mark.parametrize("shape,gs", [((128, 40), 32), ((128, 40), 64),
                                      ((128, 40), 128), ((128, 40), 0),
                                      ((96, 16), 32), ((3, 256, 24), 64)])
def test_qdq_int4_bit_exact(shape, gs):
    w = _w(shape, 1)
    fn = functools.partial(jax_quant._qdq_int4, group_size=gs)
    if len(shape) == 3:
        fn = jax.vmap(fn)
    want = np.asarray(fn(jnp.asarray(w)))
    got = torch_quant._qdq_int4(torch.from_numpy(w), gs)
    np.testing.assert_array_equal(got.numpy(), want)
    roundtrip = torch_quant.dequantize_int4(
        *torch_quant.quantize_int4(torch.from_numpy(w), gs), torch.float32)
    np.testing.assert_array_equal(got.numpy(), roundtrip.numpy())


@pytest.mark.parametrize("bits", [8, 4])
def test_ste_forward_and_identity_gradient(bits):
    w, cot = _w((2, 64, 16), 2), _w((2, 64, 16), 3)
    node = {"kernel": jnp.asarray(w)}
    want = jax_quant.fake_quant_linear(node, bits, group_size=16)["kernel"]
    wt = torch.from_numpy(w).requires_grad_(True)
    got = torch_quant.fake_quant_linear({"kernel": wt}, bits, 16)["kernel"]
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), cot)


def test_recipes_are_the_scripts():
    assert torch_quant.RECIPES == JAX_RECIPES


def _kernel_paths(tree, path=()):
    if isinstance(tree, dict):
        out = {path: tree} if any(k.startswith("kernel") for k in tree) \
            else {}
        for k, v in tree.items():
            out.update(_kernel_paths(v, path + (k,)))
        return out
    return {}


@pytest.mark.parametrize("recipe", sorted(JAX_RECIPES))
def test_fake_quant_tree_equals_jax(recipe):
    """Every recipe: the port's fake-quant tree has JAX's leaves (paths and
    values, bit for bit), and changes exactly the kernels the real
    quantizer of the same recipe packs."""
    params = jax_params(0)
    kw = dict(JAX_RECIPES[recipe], group_size=16)
    # op by op, as the port computes it: under jit XLA may turn the
    # division by the constant 7.0 or 127.0 into a product (1 ulp apart)
    want = jax.device_get(jax_quant.fake_quant_block_transformer(params,
                                                                 **kw))
    tp = bridge.params_from_numpy(params, device="cpu")
    got = bridge.params_to_numpy(
        torch_quant.fake_quant_block_transformer(tp, **kw))
    flat_want = {tuple(k.key for k in p): np.asarray(v) for p, v in
                 jax.tree_util.tree_leaves_with_path(want)}
    flat_got = dict(torch_opt.tree_items(got))
    assert sorted(flat_got) == sorted(flat_want)
    for path, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[path], v, err_msg=str(path))
    real = _kernel_paths(torch_quant.quantize_block_transformer(tp, **kw))
    for path, node in _kernel_paths(got).items():
        changed = not np.array_equal(node["kernel"],
                                     _kernel_paths(params)[path]["kernel"])
        assert changed == ("kernel" not in real[path]), path


def jax_fake_quant(kw):
    """A JAX ``param_transform`` for jitted code equal to
    ``fake_quant_block_transformer(**kw)`` op by op: ``transform(params,
    deltas)`` adds ``stop_gradient(deltas)``, where ``deltas(params)`` (run
    outside jit) holds ``qdq(w) - w`` for each kernel the recipe takes and
    zeros elsewhere."""
    def deltas(params):
        ste = jax_quant._ste
        jax_quant._ste = lambda w, qdq: qdq - w
        try:
            out = jax_quant.fake_quant_block_transformer(params, **kw)
        finally:
            jax_quant._ste = ste
        return jax.tree.map(lambda d, w: np.zeros_like(w) if d is w
                            else np.asarray(d), out, params)

    def transform(params, d):
        return jax.tree.map(lambda w, x: w + jax.lax.stop_gradient(x),
                            params, d)

    return deltas, transform


def _jax_loss_and_grads(cfg, params, batch, kw):
    deltas, transform = jax_fake_quant(kw) if kw is not None else (
        lambda p: None, lambda p, d: p)

    def loss_fn(p, d, b):
        return jax_ts.make_loss_fn(cfg, remat=True, param_transform=(
            lambda q: transform(q, d)))(p, b)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, deltas(params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.device_get(metrics), jax.device_get(grads)


def _torch_loss_and_grads(cfg, params, batch, transform, remat=True):
    live = {p: v.requires_grad_(True) for p, v in torch_opt.tree_items(
        bridge.params_from_numpy(params, device="cpu"))}
    loss_fn = torch_ts.make_loss_fn(cfg, remat=remat,
                                    param_transform=transform)
    loss, metrics = loss_fn(torch_opt.tree_unflatten(live),
                            packing.to_device(batch, "cpu"))
    grads = torch.autograd.grad(loss, list(live.values()))
    return (float(loss.detach()),
            {k: v.detach().numpy() for k, v in metrics.items()},
            dict(zip(live, (g.numpy() for g in grads))))


def _assert_grads_close(want, got):
    flat = {tuple(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(want)}
    assert sorted(flat) == sorted(got)
    for path, g in flat.items():
        err = np.linalg.norm(got[path] - g) / max(np.linalg.norm(g), 1e-30)
        assert err <= GRAD_RTOL, (path, err)


@pytest.mark.parametrize("recipe", [None, *sorted(JAX_RECIPES),
                                    "mixed48 g16"])
def test_qat_loss_and_grads_match_jax(recipe):
    cfg = make_cfg()
    params = jax_params(3)
    batch = train_batch(3)
    kw = tt = None
    if recipe is not None:
        name, *gs = recipe.split()
        kw = dict(JAX_RECIPES[name], **({"group_size": int(gs[0][1:])}
                                        if gs else {}))
        tt = functools.partial(torch_quant.fake_quant_block_transformer,
                               **kw)
    loss_j, metrics_j, grads_j = _jax_loss_and_grads(cfg, params, batch, kw)
    loss_t, metrics_t, grads_t = _torch_loss_and_grads(
        torch_cfg(cfg), params, batch, tt)
    assert abs(loss_t - loss_j) <= LOSS_RTOL * abs(loss_j)
    np.testing.assert_allclose(metrics_t["loss_by_position"],
                               metrics_j["loss_by_position"], rtol=LOSS_RTOL)
    _assert_grads_close(grads_j, grads_t)
