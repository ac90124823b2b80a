"""K5 and K7 fused with the INT8 KV quantization, held against the JAX
package on the CPU.

The port quantizes a decode step's K and V and writes them in one launch
(``kernels/paged_attention.py``: ``paged_quantize_write_int8``,
``paged_quantize_step_int8``, ``paged_quantize_write_layers_int8``); JAX
runs ``models/neox.py`` ``quantize_kv`` and then the Pallas K5 / K7
(interpret mode) or, at an int position, slice updates. On the CPU each
wrapper runs its plain version, which must equal JAX's two steps bit for
bit: pools, scales, step buffers and the dequantized fresh pair.

Inputs are made with numpy. bf16 inputs are float32 values rounded to bf16,
handed to JAX as those float32 values (JAX's ``quantize_kv`` widens to
float32 first). The port drops a write whose target is out of range (off ==
cap, page -1), where the Pallas index map would go out of bounds; JAX is
run on the in-range rows only, and the dropped rows are checked against the
untouched pool.

The spy tests show which entries ``neox_stack`` calls: one fused launch a
layer-step at S == 1 on an INT8 cache (int or per-row ``write_pos``), L on
the paged INT8 pool with no separate K7, and none for S > 1 or INT4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.ops import paged_attention as jax_pa
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.kernels import paged_attention as kp
from block_transformer_tpu_torch.models import neox as torch_neox
from block_transformer_tpu_torch.ops import masks as torch_masks

DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(rng, L, P, H, ps, D):
    return (rng.integers(-127, 128, (L, P, H, ps, D)).astype(np.int8),
            rng.uniform(0.01, 0.02, (L, P, H, ps)).astype(np.float32),
            rng.integers(-127, 128, (L, P, H, ps, D)).astype(np.int8),
            rng.uniform(0.01, 0.02, (L, P, H, ps)).astype(np.float32))


def _rows(rng, B, H, D, dtype):
    """(k, v, k values, v values): k contiguous [B, H, D]; v a strided view
    of a fused qkv output [B, 1, 3 * H * D], as ``layer_qkv`` cuts it; the
    float32 values of both as JAX gets them."""
    k = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    qkv = torch.from_numpy(
        2.0 * rng.normal(size=(B, 1, 3 * H * D)).astype(np.float32))
    k, qkv = k.to(dtype), qkv.to(dtype)
    v = qkv.reshape(B, 1, 3, H, D).permute(2, 0, 3, 1, 4)[2][:, :, 0]
    assert not v.is_contiguous() and v.stride(-1) == 1
    return k, v, k.float().numpy(), v.float().numpy()


def _jax_quantized(x):
    """JAX's quantize_kv of [B, H, D] rows: (int8 [B, H, D], f32 [B, H])."""
    q, s = jax_neox.quantize_kv(jnp.asarray(x)[:, :, None])
    return np.asarray(q)[:, :, 0], np.asarray(s)[:, :, 0]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("table", ["pages", "identity"])
def test_k5_fused_matches_quantize_then_pallas(table, D, dtype):
    """Form (a): distinct pages with one page -1, or the contiguous cache's
    identity table (page None); ragged offsets with one at off == cap."""
    rng = np.random.default_rng(17 + D)
    L, B, H = 3, 5, 4
    if table == "pages":
        P, ps = 9, 16
        page = rng.permutation(np.arange(1, P))[:B].astype(np.int32)
        page[2] = -1
    else:
        P, ps = B, 32
        page = np.arange(B, dtype=np.int32)
    off = rng.integers(0, ps, B).astype(np.int32)
    off[4] = ps
    pools = _pools(rng, L, P, H, ps, D)
    k, v, kx, vx = _rows(rng, B, H, D, DTYPES[dtype])
    layer = 1
    got = kp.paged_quantize_write_int8(
        *map(_t, pools), layer, _t(page) if table == "pages" else None,
        _t(off), k, v)
    ok = (page >= 0) & (off < ps)
    kq, ks = _jax_quantized(kx)
    vq, vs = _jax_quantized(vx)
    want = jax_pa.paged_write_int8(
        *map(jnp.asarray, pools), layer, jnp.asarray(page[ok]),
        jnp.asarray(off[ok]), *(jnp.asarray(a[ok]) for a in (kq, ks, vq, vs)),
        interpret=True)
    _equal(got, want)
    for g, old in zip(got, pools):       # the dropped rows wrote nothing
        for b in np.flatnonzero(~ok):
            if page[b] >= 0:
                np.testing.assert_array_equal(g[:, page[b]].numpy(),
                                              old[:, page[b]])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [64, 128])
def test_k5_fused_int_offset_matches_slice_write(D, dtype):
    """An int ``write_pos`` (generation, the baseline): the contiguous cache
    [L, B, H, cap, D] written at one position for every row, as JAX's
    ``_write_kv`` writes it with ``dynamic_update_slice``."""
    rng = np.random.default_rng(29 + D)
    L, B, H, cap = 3, 4, 4, 16
    pools = _pools(rng, L, B, H, cap, D)
    k, v, kx, vx = _rows(rng, B, H, D, DTYPES[dtype])
    layer, pos = 2, 11
    got = kp.paged_quantize_write_int8(*map(_t, pools), layer, None, pos, k,
                                       v)
    kq, ks = _jax_quantized(kx)
    vq, vs = _jax_quantized(vx)
    want = [jax_neox._write_kv(jnp.asarray(buf), jnp.asarray(new)[:, :, None],
                               layer, pos)
            for buf, new in zip(pools, (kq, ks, vq, vs))]
    _equal(got, want)


def _deferred_case(rng, L, B, H, D, dtype):
    """The paged engine's step: pools [L, 9, H, 16, D], rows on distinct
    pages, one finished row on page 0, one past its virtual pages (page
    -1); the layers' K and V rows."""
    P, ps = 9, 16
    pools = _pools(rng, L, P, H, ps, D)
    page = rng.permutation(np.arange(1, P))[:B].astype(np.int32)
    page[0], page[3] = 0, -1
    off = rng.integers(0, ps, B).astype(np.int32)
    layers = [_rows(rng, B, H, D, DTYPES[dtype]) for _ in range(L)]
    return pools, page, off, layers


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [64, 128])
def test_k7_fused_matches_deferred_body(D, dtype):
    """Forms (b) and (c) against JAX's deferred body: ``quantize_kv`` a
    layer, the dequantized fresh pair, then ``paged_write_layers_int8``
    after the layers: step buffers, fresh pairs and pools bit for bit."""
    rng = np.random.default_rng(41 + D)
    L, B, H = 3, 5, 4
    pools, page, off, layers = _deferred_case(rng, L, B, H, D, dtype)
    t_pools = list(map(_t, pools))
    step_q = torch.zeros((2, L, B, H, D), dtype=torch.int8)
    step_s = torch.zeros((2, L, B, H), dtype=torch.float32)
    fresh = []
    for i, (k, v, _, _) in enumerate(layers):
        if i < L - 1:
            fresh.append(kp.paged_quantize_step_int8(step_q, step_s, i, k, v))
            for g, old in zip(t_pools, pools):     # no pool write yet
                np.testing.assert_array_equal(g.numpy(), old)
        else:
            fresh.append(kp.paged_quantize_write_layers_int8(
                *t_pools, _t(page), _t(off), step_q, step_s, k, v))
    steps = [(*_jax_quantized(kx), *_jax_quantized(vx))
             for _, _, kx, vx in layers]           # (kq, ks, vq, vs) a layer
    for i, (kq, ks, vq, vs) in enumerate(steps):
        _equal((step_q[0, i], step_s[0, i], step_q[1, i], step_s[1, i]),
               (kq, ks, vq, vs))
        kf = (jnp.asarray(kq).astype(jnp.float32)
              * jnp.asarray(ks)[..., None].astype(jnp.float32))
        vf = (jnp.asarray(vq).astype(jnp.float32)
              * jnp.asarray(vs)[..., None].astype(jnp.float32))
        _equal(fresh[i], (kf, vf))
    ok = page >= 0
    stacked = [np.stack([s[j] for s in steps])[:, ok] for j in range(4)]
    want = jax_pa.paged_write_layers_int8(
        *map(jnp.asarray, pools), jnp.asarray(page[ok]), jnp.asarray(off[ok]),
        *map(jnp.asarray, stacked), interpret=True)
    _equal(t_pools, want)


def _stack(L=3, H=4, D=32):
    cfg = torch_config.NeoXConfig.from_hidden_layers(
        H * D, L, vocab_size=64, num_heads=H)
    params = torch_neox.init_neox_params(
        torch.Generator().manual_seed(0), cfg, with_embed_in=False,
        with_lm_head=False, device="cpu")
    return cfg, params


def _spy(monkeypatch):
    """Count the calls of the write entries ``neox_stack`` may reach; each
    call goes on to the entry itself."""
    calls = {}
    for name in ("paged_quantize_write_int8", "paged_quantize_step_int8",
                 "paged_quantize_write_layers_int8", "paged_write_int8",
                 "paged_write_layers_int8"):
        fn = getattr(kp, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)

        monkeypatch.setattr(kp, name, spy)
    return calls


@pytest.mark.parametrize("cache,S,pos", [
    ("int8", 1, "int"), ("int8", 1, "rows"), ("paged", 1, "rows"),
    ("int8", 3, "int"), ("int8", 3, "rows"), ("paged", 3, "rows"),
    ("int4", 1, "int"), ("int4", 1, "rows"), ("paged-int4", 1, "rows")])
def test_stack_calls_the_fused_writes(monkeypatch, cache, S, pos):
    """At S == 1 on an INT8 cache, one fused launch a layer: form (a) on the
    contiguous cache, (b) for layers < L - 1 and (c) for the last on the
    paged pool, and no separate K5 or K7 call. S > 1 and the INT4 caches
    call none of them."""
    cfg, params = _stack()
    L, B, cap = cfg.num_layers, 3, 16
    bits = 4 if cache.endswith("int4") else 8
    if cache.startswith("paged"):
        c = torch_neox.PagedKVCache.create(cfg, B, cap, n_pages=B * 4 + 1,
                                           page_size=4, bits=bits,
                                           device="cpu")
        c = c._replace(page_table=1 + torch.arange(
            B * 4, dtype=torch.int32).reshape(B, 4))
    else:
        c = torch_neox.make_kv_cache(cfg, B, cap, cache, device="cpu")
    wp = 5 if pos == "int" else torch.tensor([5, 0, 9], dtype=torch.int32)
    base = torch.full((B,), 5) if pos == "int" else wp
    q_idx = (base[:, None] + torch.arange(S)).to(torch.int32)
    mask = torch_masks.AttnMask(q_idx, torch.arange(cap, dtype=torch.int32),
                                torch.ones((B, cap), dtype=torch.int32))
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(B, S, cfg.hidden_size)).astype(np.float32))
    calls = _spy(monkeypatch)
    with torch.no_grad():
        torch_neox.neox_stack(params, x, cfg=cfg, mask=mask, positions=q_idx,
                              cache=c, write_pos=wp)
    if S == 1 and cache == "int8":
        want = {"paged_quantize_write_int8": L}
    elif S == 1 and cache == "paged":
        want = {"paged_quantize_step_int8": L - 1,
                "paged_quantize_write_layers_int8": 1}
    else:
        want = {}
    assert calls == want
