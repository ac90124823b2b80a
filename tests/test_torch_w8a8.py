"""W8A8 in the PyTorch port against the JAX package, on the CPU.

The port's plain versions of W8A8-q and W8A8-mm (``kernels/w8a8.py``), and
``apply_linear`` when it takes W8A8, must equal the JAX package's
``_w8a8_dot`` bit for bit: the activation quant (xq, sx), the int32 product
and the output, in float32 and bf16, with a zero row and a ragged M. The
dispatch decisions (``_use_w8a8``) must be the JAX package's under every KV
mode and around both floors; greedy tokens of generation and of the serving
engine with W8A8 forced must be equal. The JAX side runs with
``linear._on_tpu`` patched to True, as ``tests/test_w8a8_dispatch.py`` does,
and with its jit caches cleared around each such test (the W8A8 decision is
taken while tracing); the port's side patches its own gate,
``linear._on_card``, so that the CPU tensors take W8A8 through the plain
versions. INT8 weights only: with ``_on_tpu`` patched, JAX would send INT4
weights to a Pallas kernel outside interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_block_parity import VOCAB, make_cfg
from block_transformer_tpu import config as jax_config
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.inference.engine import (
    ContinuousBatchingEngine as JaxEngine)
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.ops import linear as jax_linear
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import engine as torch_engine
from block_transformer_tpu_torch.inference import generate as torch_gen
from block_transformer_tpu_torch.kernels import w8a8
from block_transformer_tpu_torch.ops import linear as torch_linear

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture
def jax_w8a8(monkeypatch):
    """JAX takes its TPU dispatch (W8A8 by its floors, or at every M with
    BT_W8A8_M_MIN=1), with fresh jit caches; the port takes W8A8 on the
    CPU."""
    monkeypatch.setattr(jax_linear, "_on_tpu", lambda: True)
    monkeypatch.delenv("BT_W8A8", raising=False)
    monkeypatch.delenv("BT_W8A8_M_MIN", raising=False)
    monkeypatch.setattr(torch_linear, "_on_card", lambda x: True)
    jax.clear_caches()
    yield monkeypatch
    jax.clear_caches()


def _case(dtype, M, K, N, L=3, seed=0):
    """x [M, K] (row 1 zero, one row scaled up), INT8 weights [L, K, N] and
    scales, as numpy (x in float32, exact in bf16 when dtype is)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[1] = 0.0
    x[-1] *= 40.0
    if dtype == torch.bfloat16:
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = rng.integers(-127, 128, (L, K, N)).astype(np.int8)
    scale = (0.001 + 0.01 * rng.random((L, N))).astype(np.float32)
    return x, w, scale


def _jax_parts(x2, w_q):
    """The steps of JAX's ``_w8a8_dot``, written out: (xq, sx, acc)."""
    amax = jnp.max(jnp.abs(x2), axis=-1, keepdims=True)
    sx = amax.astype(jnp.float32) / 127.0 + 1e-12
    xq = jnp.round(x2.astype(jnp.float32) / sx).astype(jnp.int8)
    acc = jax.lax.dot_general(xq, w_q, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(sx)[:, 0], np.asarray(acc)


def _np(t: torch.Tensor):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp_np(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(96, 2048, 384), (37, 256, 48)])
def test_plain_versions_bit_exact_with_jax(M, K, N, dtype):
    """xq, sx, the int32 product and the output of layer 2, bit for bit."""
    x, w, scale = _case(dtype, M, K, N)
    xj = jnp.asarray(x, JNP[dtype])
    xq_j, sx_j, acc_j = _jax_parts(xj, jnp.asarray(w[2]))
    out_j = jax_linear._w8a8_dot(xj, jnp.asarray(w[2]), jnp.asarray(scale[2]))
    xt = torch.from_numpy(x).to(dtype)
    xq, sx = w8a8.w8a8_quant_plain(xt)
    np.testing.assert_array_equal(xq.numpy(), xq_j)
    np.testing.assert_array_equal(sx.numpy(), sx_j)
    assert (xq[1] == 0).all() and sx[1].item() == np.float32(1e-12)
    assert xq.abs().max().item() == 127
    np.testing.assert_array_equal(
        w8a8.int_product(xq, torch.from_numpy(w[2])).numpy(), acc_j)
    out = w8a8.w8a8_matmul_stacked_plain(xq, sx, torch.from_numpy(w),
                                         torch.from_numpy(scale), 2, dtype)
    assert out.dtype == dtype
    np.testing.assert_array_equal(_np(out), _jnp_np(out_j))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stacked", [True, False])
def test_apply_linear_w8a8_bit_exact_with_jax(stacked, dtype, jax_w8a8):
    """A stacked and a single ``kernel_q8`` node with a bias against JAX's
    ``apply_linear``, M = 2 x 21 rows: with a floor of 40 both take W8A8,
    with 43 both the dequant product."""
    x, w, scale = _case(dtype, 42, 128, 64)
    bias = np.random.default_rng(1).standard_normal((3, 64)).astype(
        np.float32)
    x3 = x.reshape(2, 21, 128)
    node = {"kernel_q8": w, "scale": scale, "bias": bias}
    if stacked:
        pj = jax_linear.StackedLinear(
            {k: jnp.asarray(v) for k, v in node.items()}, jnp.int32(1))
        pt = torch_linear.StackedLinear(
            {k: torch.from_numpy(v) for k, v in node.items()}, 1)
    else:
        pj = {k: jnp.asarray(v[1]) for k, v in node.items()}
        pt = {k: torch.from_numpy(v[1]) for k, v in node.items()}
    calls = []
    dot = torch_linear._w8a8_dot
    jax_w8a8.setattr(torch_linear, "_w8a8_dot",
                     lambda *a: calls.append(a[0].shape) or dot(*a))
    xj, xt = jnp.asarray(x3, JNP[dtype]), torch.from_numpy(x3).to(dtype)
    for floor in (40, 43):
        jax_w8a8.setenv("BT_W8A8_M_MIN", str(floor))
        with torch_linear.w8a8_min_m(floor):
            got = torch_linear.apply_linear(xt, pt)
        want = jax_linear.apply_linear(xj, pj)
        assert got.shape == (2, 21, 64) and got.dtype == dtype
        np.testing.assert_array_equal(_np(got), _jnp_np(want))
    assert calls == [(42, 128)]                  # floor 40 only
    # W8A8 and the dequant product differ: the test tells them apart
    with torch_linear.w8a8_min_m(1):
        a = torch_linear.apply_linear(xt, pt)
    np.testing.assert_raises(AssertionError, np.testing.assert_array_equal,
                             _np(a), _np(got))


@pytest.mark.parametrize("m", [1, 256, 383, 384, 385, 2047, 2048, 2049,
                               10 ** 6])
@pytest.mark.parametrize("mode", [None, "bf16", "int8", "int4"])
def test_use_w8a8_decisions_equal_jax(mode, m, jax_w8a8):
    with jax_linear.kv_mode(mode), torch_linear.kv_mode(mode):
        assert torch_linear._use_w8a8(m) == jax_linear._use_w8a8(m)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_switches_equal_jax_env(mode, jax_w8a8):
    """``w8a8_min_m(n)`` is BT_W8A8_M_MIN=n (it wins over the KV mode) and
    ``w8a8_disabled()`` is BT_W8A8=0 (it wins over both)."""
    for n in (1, 100, 5000):
        jax_w8a8.setenv("BT_W8A8_M_MIN", str(n))
        with jax_linear.kv_mode(mode), torch_linear.kv_mode(mode), \
                torch_linear.w8a8_min_m(n):
            for m in (1, 99, 100, 384, 2048, 4999, 5000):
                assert torch_linear._use_w8a8(m) == jax_linear._use_w8a8(m)
        jax_w8a8.setenv("BT_W8A8", "0")
        with torch_linear.w8a8_min_m(n), torch_linear.w8a8_disabled():
            assert not torch_linear._use_w8a8(10 ** 6)
            assert not jax_linear._use_w8a8(10 ** 6)
        jax_w8a8.delenv("BT_W8A8")


def test_contexts_restore_on_exit():
    assert not torch_linear._use_w8a8(383) and torch_linear._use_w8a8(384)
    with torch_linear.kv_mode("int8"):
        with torch_linear.w8a8_min_m(10):
            assert torch_linear._use_w8a8(10)
            with torch_linear.w8a8_disabled():
                assert not torch_linear._use_w8a8(10 ** 6)
            assert torch_linear._use_w8a8(10)
        assert not torch_linear._use_w8a8(2047)
        assert torch_linear._use_w8a8(2048)
    with pytest.raises(RuntimeError):
        with torch_linear.w8a8_disabled():
            raise RuntimeError("inside")
    assert torch_linear._use_w8a8(384) and not torch_linear._use_w8a8(383)


def test_cpu_tensors_never_take_w8a8_unasked(monkeypatch):
    """On the CPU the gate is closed: a prefill-sized INT8 linear runs K1's
    plain version (the existing CPU parity keeps its numerics)."""
    seen = []
    monkeypatch.setattr(torch_linear, "_w8a8_dot",
                        lambda *a: seen.append(a) or None)
    x, w, scale = _case(torch.float32, 4096, 32, 16, L=1)
    out = torch_linear.apply_linear(
        torch.from_numpy(x), torch_linear.StackedLinear(
            {"kernel_q8": torch.from_numpy(w),
             "scale": torch.from_numpy(scale)}, 0))
    assert out.shape == (4096, 16) and not seen


def _b4_5_models():
    """``block_main_b4_5``'s widths (hidden 256, 3 + 3 layers), the vocab
    cut to 512 to keep the CPU run short; INT8 weights."""
    cfg = jax_config.get_config("block_main_b4_5", vocab_size=512)
    tcfg = torch_config.get_config("block_main_b4_5", vocab_size=512)
    pj = jax_quant.quantize_block_transformer(
        jax_bt.init_block_transformer_params(jax.random.PRNGKey(5), cfg),
        bits=8)
    pj = jax.device_get(pj)
    return cfg, tcfg, pj, bridge.params_from_numpy(pj, device="cpu")


def test_block_main_b4_5_w8a8_greedy_tokens_equal(jax_w8a8):
    """Every INT8 linear through W8A8 (forced at every M) on both sides,
    INT8 KV cache: greedy tokens equal, and W8A8 really ran in the port."""
    cfg, tcfg, pj, pt = _b4_5_models()
    rng = np.random.default_rng(5)
    B, N, L = 2, 6, cfg.block_length
    ids = rng.integers(1, cfg.vocab_size, (B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, 0], att[1, 0] = 0, 0
    bam = att.any(-1).astype(np.int32)
    jax_w8a8.setenv("BT_W8A8_M_MIN", "1")
    rj = jax_gen.generate_blocks(pj, cfg, jnp.asarray(ids), jnp.asarray(att),
                                 jnp.asarray(bam), max_blocks=N + 4,
                                 kv_cache="int8")
    calls = []
    dot = torch_linear._w8a8_dot
    jax_w8a8.setattr(torch_linear, "_w8a8_dot",
                     lambda *a: calls.append(a[0].shape[0]) or dot(*a))
    with torch_linear.w8a8_min_m(1):
        rt = torch_gen.generate_blocks(pt, tcfg, ids, att, bam,
                                       max_blocks=N + 4, kv_cache="int8",
                                       device="cpu")
    assert calls and min(calls) <= B
    assert rt.n_blocks == int(rj.n_blocks)
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    np.testing.assert_array_equal(rt.unfinished.numpy(),
                                  np.asarray(rj.unfinished))


# the engine: the small configuration of tests/test_engine.py, INT8 weights
PROMPTS = (8, 12, 4, 9, 6)
BUDGETS = (6, 9, 5, 14, 3)


@pytest.fixture(scope="module")
def engine_models():
    cfg = make_cfg()
    tcfg = torch_config.BlockTransformerConfig.from_dict(
        dataclasses.asdict(cfg))
    pj = jax.device_get(jax_quant.quantize_block_transformer(
        jax_bt.init_block_transformer_params(jax.random.PRNGKey(0), cfg),
        bits=8))
    return cfg, tcfg, pj, bridge.params_from_numpy(pj, device="cpu")


def _serve(engine):
    rng = np.random.default_rng(0)
    for n, m in zip(PROMPTS, BUDGETS):
        engine.submit(rng.integers(1, VOCAB, size=n), m)
    reqs = list(engine.waiting)
    engine.run(max_steps=200)
    assert not engine.has_work()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("kind", ["int8", "paged"])
def test_engine_w8a8_tokens_and_stats_equal_jax(kind, engine_models,
                                                jax_w8a8):
    cfg, tcfg, pj, pt = engine_models
    kw = dict(n_slots=3, max_blocks=12, kv_cache=kind, sync_blocks=3,
              bucket_blocks=2)
    if kind == "paged":
        kw.update(page_size=4, pool_pages=5)
    jax_w8a8.setenv("BT_W8A8_M_MIN", "1")
    jax_eng = JaxEngine(pj, cfg, **kw)
    want = _serve(jax_eng)
    port_eng = torch_engine.ContinuousBatchingEngine(pt, tcfg, device="cpu",
                                                     **kw)
    with torch_linear.w8a8_min_m(1):
        got = _serve(port_eng)
    assert got == want and all(got)
    assert dataclasses.asdict(port_eng.stats) == dataclasses.asdict(
        jax_eng.stats)


@pytest.mark.parametrize("kind,declared", [
    ("bf16", "bf16"), ("int8", "int8"), ("int4", "int4"),
    ("paged", "int8"), ("paged-int4", "int8")])
def test_engine_declares_the_jax_kv_mode(kind, declared, engine_models,
                                         monkeypatch):
    """Every W8A8 decision of admission and decode sees the KV mode the
    JAX engine declares: the cache kind, and int8 for either paged pool."""
    _, tcfg, _, pt = engine_models
    monkeypatch.setattr(torch_linear, "_on_card", lambda x: True)
    seen = []
    use = torch_linear._use_w8a8
    monkeypatch.setattr(torch_linear, "_use_w8a8", lambda m: seen.append(
        torch_linear._KV_MODE.get()) or use(m))
    kw = dict(page_size=4, pool_pages=5) if kind.startswith("paged") else {}
    eng = torch_engine.ContinuousBatchingEngine(
        pt, tcfg, n_slots=3, max_blocks=12, kv_cache=kind, sync_blocks=3,
        bucket_blocks=2, device="cpu", **kw)
    eng.submit(np.arange(1, 9), 6)
    eng.run(max_steps=20)
    assert seen and set(seen) == {declared}


# ---------------------------------------------------------------------------
# A lane-level model of W8A8-mm's design (csrc/w8a8.cu, w8a8_wgmma_kernel)
# ---------------------------------------------------------------------------

BT, BW, BK = 128, 128, 128      # tokens, a warpgroup's weight columns, K step


def _sw128(addr):
    """Shared-memory byte ``addr`` (from a 1024-byte aligned base) after the
    128-byte swizzle that TMA writes and wgmma's SW128 descriptors read:
    address bits 4-6 ^= bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the eight bytes of (x, y)."""
    b = [(x >> 8 * i) & 0xFF for i in range(4)] + \
        [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(sel >> 4 * i) & 7] << 8 * i for i in range(4))


def _word(mem, addr):
    return int.from_bytes(bytes(mem[addr:addr + 4]), "little")


def _bytes(word):
    return np.frombuffer(int(word).to_bytes(4, "little"), np.int8)


def _tma_box(rows):
    """A [r, 128] int8 box as TMA writes it with the 128-byte swizzle."""
    mem = np.zeros(rows.size, np.uint8)
    flat = rows.view(np.uint8).reshape(-1)
    mem[[_sw128(a) for a in range(rows.size)]] = flat
    return mem


@pytest.mark.parametrize("wg", [0, 1])
def test_w8a8_mm_fragments_lane_model(wg):
    """One stage of one consumer warpgroup (weight columns 128 wg.. of the
    256-column tile), lane by lane: TMA's swizzled boxes of xq ([128
    tokens][128 k]) and of the weights ([128 k][128 columns]); each
    thread's 4 x 4 byte loads at the kernel's turned row offsets and the
    __byte_perm transpose with its runtime selectors; wgmma m64n128k32's s8
    A-register fragments and its B operand read through the SW128 K-major
    descriptor (rows of 128 bytes, SBO 1024, start + 32 bytes a k32 step);
    the accumulator layout and the epilogue's map from (m-tile, register)
    to output column give x @ w for the whole 128 x 128 block; and every
    load instruction of a warp touches 32 distinct banks."""
    rng = np.random.default_rng(wg)
    x = rng.integers(-127, 128, (BT, BK)).astype(np.int8)     # tokens x k
    w = rng.integers(-127, 128, (BK, 2 * BW)).astype(np.int8)  # k x columns
    xs = _tma_box(x)
    ws = _tma_box(np.ascontiguousarray(w[:, BW * wg:BW * (wg + 1)]))
    want = x.astype(np.int64) @ w[:, BW * wg:BW * (wg + 1)].astype(np.int64)
    got = np.zeros((BT, BW), np.int64)
    for wi in range(4):                                 # warps of the group
        acc = np.zeros((2, 32, 64), np.int64)           # [mt][lane][reg]
        off = np.zeros((32, 4), np.int64)
        for ln in range(32):
            g, t = ln >> 2, ln & 3
            for j in range(4):
                row = 4 * t + ((j + 2 * (t >> 1)) & 3)
                off[ln, j] = (row * 128
                              + (((2 * wi + (g >> 2)) ^ (row & 7)) << 4)
                              + 4 * (g & 3))
        for ks in range(BK // 32):
            a = np.zeros((2, 32, 4), np.int64)          # [mt][lane][reg]
            for h in range(2):
                rows = (32 * ks + 16 * h) * 128
                for j in range(4):                      # one ld.shared each
                    banks = {(rows + off[ln, j]) // 4 % 32 for ln in range(32)}
                    assert len(banks) == 32
                for ln in range(32):
                    t = ln & 3
                    r = [_word(ws, rows + off[ln, j]) for j in range(4)]
                    lo, hi = (0x1054, 0x3276) if t & 2 else (0x5410, 0x7632)
                    t0 = _byte_perm(r[0], r[1], 0x5140)
                    t1 = _byte_perm(r[0], r[1], 0x7362)
                    t2 = _byte_perm(r[2], r[3], 0x5140)
                    t3 = _byte_perm(r[2], r[3], 0x7362)
                    c = [_byte_perm(t0, t2, lo), _byte_perm(t0, t2, hi),
                         _byte_perm(t1, t3, lo), _byte_perm(t1, t3, hi)]
                    a[0, ln, 2 * h:2 * h + 2] = c[0:2]
                    a[1, ln, 2 * h:2 * h + 2] = c[2:4]
            # B [32 k, 128 tokens] through the descriptor
            B = np.zeros((32, BT), np.int64)
            for n in range(BT):
                for k in range(32):
                    addr = 32 * ks + (n // 8) * 1024 + (n % 8) * 128 + k
                    B[k, n] = np.int8(xs[_sw128(addr)].view(np.int8))
            for mt in range(2):                         # this warp's 16 rows
                A = np.zeros((16, 32), np.int64)
                for ln in range(32):
                    g, t = ln >> 2, ln & 3
                    for i, (r0, c0) in enumerate([(0, 0), (8, 0), (0, 16),
                                                  (8, 16)]):
                        A[g + r0, c0 + 4 * t:c0 + 4 * t + 4] = \
                            _bytes(a[mt, ln, i])
                D = A @ B
                for ln in range(32):
                    g, t = ln >> 2, ln & 3
                    for j in range(BT // 8):
                        for e in range(4):
                            acc[mt, ln, 4 * j + e] += D[g + 8 * (e >> 1),
                                                        8 * j + 2 * t + (e & 1)]
        for ln in range(32):                            # the epilogue's map
            g, t = ln >> 2, ln & 3
            n = 32 * wi + 4 * g
            for j in range(BT // 8):
                for e in range(2):
                    tok = 8 * j + 2 * t + e
                    got[tok, n:n + 4] = [acc[0, ln, 4 * j + e],
                                         acc[0, ln, 4 * j + 2 + e],
                                         acc[1, ln, 4 * j + e],
                                         acc[1, ln, 4 * j + 2 + e]]
    np.testing.assert_array_equal(got, want)
