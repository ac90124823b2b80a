"""The port's tensor-parallel generator against the JAX package's, on the CPU.

Four gloo ranks (``tests/torch_mesh_ranks.py``, no JAX imported there) run
``make_tp_generate_blocks`` over a (data 2, model 2) mesh and a (dcn 2,
data 1, model 2) one, from the JAX trees bridged to tensors (the small
float32 configuration of ``tests/test_tp_decode.py``: float, INT8 and
group-wise INT4 weights; bf16 and INT8 global caches; one and two
streams). Greedy tokens must equal JAX's ``make_tp_generate_blocks`` over
the same mesh shape on 4 of the test process's CPU devices, and the port's
single-device ``generate_blocks``. The ranks also run the top-1 pick on
built ties (lowest index wins, across and within shards), sampled decoding
(two generators; the same prompt in every row, so that the data shards'
rows show their noise is decorrelated) and the generator with W8A8 forced
at every M and the card's gate open (the TP programs take none).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from tests import torch_mesh_ranks as ranks
from tests.test_block_parity import VOCAB, make_cfg
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import neox as jax_neox
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu.parallel import sharding as jax_sh
from block_transformer_tpu.parallel import tp_decode as jax_tp
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import generate as torch_gen
from block_transformer_tpu_torch.kernels import flash_attention
from block_transformer_tpu_torch.models import neox as torch_neox
from block_transformer_tpu_torch.ops import attention as torch_attention
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import masks as torch_masks

MAX_BLOCKS = 8
# (mesh, weights, global cache, overlap_streams)
CASES = [("2x2", "fp32", "bf16", 1), ("2x2", "int8", "int8", 1),
         ("2x2", "int4", "int8", 1), ("2x2", "fp32", "int8", 2),
         ("dcn2x1x2", "int8", "bf16", 1), ("dcn2x1x2", "int4", "int8", 2)]


@pytest.fixture(scope="module")
def models():
    cfg = make_cfg()
    tcfg = torch_config.BlockTransformerConfig.from_dict(
        dataclasses.asdict(cfg))
    pj = jax_bt.init_block_transformer_params(jax.random.PRNGKey(0), cfg)
    jt = {"fp32": pj,
          "int8": jax_quant.quantize_block_transformer(pj, bits=8),
          "int4": jax_quant.quantize_block_transformer(pj, bits=4,
                                                       group_size=16)}
    jt = {k: jax.device_get(v) for k, v in jt.items()}
    pt = {k: bridge.params_from_numpy(v, device="cpu") for k, v in jt.items()}
    rng = np.random.default_rng(0)
    B, N, L = 4, 4, cfg.block_length
    ids = rng.integers(1, VOCAB, size=(B, N, L)).astype(np.int32)
    att = np.ones((B, N, L), np.int32)
    ids[1, 0], att[1, 0] = 0, 0                   # a left-padded row
    bam = att.any(-1).astype(np.int32)
    return cfg, tcfg, jt, pt, (ids, att, bam)


@pytest.fixture(scope="module")
def ranked(models, tmp_path_factory):
    _, tcfg, _, pt, (ids, att, bam) = models
    tmp = tmp_path_factory.mktemp("tp_decode")
    torch.save(pt, tmp / "params.pt")
    return ranks.spawn("generate", tmp, params_file=str(tmp / "params.pt"),
                       cfg=tcfg, cases=CASES, ids=ids, att=att, bam=bam,
                       max_blocks=MAX_BLOCKS)


def _jax_tp(cfg, params, mesh_name, kv, overlap, ids, att, bam):
    mesh = jax_sh.make_mesh(devices=jax.devices()[:ranks.WORLD],
                            **ranks.MESHES[mesh_name])
    tp_params = jax_tp.prepare_tp_params(params, cfg,
                                         tp=int(mesh.shape["model"]))
    fn = jax_tp.make_tp_generate_blocks(mesh, cfg, tp_params,
                                        max_blocks=MAX_BLOCKS, kv_cache=kv,
                                        overlap_streams=overlap)
    sp = jax.tree.map(lambda s: NamedSharding(mesh, s),
                      jax_tp.tp_param_specs(tp_params),
                      is_leaf=lambda x: isinstance(x, JP))
    data = NamedSharding(mesh, JP(jax_sh.data_axes(mesh)))
    toks, nb = fn(jax.tree.map(jax.device_put, tp_params, sp),
                  *(jax.device_put(jnp.asarray(a), data)
                    for a in (ids, att, bam)), jax.random.PRNGKey(0))
    return np.asarray(toks), int(nb)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_tp_generate_equals_jax(models, ranked, case):
    cfg, _, jt, _, inputs = models
    mesh_name, tree, kv, overlap = case
    want, nb = _jax_tp(cfg, jt[tree], mesh_name, kv, overlap, *inputs)
    for res in ranked:                      # every rank holds every row
        got, got_nb = res["tokens"][case]
        assert got_nb == nb
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_tp_generate_equals_single_device(models, ranked, case):
    _, tcfg, _, pt, inputs = models
    _, tree, kv, _ = case
    ref = torch_gen.generate_blocks(pt[tree], tcfg, *inputs,
                                    max_blocks=MAX_BLOCKS, kv_cache=kv,
                                    device="cpu")
    got, nb = ranked[0]["tokens"][case]
    assert nb == ref.n_blocks
    np.testing.assert_array_equal(got, ref.tokens.numpy())


def test_top1_pick_ties_go_to_the_lowest_index(ranked):
    """Maxima in both vocab shards, twice in one shard, everywhere: the
    two all-reduces (MAX of the scores, MIN of the index among the ranks
    holding it) pick what one device's argmax picks."""
    for res in ranked:
        np.testing.assert_array_equal(res["tie"], res["tie_want"])
    np.testing.assert_array_equal(ranked[0]["tie"], [1, 5, 0, 0])


def test_tp_sampled_decode(ranked, models):
    """Valid tokens; two generators give two streams; with one prompt in
    every row, the rows of the two data shards differ (their noise is
    decorrelated, as JAX folds its key with the data index)."""
    N = models[4][0].shape[1]
    t0, t1 = ranked[0]["sampled"]
    for t in (t0, t1):
        assert (t >= 0).all() and (t < VOCAB).all()
    assert not np.array_equal(t0[:, N:], t1[:, N:])
    assert not np.array_equal(t0[0, N:], t0[2, N:])       # shards 0 and 1
    for res in ranked[1:]:
        np.testing.assert_array_equal(res["sampled"][0], t0)


def test_w8a8_off_in_tp_programs(ranked):
    """W8A8 forced at every M with the card's gate open: the single-device
    generator takes it, the TP generator never (a row-parallel linear sees
    a K-slice of each row)."""
    for res in ranked:
        assert res["w8a8_tp"] == 0 and res["w8a8_single"] > 0
    with linear_ops.w8a8_min_m(1):
        assert linear_ops._use_w8a8(512)
        with linear_ops.sharded_program():
            assert not linear_ops._use_w8a8(512)


def test_ranks_import_no_jax(ranked):
    assert not any(res["jax_imported"] for res in ranked)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_neox_quantize_kv_equals_jax(dtype):
    """The cache write's quantizer under JAX's name and signature: the INT4
    cache's storage type (uint8) stands for jnp.int4."""
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 16)).astype(
        np.float32)
    qj, sj = jax_neox.quantize_kv(jnp.asarray(x), getattr(jnp, dtype))
    qt, st = torch_neox.quantize_kv(
        torch.from_numpy(x), torch.int8 if dtype == "int8" else torch.uint8)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj, np.int8))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_pallas_switches_take_the_plain_versions(monkeypatch, models):
    """``use_pallas=False`` and ``pallas_disabled()`` keep K1 / K3's
    wrappers out (JAX: XLA's paths); ``use_pallas=True`` and the default
    call them; ``attention`` takes JAX's two impls and refuses others."""
    _, _, _, pt, _ = models
    calls = []

    def spy(name, real):
        return lambda *a: calls.append(name) or real(*a)

    one, stacked = linear_ops._QUANTIZED["kernel_q8"]
    monkeypatch.setitem(linear_ops._QUANTIZED, "kernel_q8",
                        (one, spy("int8_matmul_stacked", stacked)))
    monkeypatch.setattr(flash_attention, "flash_attention",
                        spy("flash_attention", flash_attention.flash_attention))
    node = pt["int8"]["block_decoder"]["layers"]["attn"]["qkv"]
    lin = linear_ops.StackedLinear(node, 1)
    x = torch.randn(3, node["kernel_q8"].shape[1])
    want = linear_ops.apply_linear(x, lin)
    assert calls == ["int8_matmul_stacked"]
    for kw, ctx, n in ((dict(use_pallas=False), None, 0),
                       (dict(use_pallas=True), None, 1),
                       ({}, linear_ops.pallas_disabled, 0)):
        calls.clear()
        if ctx:
            with ctx():
                assert not linear_ops.pallas_allowed()
                got = linear_ops.apply_linear(x, lin, **kw)
        else:
            got = linear_ops.apply_linear(x, lin, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert len(calls) == n
    q, k, v = (torch.randn(1, 2, 8, 16) for _ in range(3))
    mask = torch_masks.causal_mask(torch.arange(8), torch.arange(8))
    calls.clear()
    want = torch_attention.attention(q, k, v, mask, "pallas")
    assert calls == ["flash_attention"]
    with linear_ops.pallas_disabled():
        got = torch_attention.attention(q, k, v, mask, "xla")
    assert calls == ["flash_attention"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert flash_attention.supported(q, k)
    assert not flash_attention.supported(q[:, :, :4], k)
    with pytest.raises(ValueError, match="impl"):
        torch_attention.attention(q, k, v, mask, "flash")


def test_pallas_switches_refuse_the_card(monkeypatch, models):
    """No code of the port sets ``use_pallas=False`` / ``pallas_disabled()``:
    on a card tensor (the gate patched to say so) both raise rather than
    run the plain version there."""
    _, _, _, pt, _ = models
    monkeypatch.setattr(linear_ops, "_on_card", lambda x: True)
    node = pt["int8"]["block_decoder"]["layers"]["attn"]["qkv"]
    lin = linear_ops.StackedLinear(node, 1)
    x = torch.randn(3, node["kernel_q8"].shape[1])
    with pytest.raises(RuntimeError, match="plain version"):
        linear_ops.apply_linear(x, lin, use_pallas=False)
    q = torch.randn(1, 2, 8, 16)
    mask = torch_masks.causal_mask(torch.arange(8), torch.arange(8))
    with linear_ops.pallas_disabled():
        with pytest.raises(RuntimeError, match="plain version"):
            linear_ops.apply_linear(x, lin)
        with pytest.raises(RuntimeError, match="plain version"):
            torch_attention.attention(q, q, q, mask)
