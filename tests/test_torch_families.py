"""The PyTorch port's ablation model families against the JAX package, on
the CPU.

Each family of the JAX package's ``test_ablation_models.py`` /
``test_generate_families.py`` (RoBERTa and RoBERTa-CLS embedders, the T5
embedder, the projection layer, summation and T5 cross-attention token
decoders with and without an expansion layer, the GPT-Neo block and token
decoders) is built at a tiny size (vocab 96, hidden 64, 2 layers, blocks
of 4) in both packages; the JAX parameters cross through
``bridge.params_from_numpy``. Float32 throughout. The forward's logits
agree within 1e-4 absolute and its losses, the auxiliary block-decoding
and auto-encoding losses on, within 1e-5 relative; greedy tokens are equal,
not close (random weights make near-ties rare).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from block_transformer_tpu import config as jax_config
from block_transformer_tpu import config_yaml
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.inference import generate as torch_gen
from block_transformer_tpu_torch.models import block_transformer as torch_bt

V, H, L = 96, 64, 4
ATOL = 1e-4
RTOL_LOSS = 1e-5
FAMILIES = ("roberta_prefix", "roberta_cls_summation", "cls_cross_attention",
            "t5_prefix", "projection_layer", "summation_repeat",
            "cross_attention_repeat", "gpt_neo")
QUANTIZED_FAMILIES = ("summation_repeat", "roberta_cls_summation",
                      "cls_cross_attention", "cross_attention_repeat")


def build(C, family: str, **kw):
    """The tiny config of ``family`` from the config module ``C`` (the JAX
    package's or the port's)."""
    def neox():
        return C.NeoXConfig(vocab_size=V, hidden_size=H, num_layers=2,
                            num_heads=4, intermediate_size=H * 4,
                            max_position_embeddings=64)

    lookup = C.EmbedderConfig(vocab_size=V, hidden_size=H // L,
                              projection_hidden_size=H)
    cls_emb = C.EmbedderConfig(cls="roberta_cls", vocab_size=V, hidden_size=32,
                               projection_hidden_size=H, encoder_layers=2,
                               n_cls_tokens=2)
    emb, td = lookup, dict(expansion_ratio=2)
    if family == "roberta_prefix":
        emb = C.EmbedderConfig(cls="roberta", vocab_size=V, hidden_size=H // L,
                               projection_hidden_size=H, encoder_layers=2)
        td = dict(expansion_ratio=1)
    elif family == "roberta_cls_summation":
        emb = cls_emb
        td = dict(expansion_ratio=L, decoding_strategy="summation")
    elif family == "cls_cross_attention":
        emb = cls_emb
        td = dict(expansion_ratio=L, decoding_strategy="cross_attention",
                  cls="t5")
    elif family == "t5_prefix":
        emb = C.EmbedderConfig(cls="t5", vocab_size=V, hidden_size=H // L,
                               projection_hidden_size=H, encoder_layers=2)
    elif family == "projection_layer":
        emb = C.EmbedderConfig(vocab_size=V, hidden_size=24,
                               projection_method="projection_layer",
                               projection_hidden_size=H)
    elif family == "summation_repeat":
        td = dict(expansion_ratio=None, expansion_method=None,
                  decoding_strategy="summation")
    elif family == "cross_attention_repeat":
        td = dict(expansion_ratio=None, expansion_method=None,
                  decoding_strategy="cross_attention", cls="t5")
    elif family == "gpt_neo":
        td = dict(expansion_ratio=2, cls="gpt-neo")
        kw = dict(block_decoder_cls="gpt-neo", block_decoder_window=2, **kw)
    else:
        raise KeyError(family)
    return C.BlockTransformerConfig(
        block_length=L, embedder=emb, block_decoder=neox(),
        token_decoder=C.TokenDecoderConfig(neox=neox(), **td), **kw)


def models(family: str, seed: int = 0, quantized: bool = False, **kw):
    """(JAX cfg, port cfg, JAX params as numpy, port params on the CPU)."""
    cj, ct = build(jax_config, family, **kw), build(torch_config, family, **kw)
    params = jax_bt.init_block_transformer_params(jax.random.PRNGKey(seed),
                                                  cj)
    if quantized:
        params = jax_quant.quantize_block_transformer(params, bits=8)
    params = jax.device_get(params)
    return cj, ct, params, bridge.params_from_numpy(params, device="cpu")


def block_inputs(seed: int, B: int = 2, N: int = 3):
    """Block-format ids, attention mask, block mask and labels: one block
    with padded tail tokens, one row whose first block is padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, V, size=(B, N, L)).astype(np.int32)
    att = np.ones_like(ids)
    att[0, -1, 2:] = 0
    ids[1, 0], att[1, 0] = 0, 0
    bam = att.any(-1).astype(np.int32)
    labels = np.where(att == 0, -100, ids).astype(np.int32)
    return ids, att, bam, labels


@pytest.mark.parametrize("loss_type", ["contrastive", "mse"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logits_and_losses(family, loss_type):
    """Logits within ATOL; loss, token, block-decoding and auto-encoding
    losses and the loss by position within RTOL_LOSS (relative)."""
    kw = dict(use_block_decoding_loss=True, use_auto_encoding_loss=True,
              block_decoding_loss_type=loss_type,
              block_decoding_loss_weight=0.5, auto_encoding_loss_weight=0.3)
    cj, ct, pj, pt = models(family, **kw)
    ids, att, bam, labels = block_inputs(0)
    oj = jax_bt.block_transformer_forward(
        pj, cj, *map(jnp.asarray, (ids, att, bam)),
        labels=jnp.asarray(labels), compute_logits=True)
    ot = torch_bt.block_transformer_forward(
        pt, ct, *map(torch.from_numpy, (ids, att, bam)),
        labels=torch.from_numpy(labels), compute_logits=True)
    assert ot.logits.dtype == torch.float32
    assert tuple(ot.logits.shape) == oj.logits.shape == (2, 2, L, V)
    np.testing.assert_allclose(ot.logits.numpy(), np.asarray(oj.logits),
                               atol=ATOL, rtol=0)
    for f in ("loss", "token_decoding_loss", "block_decoding_loss",
              "auto_encoding_loss", "loss_by_position"):
        assert getattr(ot, f) is not None, f
        np.testing.assert_allclose(getattr(ot, f).numpy(),
                                   np.asarray(getattr(oj, f)),
                                   rtol=RTOL_LOSS, atol=1e-6, err_msg=f)


def _prompt(seed: int, B: int = 2, T: int = 9):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(2, V, size=(B, T)).astype(np.int32)
    mask = np.ones_like(prompt)
    mask[1, :2] = 0                    # a shorter prompt in row 1
    return prompt, mask


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_greedy_tokens_equal(family):
    """Flat prompts through ``generate`` (float weights, the bf16 / float32
    cache): the port's tokens equal JAX's, and something was generated."""
    cj, ct, pj, pt = models(family, seed=1)
    prompt, mask = _prompt(1)
    want = np.asarray(jax_gen.generate(pj, cj, prompt, mask, max_length=21))
    got = torch_gen.generate(pt, ct, prompt, mask, max_length=21,
                             device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] > prompt.shape[1]


@pytest.mark.parametrize("family", QUANTIZED_FAMILIES)
def test_generate_blocks_int8_greedy_tokens_equal(family):
    """The slice's served form: INT8 weights and the INT8 global cache,
    ``generate_blocks`` with a padding block and padded tokens in the
    prompt; tokens, blocks and unfinished rows equal to JAX's."""
    cj, ct, pj, pt = models(family, seed=2, quantized=True)
    ids, att, bam, _ = block_inputs(2, N=3)
    rj = jax_gen.generate_blocks(pj, cj, *map(jnp.asarray, (ids, att, bam)),
                                 max_blocks=7, kv_cache="int8")
    rt = torch_gen.generate_blocks(pt, ct, ids, att, bam, max_blocks=7,
                                   kv_cache="int8", device="cpu")
    assert rt.n_blocks == int(rj.n_blocks)
    np.testing.assert_array_equal(rt.tokens.numpy(), np.asarray(rj.tokens))
    np.testing.assert_array_equal(rt.unfinished.numpy(),
                                  np.asarray(rj.unfinished))
    assert int((rt.tokens[:, 3:] != ct.pad_token_id).sum()) > 0


@pytest.mark.parametrize("quantized", [False, True])
def test_rerun_inner_loop_matches_cached_fast_path(quantized):
    """On the main family (GPT-NeoX prefix decoder) the re-run loop gives
    the cached loop's tokens and alive rows."""
    cfg = torch_config.BlockTransformerConfig(
        block_length=L,
        embedder=torch_config.EmbedderConfig(vocab_size=V, hidden_size=H // L,
                                             projection_hidden_size=H),
        block_decoder=torch_config.NeoXConfig(
            vocab_size=V, hidden_size=H, num_layers=2, num_heads=4,
            intermediate_size=H * 4, max_position_embeddings=64),
        token_decoder=torch_config.TokenDecoderConfig(
            neox=torch_config.NeoXConfig(
                vocab_size=V, hidden_size=H, num_layers=2, num_heads=4,
                intermediate_size=H * 4, max_position_embeddings=64),
            expansion_ratio=2))
    params = torch_bt.init_block_transformer_params(0, cfg, device="cpu")
    if quantized:
        from block_transformer_tpu_torch.ops import quant
        params = quant.quantize_block_transformer(params, bits=8)
    g = torch.Generator().manual_seed(1)
    be = torch.randn((5, 1, H), generator=g)
    fast, alive_f = torch_gen.decode_block_tokens(params, cfg, be)
    slow, alive_s = torch_gen.decode_block_tokens_rerun(params, cfg, be)
    assert torch.equal(fast, slow)
    assert torch.equal(alive_f, alive_s)


def _self_consistent_positions(family: str, seed: int) -> int:
    """Generate greedily with the port, teacher-force the stream back
    through the port's forward, and assert each generated token is the
    argmax at its position (up to a row's first EOS); returns how many
    positions were checked."""
    _, ct, _, pt = models(family, seed=seed)
    prompt = np.random.default_rng(seed).integers(2, V, size=(2, 8))
    out = torch_gen.generate(pt, ct, prompt, max_length=24, device="cpu")
    d = torch_gen.preprocess_inputs(ct, out)
    fwd = torch_bt.block_transformer_forward(
        pt, ct, *(torch.from_numpy(d[k]) for k in
                  ("input_ids", "attention_mask", "block_attention_mask")))
    logits = fwd.logits.numpy()                      # [B, N-1, L, V]
    ids = d["input_ids"]
    first = (8 + d["initial_block_padding"]) // L    # first generated block
    checked = 0
    for b in range(ids.shape[0]):
        for i, j in [(i, j) for i in range(first, ids.shape[1])
                     for j in range(L)]:
            tok = int(ids[b, i, j])
            if tok == ct.eos_token_id:
                break
            assert tok == int(np.argmax(logits[b, i - 1, j])), (seed, b, i, j)
            checked += 1
    return checked


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_self_consistent_with_forward(family):
    """Greedy generation agrees with the teacher-forced forward. A tiny
    random model may emit EOS at once, so seeds are tried, as the JAX
    package's test does, until 4 generated positions were checked."""
    checked = 0
    for seed in range(3, 9):
        checked = _self_consistent_positions(family, seed)
        if checked >= 4:
            break
    assert checked >= 4, f"only {checked} generated positions checked"


def test_cross_attention_requires_t5():
    """The port's config raises where JAX's does."""
    for C in (jax_config, torch_config):
        with pytest.raises(ValueError):
            C.TokenDecoderConfig(decoding_strategy="cross_attention",
                                 cls="gpt-neo-x")


@pytest.mark.parametrize("name", sorted(chip_smoke.FAMILY_NAMES))
def test_chip_smoke_family_configs_match_yaml(name):
    """chip_smoke.py's family configs (``configs/<name>.yaml`` through the
    port's loader) equal the JAX loader's, field for field."""
    root = Path(__file__).resolve().parents[1]
    want = config_yaml.load_block_config_yaml(root / "configs"
                                              / f"{name}.yaml")
    got = chip_smoke.family_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_expanded_emb == want.n_expanded_emb


@pytest.mark.parametrize("strategy,cls", [("summation", "gpt-neo-x"),
                                          ("cross_attention", "t5")])
def test_expansion_layer_with_no_ratio(strategy, cls):
    """An expansion layer with ``expansion_ratio`` None (the shipped
    megabyte and cls_cross_attn YAMLs): the port's init sizes the layer by
    the block length, as every forward reads the ratio (JAX's init cannot
    build it), and JAX's forward on the port's parameters gives the port's
    logits within ATOL."""
    kw = dict(expansion_ratio=None, decoding_strategy=strategy, cls=cls)
    cfgs = []
    for C in (jax_config, torch_config):
        neox = C.NeoXConfig(vocab_size=V, hidden_size=H, num_layers=2,
                            num_heads=4, intermediate_size=H * 4,
                            max_position_embeddings=64)
        cfgs.append(C.BlockTransformerConfig(
            block_length=L,
            embedder=C.EmbedderConfig(vocab_size=V, hidden_size=H // L,
                                      projection_hidden_size=H),
            block_decoder=neox,
            token_decoder=C.TokenDecoderConfig(neox=neox, **kw)))
    cj, ct = cfgs
    pt = torch_bt.init_block_transformer_params(0, ct, device="cpu")
    assert tuple(pt["token_decoder"]["expansion"]["kernel"].shape) == (H,
                                                                       H * L)
    pj = jax.tree.map(jnp.asarray, bridge.params_to_numpy(pt))
    ids, att, bam, _ = block_inputs(9)
    want = jax_bt.block_transformer_forward(pj, cj,
                                            *map(jnp.asarray, (ids, att, bam)))
    got = torch_bt.block_transformer_forward(pt, ct,
                                             *map(torch.from_numpy,
                                                  (ids, att, bam)))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("family,kind", [
    ("summation_repeat", "int8"), ("cls_cross_attention", "paged"),
    ("roberta_prefix", "int8")])
def test_engine_serves_families(family, kind):
    """The serving engine (INT8 weights; the contiguous INT8 cache or a
    paged pool of 4-slot pages) with a re-run token decoder or an encoder
    embedder: 5 requests of uneven prompts and budgets on 3 slots, each
    request's greedy tokens equal to the JAX engine's."""
    from block_transformer_tpu.inference.engine import (
        ContinuousBatchingEngine as JaxEngine)
    from block_transformer_tpu_torch.inference.engine import (
        ContinuousBatchingEngine as PortEngine)
    cj, ct, pj, pt = models(family, quantized=True)
    kw = dict(n_slots=3, max_blocks=12, kv_cache=kind, sync_blocks=3,
              bucket_blocks=2)
    if kind == "paged":
        kw.update(page_size=4, pool_pages=8)

    def serve(engine):
        rng = np.random.default_rng(0)
        for n, budget in zip((8, 12, 4, 9, 6), (6, 9, 5, 14, 3)):
            engine.submit(rng.integers(2, V, size=n), budget)
        reqs = list(engine.waiting)
        engine.run(max_steps=200)
        assert not engine.has_work()
        return [list(r.generated) for r in reqs]

    want = serve(JaxEngine(pj, cj, **kw))
    got = serve(PortEngine(pt, ct, device="cpu", **kw))
    assert got == want
    assert sum(map(len, got)) > 5
