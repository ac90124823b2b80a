"""The PyTorch port's modules of the ablation families against the JAX
package, on the CPU: RoBERTa, T5, the embedders and token-decoder
strategies built on them, the block-decoding loss, the re-run inner loop
and the quantization of the new parameter trees.

Tiny sizes, float32, the same numpy inputs and (bridged) parameters on
both sides. Tolerances are stated per test: float32 stacks that differ in
summation order and in transcendental implementations (exp, erf, tanh)
agree to ~1e-6 on activations of order 1; integer results (buckets,
quantized weights, tokens) are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.models import block_decoder as jax_bd
from block_transformer_tpu.models import embedder as jax_emb
from block_transformer_tpu.models import roberta as jax_rb
from block_transformer_tpu.models import t5 as jax_t5
from block_transformer_tpu.models import token_decoder as jax_td
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch.inference import generate as torch_gen
from block_transformer_tpu_torch.models import block_decoder as torch_bd
from block_transformer_tpu_torch.models import embedder as torch_emb
from block_transformer_tpu_torch.models import roberta as torch_rb
from block_transformer_tpu_torch.models import t5 as torch_t5
from block_transformer_tpu_torch.models import token_decoder as torch_td
from block_transformer_tpu_torch.ops import quant as torch_quant

from test_torch_families import L, V, block_inputs, models

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got: torch.Tensor, want, atol=ATOL):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _bridge(params):
    params = jax.device_get(params)
    return params, bridge.params_from_numpy(params, device="cpu")


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (16, 64),
                                                  (64, 256)])
def test_relative_position_bucket_exact(bidirectional, buckets, max_distance):
    """Bit for bit over relative positions -300..300 (T5's default buckets
    and max distance among them)."""
    rel = np.arange(-300, 301, dtype=np.int32)
    want = np.asarray(jax_t5.relative_position_bucket(
        jnp.asarray(rel), bidirectional, buckets, max_distance))
    got = torch_t5.relative_position_bucket(
        torch.from_numpy(rel.astype(np.int64)), bidirectional, buckets,
        max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


def _roberta(seed=0):
    cfg = jax_rb.RobertaConfig(vocab_size=V, hidden_size=32, num_layers=2,
                               num_heads=2, intermediate_size=128,
                               max_position_embeddings=64, pad_token_id=0)
    tcfg = torch_rb.RobertaConfig(**cfg.__dict__)
    pj, pt = _bridge(jax_rb.init_roberta_params(jax.random.PRNGKey(seed), cfg))
    return cfg, tcfg, pj, pt


def _ids_with_pad(seed, B=3, S=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, V, (B, S)).astype(np.int32)
    att = np.ones_like(ids)
    ids[1, 4:], att[1, 4:] = 0, 0          # padded tail
    ids[2, 0], att[2, 0] = 0, 0            # a pad in front
    return ids, att


def test_roberta_encode():
    """Ids with padding (position ids from the non-pad ids), and embeddings
    with an attention mask (position ids from the mask): within ATOL."""
    cfg, tcfg, pj, pt = _roberta()
    ids, att = _ids_with_pad(0)
    _close(torch_rb.roberta_encode(pt, tcfg, _t(ids), _t(att)),
           jax_rb.roberta_encode(pj, cfg, jnp.asarray(ids), jnp.asarray(att)))
    x = np.random.default_rng(1).standard_normal((3, 6, 32)).astype(
        np.float32)
    _close(torch_rb.roberta_encode(pt, tcfg, None, _t(att),
                                   inputs_embeds=_t(x)),
           jax_rb.roberta_encode(pj, cfg, None, jnp.asarray(att),
                                 inputs_embeds=jnp.asarray(x)))


@pytest.mark.parametrize("n_cls,method", [(0, "concat"), (2, "concat"),
                                          (0, "projection_layer"),
                                          (2, "projection_layer")])
def test_roberta_embed_blocks(n_cls, method):
    """Blocks [2, 3, 4] with padded tokens, through both embedder classes
    and both projections: within ATOL."""
    from block_transformer_tpu import config as jc
    from block_transformer_tpu_torch import config as tc
    kw = dict(cls="roberta_cls" if n_cls else "roberta", vocab_size=V,
              hidden_size=32, n_cls_tokens=n_cls, encoder_layers=2,
              projection_method=method,
              projection_hidden_size=32 * (n_cls or L)
              if method == "concat" else 48)
    ecj, ect = jc.EmbedderConfig(**kw), tc.EmbedderConfig(**kw)
    pj, pt = _bridge(jax_emb.init_embedder_params(jax.random.PRNGKey(2), ecj,
                                                  L))
    ids, att, _, _ = block_inputs(4)
    want = jax_emb.embed_blocks(pj, ecj, L, jnp.asarray(ids),
                                attention_mask=jnp.asarray(att))
    got = torch_emb.embed_blocks(pt, ect, L, _t(ids), attention_mask=_t(att))
    _close(got, want)


@pytest.mark.parametrize("cls,method", [("lookup", "projection_layer"),
                                        ("t5", "concat"),
                                        ("t5", "projection_layer")])
def test_embedder_projection_and_t5(cls, method):
    """The lookup embedder's projection layer (a strided conv as a dense
    layer over each group of tokens, n_embedding_tokens 2) and the T5
    embedder: within ATOL."""
    from block_transformer_tpu import config as jc
    from block_transformer_tpu_torch import config as tc
    kw = dict(cls=cls, vocab_size=V, hidden_size=16, n_embedding_tokens=2,
              projection_method=method, encoder_layers=2,
              projection_hidden_size=32 if method == "concat" else 40)
    ecj, ect = jc.EmbedderConfig(**kw), tc.EmbedderConfig(**kw)
    pj, pt = _bridge(jax_emb.init_embedder_params(jax.random.PRNGKey(3), ecj,
                                                  L))
    ids, att, _, _ = block_inputs(5)
    want = jax_emb.embed_blocks(pj, ecj, L, jnp.asarray(ids),
                                attention_mask=jnp.asarray(att))
    got = torch_emb.embed_blocks(pt, ect, L, _t(ids), attention_mask=_t(att))
    assert tuple(got.shape) == (2, 3, 2, kw["projection_hidden_size"])
    _close(got, want)


def _t5(is_decoder, seed=0):
    cfg = jax_t5.T5Config(vocab_size=V, d_model=32, d_kv=8, d_ff=64,
                          num_layers=2, num_heads=4)
    tcfg = torch_t5.T5Config(**cfg.__dict__)
    pj, pt = _bridge(jax_t5.init_t5_stack_params(
        jax.random.PRNGKey(seed), cfg, is_decoder=is_decoder))
    return cfg, tcfg, pj, pt


@pytest.mark.parametrize("kind", ["encoder", "decoder", "decoder_cross"])
def test_t5_stack(kind):
    """Encoder (bidirectional buckets, padding), decoder (causal), decoder
    with cross-attention to encoder states with a masked slot: hidden
    within ATOL, and the tied head's logits within 1e-4."""
    is_decoder = kind != "encoder"
    cfg, tcfg, pj, pt = _t5(is_decoder)
    ids, att = _ids_with_pad(6, S=7)
    kw_j, kw_t = {}, {}
    if kind == "decoder_cross":
        rng = np.random.default_rng(7)
        enc = rng.standard_normal((3, 5, 32)).astype(np.float32)
        enc_att = np.ones((3, 5), np.int32)
        enc_att[0, 3] = 0
        kw_j = dict(encoder_hidden_states=jnp.asarray(enc),
                    encoder_attention_mask=jnp.asarray(enc_att))
        kw_t = dict(encoder_hidden_states=_t(enc),
                    encoder_attention_mask=_t(enc_att))
    hj = jax_t5.t5_stack(pj, cfg, input_ids=jnp.asarray(ids),
                         attention_mask=jnp.asarray(att),
                         is_decoder=is_decoder, **kw_j)
    ht = torch_t5.t5_stack(pt, tcfg, input_ids=_t(ids), attention_mask=_t(att),
                           is_decoder=is_decoder, **kw_t)
    _close(ht, hj)
    _close(torch_t5.t5_lm_logits(pt, tcfg, ht),
           jax_t5.t5_lm_logits(pj, cfg, hj), atol=1e-4)


@pytest.mark.parametrize("family", ["roberta_cls_summation",
                                    "summation_repeat", "cls_cross_attention",
                                    "cross_attention_repeat"])
def test_token_decoder_train_forward(family):
    """The summation and cross-attention strategies, with an expansion
    layer and with repetition, on inputs with padded tokens: float32 logits
    within 1e-4."""
    cj, ct, pj, pt = models(family, seed=4)
    rng = np.random.default_rng(8)
    Bb = 5
    ids = rng.integers(1, V, (Bb, L + 1)).astype(np.int32)
    att = np.ones_like(ids)
    att[1, 3:] = 0
    be = rng.standard_normal((Bb, 1, 64)).astype(np.float32)
    want = jax_td.token_decoder_train_forward(
        pj["token_decoder"], cj.token_decoder, jnp.asarray(ids),
        jnp.asarray(att), jnp.asarray(be), cj.expansion_ratio, L)
    got = torch_td.token_decoder_train_forward(
        pt["token_decoder"], ct.token_decoder, _t(ids), _t(att), _t(be),
        ct.expansion_ratio, L)
    assert got.dtype == torch.float32
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("loss_type", ["mse", "contrastive"])
def test_block_decoding_loss(loss_type):
    """Both loss types on hidden states and inputs [2, 6 blocks x 2
    embedding tokens, 16] with a padding block: within 1e-5 relative."""
    rng = np.random.default_rng(9)
    h = rng.standard_normal((2, 12, 16)).astype(np.float32)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    bam = np.ones((2, 6), np.int32)
    bam[1, :2] = 0
    want = jax_bd.block_decoding_loss(jnp.asarray(h), jnp.asarray(x),
                                      jnp.asarray(bam), 2, loss_type)
    got = torch_bd.block_decoding_loss(_t(h), _t(x), _t(bam), 2, loss_type)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_block_decoding_loss_unknown_type_raises():
    args = [np.zeros((1, 4, 8), np.float32)] * 2 + [np.ones((1, 4), np.int32)]
    with pytest.raises(ValueError):
        jax_bd.block_decoding_loss(*map(jnp.asarray, args), 1, "cosine")
    with pytest.raises(ValueError):
        torch_bd.block_decoding_loss(*map(_t, args), 1, "cosine")


@pytest.mark.parametrize("family,quantized", [
    ("summation_repeat", False), ("roberta_cls_summation", True),
    ("cls_cross_attention", False), ("cross_attention_repeat", True),
    ("gpt_neo", False)])
def test_decode_block_tokens_rerun(family, quantized):
    """The re-run inner loop on 6 block embeddings, greedy: tokens and
    alive rows equal to JAX's; ``decode_block_tokens`` dispatches there."""
    cj, ct, pj, pt = models(family, seed=5, quantized=quantized)
    be = np.random.default_rng(10).standard_normal((6, 1, 64)).astype(
        np.float32)
    tj, aj = jax_gen.decode_block_tokens_rerun(
        jax.tree.map(jnp.asarray, pj), cj, jnp.asarray(be))
    tt, at = torch_gen.decode_block_tokens_rerun(pt, ct, _t(be))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    td, ad = torch_gen.decode_block_tokens(pt, ct, _t(be))
    assert torch.equal(td, tt) and torch.equal(ad, at)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("family", ["cls_cross_attention", "gpt_neo"])
def test_quantized_trees_match(family):
    """The port's ``quantize_block_transformer`` on the bridged float tree
    of a RoBERTa-CLS + T5 model and of a GPT-Neo model gives JAX's tree bit
    for bit: the same nodes quantized, the same int8 values and scales.
    The embedder and every embedding table (T5's ``embed`` and
    ``rel_bias``, GPT-Neo's ``wte`` and ``wpe``) stay float."""
    cj, _, pj, pt = models(family, seed=6)
    want = jax.device_get(jax_quant.quantize_block_transformer(pj, bits=8))
    got = bridge.params_to_numpy(torch_quant.quantize_block_transformer(
        pt, bits=8))
    lw, lg = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in lw] == [p for p, _ in lg]
    for (path, a), (_, b) in zip(lw, lg):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    paths = {p for p, _ in lg}
    assert not any(p[0] == "embedder" and p[-1].startswith("kernel_q")
                   for p in paths)
    assert any(p[-1] == "kernel_q8" for p in paths)
    floats = [p for p in paths if p[-2] in ("embed", "rel_bias", "wte", "wpe")]
    assert floats and all(p[-1] == "weight" for p in floats)
    for p, a in lg:
        if p[-2] in ("embed", "rel_bias", "wte", "wpe"):
            assert a.dtype == np.float32, p
