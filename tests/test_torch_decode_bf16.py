"""K2's unquantized form (``decode_attention_stacked``) on the CPU.

Its plain version against the JAX package's Pallas kernel with
``quantized=False``, run in interpret mode as
``tests/test_stacked_kernels.py`` runs it, on numpy inputs from a seed in
float32: within 1e-5 of the output's scale (both compute the same float32
products and softmax, summed in another order). And the routing: a bf16
(here float32) cache sends every decode-shaped query (S <= 8) of the stack
to it, one call a layer, which puts it on the token decoder's local cache.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_block_parity import make_cfg
from block_transformer_tpu.ops import decode_attention as jax_da
from block_transformer_tpu.ops import masks as jax_masks
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.kernels import decode_attention as k2
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.models import neox as torch_neox
from block_transformer_tpu_torch.models import token_decoder as td
from block_transformer_tpu_torch.ops import masks as torch_masks


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("S,D,cap,length", [
    (1, 32, 64, 60),
    (8, 32, 64, 64),
    (3, 64, 40, 17),                  # capacity not a multiple of 32
    (2, 64, 6, 2),                    # the token decoder's local cache
])
def test_k2_bf16_plain_matches_pallas(S, D, cap, length):
    """Rows: one left-padded, one with no allowed key (B = 3)."""
    rng = np.random.default_rng(S * 100 + D)
    L, B, H = 2, 3, 4
    k = rng.standard_normal((L, B, H, cap, D)).astype(np.float32)
    v = rng.standard_normal((L, B, H, cap, D)).astype(np.float32)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    valid = (np.arange(cap)[None] < length).astype(np.int32).repeat(B, 0)
    valid[1, :min(3, length - 1)] = 0
    valid[2] = 0
    q_idx = (length - S + np.arange(S, dtype=np.int32))[None].repeat(B, 0)
    kv_idx = np.arange(cap, dtype=np.int32)
    for layer in (0, 1):
        want = np.asarray(jax_da.decode_attention_stacked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer,
            jax_masks.AttnMask(jnp.asarray(q_idx), jnp.asarray(kv_idx),
                               jnp.asarray(valid)), interpret=True))
        got = k2.decode_attention_stacked(
            _t(q), _t(k), _t(v), layer,
            torch_masks.AttnMask(_t(q_idx), _t(kv_idx), _t(valid)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_bf16_cache_routes_decode_to_k2(monkeypatch):
    """The token decoder's prefix step (S = n_exp = 2) and token step
    (S = 1) on the local cache call K2's unquantized form once a layer,
    with the local cache's own tensors."""
    cfg = torch_config.BlockTransformerConfig.from_dict(
        dataclasses.asdict(make_cfg()))
    tcfg = cfg.token_decoder
    params = bt.init_block_transformer_params(0, cfg, device="cpu")
    seen = []
    real = k2.decode_attention_stacked

    def spy(q, k, v, layer, mask):
        seen.append((q.shape[2], layer, k.data_ptr()))
        return real(q, k, v, layer, mask)

    monkeypatch.setattr(k2, "decode_attention_stacked", spy)
    B, n_exp, L = 2, cfg.n_expanded_emb, cfg.block_length
    cache = torch_neox.KVCache.create(tcfg.neox, B, n_exp + L,
                                      dtype=torch.float32, device="cpu")
    expanded = torch.randn((B, n_exp, tcfg.neox.hidden_size),
                           generator=torch.Generator().manual_seed(0))
    _, cache = td.token_decoder_prefix_step(params["token_decoder"], tcfg,
                                            expanded, cache)
    _, cache = td.token_decoder_token_step(
        params["token_decoder"], tcfg, torch.tensor([3, 5], dtype=torch.int32),
        cache)
    layers = tcfg.neox.num_layers
    assert [(s, i) for s, i, _ in seen] == (
        [(n_exp, i) for i in range(layers)] + [(1, i) for i in range(layers)])
    assert {p for _, _, p in seen} == {cache.k.data_ptr()}
    assert cache.length == n_exp + 1
