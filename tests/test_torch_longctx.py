"""The port's long-context evaluation (``eval/longctx.py`` and the entry
point ``eval_longctx.py``) against the JAX package's, on the CPU.

``loss_by_position_over_chunks`` takes its cross-entropy in torch on the
logits' device where JAX takes it in numpy: the same logits give each
position's mean loss within 1e-5 relative (float32, summed in another
order). The needle suite's samples and scores are the same Python: equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.data import tokenizer as jax_tokenizer
from block_transformer_tpu.eval import longctx as jax_longctx
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch import eval_longctx
from block_transformer_tpu_torch.data import tokenizer
from block_transformer_tpu_torch.eval import longctx
from block_transformer_tpu_torch.models import block_transformer as bt

RTOL = 1e-5
HAYSTACK = os.path.join(os.path.dirname(__file__), "..", "assets",
                        "needle_haystack.txt")


def _docs(seed, vocab, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab - 50, size=n) for n in lengths]


def test_block_loss_by_position_equals_jax():
    """The block model's teacher-forced logits (JAX's forward, bridged
    parameters in the port's): 3 docs, one too short, 5 chunks of 32 in
    batches of 2."""
    kw = dict(vocab_size=160, max_length=256)
    cfg = jax_config.make_block_config("t", 64, 2, **kw)
    tcfg = torch_config.make_block_config("t", 64, 2, **kw)
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(0), cfg))
    pt = bridge.params_from_numpy(pj, "cpu")
    L = cfg.block_length
    docs = _docs(0, 160, (70, 20, 100))

    def jax_fn(batch):
        B, C = batch.shape
        ids = jnp.asarray(batch).reshape(B, C // L, L)
        return jax_bt.block_transformer_forward(
            pj, cfg, ids, jnp.ones_like(ids),
            jnp.ones(ids.shape[:2], jnp.int32)).logits

    def port_fn(batch):
        B, C = batch.shape
        ids = torch.from_numpy(batch).reshape(B, C // L, L)
        with torch.no_grad():
            return bt.block_transformer_forward(
                pt, tcfg, ids, torch.ones_like(ids),
                torch.ones(ids.shape[:2], dtype=torch.int32)).logits

    want, n = jax_longctx.loss_by_position_over_chunks(
        jax_fn, docs, 32, batch_size=2, block_length=L)
    got, m = longctx.loss_by_position_over_chunks(
        port_fn, docs, 32, batch_size=2, block_length=L)
    assert n == m == 5 and got.shape == want.shape == (32 - L,)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_vanilla_loss_by_position_equals_jax(as_tensor):
    """Vanilla-shaped logits [B, C, V] handed over as numpy or as a
    tensor."""
    rng = np.random.default_rng(1)
    table = (rng.standard_normal((40, 64, 97)) * 3).astype(np.float32)
    docs = _docs(2, 97, (64, 130, 31))

    def logits_fn(batch):
        out = table[:batch.shape[0], :batch.shape[1]] + batch[..., None] * 0.01
        return torch.from_numpy(out) if as_tensor else out

    want, n = jax_longctx.loss_by_position_over_chunks(
        lambda b: table[:b.shape[0], :b.shape[1]] + b[..., None] * 0.01,
        docs, 32, batch_size=3)
    got, m = longctx.loss_by_position_over_chunks(logits_fn, docs, 32,
                                                  batch_size=3)
    assert n == m == 6 and got.shape == (31,)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    with pytest.raises(ValueError):
        longctx.loss_by_position_over_chunks(logits_fn, docs[2:], 64)


def test_needle_suite_equals_jax():
    with open(HAYSTACK) as f:
        hay = f.read()
    tok, jtok = tokenizer.ByteTokenizer(), jax_tokenizer.load_tokenizer(
        "byte")
    got = longctx.generate_needle_suite(hay, tok, 512, depths=(0, 50, 100),
                                        seed=3)
    want = jax_longctx.generate_needle_suite(hay, jtok, 512,
                                             depths=(0, 50, 100), seed=3)
    assert got == want and len(got) == 9
    assert all(len(tok.encode(s["prompt"])) <= 512 for s in got)
    gens = [s["needle"] if i % 2 else "nothing" for i, s in enumerate(got)]
    assert longctx.score_needle_results(got, gens) == \
        jax_longctx.score_needle_results(want, gens)


def test_entry_point_on_the_cpu(tmp_path):
    out = str(tmp_path / "ppl.json")
    res = eval_longctx.main(["ppl", "--model", "block_main_b4_5", "--random",
                             "--context", "64", "--synthetic-docs", "2",
                             "--batch_size", "2", "--out", out, "--cpu"])
    assert res["n_chunks"] == 4 and len(res["loss_by_position"]) == 60
    assert np.isfinite(res["mean_loss"]) and os.path.isfile(out)
    res = eval_longctx.main(["needle", "--model", "block_main_b4_5",
                             "--random", "--context", "128", "--depths",
                             "50", "--haystack", HAYSTACK, "--tokenizer",
                             "byte", "--cpu"])
    assert list(res["scores_by_depth"]) == [50.0]
    assert all(0.0 <= v <= 1.0 for v in res["scores_by_depth"].values())
