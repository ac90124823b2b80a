"""The port's evaluation stack against the JAX package's, on the CPU: the
harness (metrics, task semantics, ``evaluate``), filters, few-shot sampler
and request cache (copies, so equal), the LM adapters on the same bridged
parameters, the fixture suite of ``assets/real_tasks`` through both, and
the zero-shot hook through the port's ``Trainer``.

Tolerances (float32 models at small sizes):
- each loglikelihood sum within 1e-4 absolute of JAX's adapter (the port
  takes its log-softmax in torch, JAX's in numpy, over logits from two
  float32 forwards), greedy flags equal;
- ``generate_until`` strings equal (greedy, same tokens);
- a results dict within 1e-4, absolute or relative (perplexities exponentiate
  a loglikelihood mean, so their error is relative).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.data import tokenizer as jax_tokenizer
from block_transformer_tpu.eval import adapters as jax_adapters
from block_transformer_tpu.eval import caching as jax_caching
from block_transformer_tpu.eval import filters as jax_filters
from block_transformer_tpu.eval import harness as jax_harness
from block_transformer_tpu.eval import samplers as jax_samplers
from block_transformer_tpu.eval import tasks as jax_tasks
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import vanilla as jax_vanilla
from block_transformer_tpu.train import eval_callback as jax_eval_callback
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.data import tokenizer
from block_transformer_tpu_torch.eval import adapters
from block_transformer_tpu_torch.eval import caching
from block_transformer_tpu_torch.eval import filters
from block_transformer_tpu_torch.eval import harness
from block_transformer_tpu_torch.eval import samplers
from block_transformer_tpu_torch.eval import tasks
from block_transformer_tpu_torch.pretrain_block_transformer import (
    synthetic_corpus)
from block_transformer_tpu_torch.train import eval_callback
from block_transformer_tpu_torch.train import trainer as trainer_lib

LL_TOL = 1e-4
RESULTS_TOL = 1e-4
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "real_tasks")


def _fixture(name, n):
    with open(os.path.join(ASSETS, f"{name}.jsonl")) as f:
        return [json.loads(line) for line in f][:n]


def _block_models(seed=0, hidden=128, layers=2, vocab=512):
    cfg = jax_config.make_block_config("t", hidden, layers, vocab_size=vocab)
    tcfg = torch_config.make_block_config("t", hidden, layers,
                                          vocab_size=vocab)
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(seed), cfg))
    return cfg, tcfg, pj, bridge.params_from_numpy(pj, "cpu")


@pytest.fixture(scope="module")
def block_models():
    return _block_models()


def _requests(seed, n=6):
    """(context, continuation) text pairs of uneven lengths, and an empty
    context."""
    rng = np.random.default_rng(seed)

    def word(lo, hi):
        return "".join(chr(c) for c in rng.integers(97, 123,
                                                    rng.integers(lo, hi)))
    return [(word(5, 90), " " + word(1, 12)) for _ in range(n)] + \
        [("", "plain text")]


def _assert_ll_equal(got, want):
    assert len(got) == len(want)
    for (a, ga), (b, gb) in zip(got, want):
        assert abs(a - b) <= LL_TOL, (a, b)
        assert ga == gb


def _greedy_request(lm, ctx, n):
    """ctx tokens and the n tokens the port's adapter predicts greedily
    after them (teacher-forced argmax, one token at a time)."""
    toks = list(ctx)
    for _ in range(n):
        inp = torch.tensor([toks], dtype=torch.int32)
        with torch.no_grad():
            logits = lm._logits_fn(inp, torch.tensor([len(toks)]))
        toks.append(int(logits[0, len(toks) - 1].argmax()))
    return list(ctx), toks[len(ctx):]


# ---------------------------------------------------------------------------
# harness, filters, sampler, caching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["mean", "perplexity", "weighted_perplexity",
                                "bits_per_byte", "bootstrap_stderr"])
def test_metrics_equal_jax(fn):
    rng = np.random.default_rng(3)
    lls = list(-rng.random(37) * 5)
    if fn in ("weighted_perplexity", "bits_per_byte"):
        pairs = list(zip(lls, rng.integers(1, 40, 37).tolist()))
        assert getattr(harness, fn)(pairs) == getattr(jax_harness, fn)(pairs)
    elif fn == "bootstrap_stderr":
        for metric in ("mean", "perplexity"):
            assert harness.bootstrap_stderr(
                getattr(harness, metric), lls, seed=7) == \
                jax_harness.bootstrap_stderr(getattr(jax_harness, metric),
                                             lls, seed=7)
        assert harness.bootstrap_stderr(harness.mean, [1.0]) == 0.0
    else:
        assert getattr(harness, fn)(lls) == getattr(jax_harness, fn)(lls)


def test_filters_equal_jax():
    responses = ["The answer is 42.", " 17 apples", "x", "The answer is 42.",
                 "$1,234.50 total", "no number", " 17 apples"]
    for name, args in (("RegexFilter", ()), ("WhitespaceFilter", ()),
                       ("TakeFirst", ()), ("TakeKFilter", (3,)),
                       ("MajorityVote", ())):
        got = getattr(filters, name)(*args).apply(list(responses))
        want = getattr(jax_filters, name)(*args).apply(list(responses))
        assert got == want, name
    chain = (filters.RegexFilter(), filters.MajorityVote())
    jchain = (jax_filters.RegexFilter(), jax_filters.MajorityVote())
    assert filters.apply_filters(chain, list(responses)) == \
        jax_filters.apply_filters(jchain, list(responses))
    assert filters.MajorityVote().apply([]) == []


def _trivia_docs():
    return _fixture("trivia_real", 12)


def test_fewshot_sampler_equals_jax():
    docs = _trivia_docs()
    for k in (0, 1, 3):
        got = [samplers.build_fewshot_context(
            tasks.TriviaQA(docs=docs), d, k,
            samplers.FewshotSampler(docs, seed=5)) for d in docs[:4]]
        want = [jax_samplers.build_fewshot_context(
            jax_tasks.TriviaQA(docs=docs), d, k,
            jax_samplers.FewshotSampler(docs, seed=5)) for d in docs[:4]]
        assert got == want
    mc = [{"goal": f"g{i}", "sol1": "a", "sol2": "b", "label": i % 2}
          for i in range(6)]
    assert samplers.build_fewshot_context(tasks.PIQA(docs=mc), mc[0], 2) == \
        jax_samplers.build_fewshot_context(jax_tasks.PIQA(docs=mc), mc[0], 2)


class _MockLM(harness.LM):
    """Deterministic fake scores from the request text; counts calls."""

    def __init__(self):
        self.calls = 0

    def tok_encode(self, s):
        return [ord(c) % 50 + 1 for c in s]

    def loglikelihood(self, requests):
        self.calls += 1
        return [(-float(len(c) + 2 * len(x)) / 7.0, len(x) % 3 == 0)
                for c, x in requests]

    def loglikelihood_rolling(self, texts):
        self.calls += 1
        return [-float(len(t)) / 3.0 for t in texts]

    def generate_until(self, requests):
        self.calls += 1
        return [c[-6:] + " 42" for c, _ in requests]


def test_caching_lm_equals_jax(tmp_path):
    reqs = _requests(1, 4)
    out = []
    for mod, name in ((caching, "port"), (jax_caching, "jax")):
        inner = _MockLM()
        lm = mod.CachingLM(inner, str(tmp_path / f"{name}.sqlite"),
                           cache_tag="step-1")
        first = (lm.loglikelihood(reqs), lm.loglikelihood_rolling(["ab", "c"]),
                 lm.generate_until([("q: x", {"until": ["\n"]})]))
        again = (lm.loglikelihood(reqs), lm.loglikelihood_rolling(["ab", "c"]),
                 lm.generate_until([("q: x", {"until": ["\n"]})]))
        assert first == again and inner.calls == 3
        out.append(first)
    assert out[0] == out[1]


def _suite(mod, docs_mod):
    """Tasks of every request type over small synthetic docs."""
    hs = [{"activity_label": "Cooking", "ctx_a": "She stirs the pot.",
           "ctx_b": "then she", "endings": [f"adds salt {i}." for i in
                                            range(4)], "label": i % 4}
          for i in range(5)]
    wino = [{"sentence": "The cup fell off the table because _ was wobbly.",
             "option1": "the cup", "option2": "the table", "answer": "2"}]
    return [docs_mod.HellaSwag(docs=hs), docs_mod.Winogrande(docs=wino),
            docs_mod.LambadaOpenAI(docs=_fixture("lambada_pg", 5)),
            docs_mod.Wikitext(docs=_fixture("wikitext_pg", 2)),
            docs_mod.TriviaQA(docs=_trivia_docs()[:4]),
            docs_mod.GSM8K(docs=_fixture("gsm8k_style", 3))]


def test_evaluate_with_a_mock_lm_equals_jax():
    got = harness.evaluate(_MockLM(), _suite(harness, tasks),
                           return_per_doc=True)
    want = jax_harness.evaluate(_MockLM(), _suite(jax_harness, jax_tasks),
                                return_per_doc=True)
    assert got == want
    assert harness.make_table(got) == jax_harness.make_table(want)
    assert tasks.wikitext_detokenizer(" @-@ a ( b ) = = x") == \
        jax_tasks.wikitext_detokenizer(" @-@ a ( b ) = = x")


# ---------------------------------------------------------------------------
# adapters on the same parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nopad", [False, True])
def test_block_adapter_loglikelihood_equals_jax(block_models, nopad):
    cfg, tcfg, pj, pt = block_models
    tok = tokenizer.ByteTokenizer()
    lj = jax_adapters.BlockTransformerLM(pj, cfg, tok, max_length=64,
                                         batch_size=4, nopad=nopad)
    lt = adapters.BlockTransformerLM(pt, tcfg, tok, max_length=64,
                                     batch_size=4, nopad=nopad)
    reqs = _requests(0)
    _assert_ll_equal(lt.loglikelihood(reqs), lj.loglikelihood(reqs))
    # token requests whose continuation is the greedy one, and one longer
    # than max_length (cut from the left)
    rng = np.random.default_rng(2)
    treqs = [_greedy_request(lt, rng.integers(3, 259, n).tolist(), 3)
             for n in (9, 30)]
    treqs.append((rng.integers(3, 259, 50).tolist(),
                  rng.integers(3, 259, 30).tolist()))
    got = lt._loglikelihood_tokens(treqs)
    _assert_ll_equal(got, lj._loglikelihood_tokens(treqs))
    assert [g for _, g in got] == [True, True, False]


def test_vanilla_adapter_loglikelihood_equals_jax():
    kw = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=256, max_position_embeddings=256)
    vcfg, tvcfg = jax_config.NeoXConfig(**kw), torch_config.NeoXConfig(**kw)
    vj = jax.device_get(jax_vanilla.init_vanilla_params(
        jax.random.PRNGKey(1), vcfg))
    tok = tokenizer.ByteTokenizer()
    lj = jax_adapters.VanillaLM(vj, vcfg, tok, max_length=64, batch_size=4)
    lt = adapters.VanillaLM(bridge.params_from_numpy(vj, "cpu"), tvcfg, tok,
                            max_length=64, batch_size=4)
    reqs = _requests(5)
    _assert_ll_equal(lt.loglikelihood(reqs), lj.loglikelihood(reqs))
    treq = [_greedy_request(lt, [7, 90, 200, 41], 4)]
    got = lt._loglikelihood_tokens(treq)
    _assert_ll_equal(got, lj._loglikelihood_tokens(treq))
    assert got[0][1]


def test_loglikelihood_rolling_equals_jax(block_models):
    cfg, tcfg, pj, pt = block_models
    tok = tokenizer.ByteTokenizer()
    rng = np.random.default_rng(4)
    texts = ["".join(chr(c) for c in rng.integers(32, 127, n))
             for n in (30, 150, 70, 64)]
    got = adapters.BlockTransformerLM(pt, tcfg, tok, max_length=64,
                                      batch_size=3).loglikelihood_rolling(
                                          texts)
    want = jax_adapters.BlockTransformerLM(
        pj, cfg, tok, max_length=64, batch_size=3).loglikelihood_rolling(texts)
    np.testing.assert_allclose(got, want, rtol=0, atol=LL_TOL)


def test_generate_until_equals_jax(block_models):
    cfg, tcfg, pj, pt = block_models
    tok = tokenizer.ByteTokenizer()
    reqs = [("abc def ghi", {"until": ["\n"], "max_gen_toks": 12}),
            ("xyz" * 10, {"until": ["q", "Z"], "max_gen_toks": 20}),
            ("hello", {"max_gen_toks": 12}),
            ("a longer context " * 5, {"until": ["\n"], "max_gen_toks": 12})]
    got = adapters.BlockTransformerLM(pt, tcfg, tok, max_length=96,
                                      batch_size=3).generate_until(reqs)
    want = jax_adapters.BlockTransformerLM(
        pj, cfg, tok, max_length=96, batch_size=3).generate_until(reqs)
    assert got == want and all(isinstance(s, str) for s in got)


def _assert_results_close(got, want):
    assert sorted(got) == sorted(want)
    for task, metrics in want.items():
        assert sorted(got[task]) == sorted(metrics), task
        for m, v in metrics.items():
            np.testing.assert_allclose(got[task][m], v, rtol=RESULTS_TOL,
                                       atol=RESULTS_TOL,
                                       err_msg=f"{task}/{m}")


def test_fixture_suite_equals_jax():
    """LambadaOpenAI, Wikitext, TriviaQA and GSM8K on 2-3 docs of the
    repo's fixtures, byte tokenizer, through ``evaluate`` on both (hidden
    64, one layer)."""
    cfg, tcfg, pj, pt = _block_models(seed=1, hidden=64, layers=1)
    tok = tokenizer.ByteTokenizer()

    def suite(mod):
        return [mod.LambadaOpenAI(docs=_fixture("lambada_pg", 3)),
                mod.Wikitext(docs=_fixture("wikitext_pg", 2)),
                mod.TriviaQA(docs=_trivia_docs()[:3]),
                mod.GSM8K(docs=_fixture("gsm8k_style", 2))]

    got = harness.evaluate(adapters.BlockTransformerLM(
        pt, tcfg, tok, max_length=384, batch_size=4), suite(tasks))
    want = jax_harness.evaluate(jax_adapters.BlockTransformerLM(
        pj, cfg, tok, max_length=384, batch_size=4), suite(jax_tasks))
    _assert_results_close(got["results"], want["results"])
    assert np.isfinite(got["results"]["wikitext"]["bits_per_byte"])


# ---------------------------------------------------------------------------
# the zero-shot hook through the port's Trainer
# ---------------------------------------------------------------------------

def test_eval_hook_through_the_trainer_equals_jax(tmp_path):
    kw = dict(vocab_size=320, max_length=256)
    cfg = jax_config.make_block_config("t", 64, 1, **kw)
    tcfg = torch_config.make_block_config("t", 64, 1, **kw)
    docs = {"lambada_openai": _fixture("lambada_pg", 3)}
    tok = tokenizer.ByteTokenizer()
    out = str(tmp_path / "port")
    hook = eval_callback.make_zeroshot_eval_hook(
        tcfg, tok, ["lambada_openai"], eval_steps=2, output_dir=out,
        max_length=64, batch_size=2, docs_by_task=docs)
    seen = {}

    def spy(step, state):
        res = hook(step, state)
        if res is not None:
            # a copy: the optimizer updates the parameters in place
            seen[step] = jax.tree.map(np.array, bridge.params_to_numpy(
                state["params"]))
        return res

    ds = packing.PackedDataset(synthetic_corpus(4000, 320, 64), 32,
                               eos_token=0, pad_token=0, block_length=4)
    t = trainer_lib.Trainer(tcfg, trainer_lib.TrainerConfig(
        output_dir=str(tmp_path / "run"), num_train_steps=5, stop_steps=5,
        num_warmup_steps=1, total_batch_size=2, max_length=32,
        logging_steps=10, save_steps=100, remat=False), ds, eval_hook=spy,
        device="cpu")
    t.train()
    with open(os.path.join(out, "zeroshot_eval.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2, 4] == sorted(seen)

    jout = str(tmp_path / "jax")
    jhook = jax_eval_callback.make_zeroshot_eval_hook(
        cfg, jax_tokenizer.load_tokenizer("byte"), ["lambada_openai"],
        eval_steps=2, output_dir=jout, max_length=64, batch_size=2,
        docs_by_task=docs)
    assert jhook(3, {"params": seen[4]}) is None
    for step in (2, 4):
        jhook(step, {"params": seen[step]})
    with open(os.path.join(jout, "zeroshot_eval.jsonl")) as f:
        want = [json.loads(line) for line in f]
    for r, w in zip(recs, want):
        assert sorted(r) == sorted(w) and r["step"] == w["step"]
        for k in w:
            np.testing.assert_allclose(r[k], w[k], rtol=RESULTS_TOL,
                                       atol=RESULTS_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# byte tasks and the entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def byte_corpus(tmp_path_factory):
    """A byte-token holdout corpus (ids = byte + 3) of the fixture texts,
    in the indexed format ``scripts/build_byte_corpus.py`` writes."""
    from block_transformer_tpu_torch.data import mmap_dataset
    texts = [d["text"] for d in _fixture("lambada_pg", 40)] + \
        [d["page"] for d in _fixture("wikitext_pg", 4)]
    prefix = str(tmp_path_factory.mktemp("bytes") / "holdout")
    mmap_dataset.write_mmap_dataset(
        prefix, [tokenizer.ByteTokenizer().encode(t) for t in texts])
    return prefix


def test_byte_tasks_equal_jax(byte_corpus):
    from block_transformer_tpu.eval import byte_tasks as jax_byte_tasks
    from block_transformer_tpu_torch.eval import byte_tasks
    kw = dict(n_mc=6, n_ppl=3, ctx_chars=200, cont_chars=24, seed=2)
    got = byte_tasks.byte_tasks_from_prefix(byte_corpus, **kw)
    want = jax_byte_tasks.byte_tasks_from_prefix(byte_corpus, **kw)
    assert [t.name for t in got] == [t.name for t in want]
    for g, w in zip(got, want):
        assert g.docs() == w.docs()
        assert [g.build_requests(d) for d in g.docs()] == \
            [w.build_requests(d) for d in w.docs()]


def test_entry_point_on_the_cpu(tmp_path, byte_corpus):
    """``--random`` with the byte tasks, then ``--ckpt`` (an exported HF
    tree, quantized INT8, and the port's own ``checkpoint-<step>``) and
    ``--sweep``, all with ``--cpu``."""
    from block_transformer_tpu_torch import eval_zero_shot_task as entry
    from block_transformer_tpu_torch.models import block_transformer as bt
    from block_transformer_tpu_torch.train import train_step as ts
    from block_transformer_tpu_torch.utils import checkpoint as ckpt
    from block_transformer_tpu_torch.utils import torch_export
    common = ["--model", "block_main_b4_5", "--vocab_size", "320",
              "--byte_corpus", byte_corpus, "--limit", "1",
              "--batch_size", "4", "--max_length", "128", "--cpu"]
    out = str(tmp_path / "res.json")
    res = entry.main(common + ["--random", "--out", out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert sorted(res["results"]) == ["pybytes_nextchunk", "pybytes_wikitext"]
    assert all(np.isfinite(v) for m in res["results"].values()
               for v in m.values())

    tcfg = torch_config.get_config("block_main_b4_5", vocab_size=320)
    params = bt.init_block_transformer_params(1, tcfg, device="cpu")
    hf = torch_export.export_block_transformer(params, tcfg,
                                               str(tmp_path / "hf"))
    a = entry.main(common + ["--ckpt", hf, "--quantize", "int8"])
    run = str(tmp_path / "run")
    for step in (1, 2):
        ckpt.save_checkpoint(run, step, ts.TrainState(params, None, step))
    b = entry.main(common + ["--ckpt", os.path.join(run, "checkpoint-2"),
                             "--quantize", "int8"])
    assert a == b
    entry.main(common + ["--sweep", run, "--step_interval", "2",
                         "--quantize", "int8"])
    with open(os.path.join(run, "eval_sweep.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2]
    assert recs[0]["pybytes_wikitext"] == a["results"]["pybytes_wikitext"]
