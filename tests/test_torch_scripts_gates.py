"""The port's quantization gates (``block_transformer_tpu_torch/scripts/``:
``decode_gate``, ``gptq_gate``, ``qat_finetune``, ``gate_seed_summary``,
``real_task_eval``) against the JAX package's ``scripts/``, on the CPU, at
a tiny size, on the same JAX-initialised parameters (``bridge.py``). Where
the JAX script keeps the logic inside ``main()``, JAX's side is recomputed
here from the JAX package, and the script's lines are cited.

Tolerances: the decode gate's prompts and greedy tokens equal, its fp32
logprobs within 1e-4 relative; the GPTQ tree's Q as in
``tests/test_torch_gptq.py`` (at least 99.9% of the entries equal, the rest
one step apart; the other leaves within 1e-5 relative); the QAT losses of
two steps within 1e-5 relative, the ``--distill`` KL (~2e-4, a
difference of two nearly equal log-softmaxes) within 1e-7 absolute
instead, and the student's parameters after the two steps within 1e-5
absolute; the seed summary equal; the real-task report within 1e-4,
absolute or relative. The port's remaining entry
points (the ``--merge`` protocol, the QAT ppl gate, the KV and long-context
evaluations) run end to end on the CPU, their reports in the JAX scripts'
layouts.
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.data.mmap_dataset import MMapIndexedDataset
from block_transformer_tpu.data.packing import make_train_batch
from block_transformer_tpu.eval import adapters as jax_adapters
from block_transformer_tpu.eval import harness as jax_harness
from block_transformer_tpu.eval import tasks as jax_tasks
from block_transformer_tpu.inference import generate as jax_gen
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.models import vanilla as jax_vanilla
from block_transformer_tpu.ops import gptq as jax_gptq
from block_transformer_tpu.ops import quant as jax_quant
from block_transformer_tpu.train import optimizer as jax_opt
from block_transformer_tpu.train import train_step as jax_ts
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.ops import gptq, quant
from block_transformer_tpu_torch.scripts import (decode_gate,
                                                 gate_seed_summary,
                                                 gptq_gate, kv_quality_cpu,
                                                 longctx_quality_cpu,
                                                 qat_finetune, qat_ppl_gate,
                                                 real_task_eval)
from block_transformer_tpu_torch.scripts import quality_run as qr
from block_transformer_tpu_torch.train import optimizer as torch_opt
from block_transformer_tpu_torch.train import train_step as torch_ts
from block_transformer_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_qat import jax_fake_quant
from tests.test_torch_scripts_quality import (  # noqa: F401 (a fixture)
    assert_results_close, build_argv, jax_script, one_torch_thread,
    tiny_configs, write_text_tree)

LP_RTOL = 1e-4
LOSS_RTOL = 1e-5
# the KL of --distill (~2e-4 here) is a difference of two nearly equal
# log-softmaxes: the JAX and torch float32 forwards put it 1.1e-8 to 4.2e-8
# apart, so it is held to 1e-7 absolute (5e-4 of its size), not 1e-5
# relative
KD_ATOL = 1e-7
# the student after the two steps: each Adam step moves an entry by up to
# the peak lr (1e-3); held to 1% of that (2.0e-6 seen)
PARAM_ATOL = 1e-5
GPTQ_EQUAL = 0.999
MAX_LEN = 64
PROMPTS, PROMPT_LEN, GEN_TOKENS = 4, 32, 8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The fixture tree's corpus (``build_byte_corpus``): the train
    prefix."""
    from block_transformer_tpu_torch.scripts import build_byte_corpus
    tmp = tmp_path_factory.mktemp("corpus")
    build_byte_corpus.main(build_argv(write_text_tree(tmp / "tree"),
                                      tmp / "pybytes"))
    return str(tmp / "pybytes")


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = tiny_configs()
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(3), cfg_j))
    return cfg_j, cfg_t, pj, bridge.params_from_numpy(pj, "cpu")


# ---------------------------------------------------------------------------
# decode_gate
# ---------------------------------------------------------------------------

def jax_prompts(prefix, batch, prompt_len, seed):
    """The JAX script's prompt draw (``scripts/decode_gate.py:229-241``)."""
    data, lengths, starts = MMapIndexedDataset(prefix).token_view()
    rng = np.random.default_rng(seed)
    prompts = []
    while len(prompts) < batch:
        i = int(rng.integers(len(lengths)))
        if lengths[i] < prompt_len + 1:
            continue
        st = int(rng.integers(0, lengths[i] - prompt_len))
        s = int(starts[i])
        prompts.append(np.asarray(data[s + st:s + st + prompt_len],
                                  np.int32))
    return np.stack(prompts)


def jax_decode(params, cfg, prompts, kv_cache, gen_tokens):
    """The JAX worker's decode (``scripts/decode_gate.py:87-96``)."""
    d = jax_gen.preprocess_inputs(cfg, prompts)
    B, N, L = d["input_ids"].shape
    max_blocks = N + gen_tokens // L
    res = jax_gen.generate_blocks(params, cfg, jnp.asarray(d["input_ids"]),
                                  jnp.asarray(d["attention_mask"]),
                                  jnp.asarray(d["block_attention_mask"]),
                                  max_blocks=max_blocks, greedy=True,
                                  kv_cache=kv_cache)
    return np.asarray(res.tokens).reshape(B, -1)[:, N * L:max_blocks * L]


def jax_fp32_lp(params, cfg, prompts, toks, gen_tokens):
    """The JAX script's scorer (``scripts/decode_gate.py:315-335``)."""
    L = cfg.block_length
    pl_len = prompts.shape[1]
    params = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def score(full_ids):
        B = full_ids.shape[0]
        N = full_ids.shape[1] // L
        ids = full_ids.reshape(B, N, L)
        att = jnp.ones_like(ids)
        bam = jnp.ones((B, N), jnp.int32)
        out = jax_bt.block_transformer_forward(params, cfg, ids, att, bam)
        logits = out.logits.reshape(B, (N - 1) * L, -1)
        tgt = full_ids[:, L:]
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        tok_lp = jnp.take_along_axis(lp, tgt[:, :, None], -1)[..., 0]
        return tok_lp[:, pl_len - L:].mean()

    full = np.concatenate([prompts, toks[:, :gen_tokens]], 1)
    return float(score(jnp.asarray(full, jnp.int32)))


def test_decode_gate_equals_jax(corpus, models):
    """The prompts, the reference decode (fp32 weights, bf16 KV) and the
    ``int8w_int8kv`` variant's: tokens equal, fp32 logprobs within 1e-4."""
    cfg_j, cfg_t, pj, pt = models
    hold = corpus + "_holdout"
    want = jax_prompts(hold, PROMPTS, PROMPT_LEN, 3)
    prompts = decode_gate.sample_prompts(hold, PROMPTS, PROMPT_LEN, 3)
    np.testing.assert_array_equal(prompts, want)
    score = decode_gate.fp32_scorer(pt, cfg_t, prompts, GEN_TOKENS)
    for tj, tt, kv in ((pj, pt, "bf16"),
                       (jax_quant.quantize_block_transformer(pj, bits=8),
                        quant.quantize_block_transformer(pt, bits=8),
                        "int8")):
        toks_j = jax_decode(tj, cfg_j, prompts, kv, GEN_TOKENS)
        toks = decode_gate.run_variant(tt, cfg_t, prompts, kv, GEN_TOKENS)
        np.testing.assert_array_equal(toks, toks_j)
        np.testing.assert_allclose(
            score(toks), jax_fp32_lp(pj, cfg_j, prompts, toks_j, GEN_TOKENS),
            rtol=LP_RTOL)


# ---------------------------------------------------------------------------
# gptq_gate
# ---------------------------------------------------------------------------

def jax_calibration(prefix, cfg, n_samples, batch):
    """The JAX script's calibration batches (``scripts/gptq_gate.py:
    105-113``)."""
    jqr = jax_script("quality_run")
    ds = jqr.make_dataset(jqr.load_corpus(prefix), MAX_LEN,
                          cfg.block_length, seed=3)
    out = []
    for s in range(0, n_samples, batch):
        idxs = (np.arange(s, s + batch) * 17) % len(ds)
        b = make_train_batch(ds, idxs, cfg.block_length)
        out.append((b["input_ids"], b["attention_mask"],
                    b["block_attention_mask"]))
    return out


def test_gptq_gate_tree_equals_jax(corpus, models):
    """``gptq_int4_g32_head8`` (act order, as ``--act_order``), calibrated
    on 8 samples: Q as in ``tests/test_torch_gptq.py``."""
    cfg_j, cfg_t, pj, pt = models
    want_calib = jax_calibration(corpus, cfg_j, 8, 4)
    calib = qr.calibration_batches(corpus, cfg_t, MAX_LEN, 8, 4)
    for got, want in zip(calib, want_calib, strict=True):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    kw = dict(bits=4, group_size=32, lm_head_bits=8, damp=0.01,
              act_order=True)
    want = jax.device_get(jax_gptq.gptq_quantize_block_transformer(
        pj, cfg_j, want_calib, **kw))
    got = gptq.gptq_quantize_block_transformer(pt, cfg_t, calib,
                                               device="cpu", **kw)
    flat_got = dict(torch_opt.tree_items(got))
    flat_want = {tuple(k.key for k in p): np.asarray(v) for p, v in
                 jax.tree_util.tree_leaves_with_path(want)}
    assert sorted(flat_got) == sorted(flat_want)
    n = equal = 0
    for path, w in flat_want.items():
        g = bridge.tensor_to_numpy(flat_got[path])
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path[-1] in ("kernel_q4", "kernel_q8"):
            unpack = (quant.unpack_int4 if path[-1] == "kernel_q4"
                      else lambda t: t)
            a = unpack(torch.from_numpy(w.copy())).numpy().astype(int)
            b = unpack(torch.from_numpy(g)).numpy().astype(int)
            assert np.abs(a - b).max() <= 1, path
            n, equal = n + a.size, equal + int((a == b).sum())
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                       err_msg=str(path))
    assert equal >= GPTQ_EQUAL * n, (equal, n)


# ---------------------------------------------------------------------------
# qat_finetune
# ---------------------------------------------------------------------------

QAT_LR = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10,
              weight_decay=0.1, b1=0.9, b2=0.95)


def jax_qat_losses(cfg, params, batches, recipe, distill):
    """Two of the JAX script's steps (``scripts/qat_finetune.py:98-142``,
    the step ``:144-146``), its fake quant taken op by op
    (``tests/test_torch_qat.jax_fake_quant``: under jit XLA may divide by a
    constant through its reciprocal): (losses, the parameters after)."""
    from scripts.qat_finetune import RECIPES
    tx, _ = jax_opt.make_optimizer(**QAT_LR)
    deltas, transform = jax_fake_quant(RECIPES[recipe])
    teacher = jax.tree.map(jnp.copy, params)

    def kd_loss(p, d, tch, batch):
        ids, am, bam = (batch["input_ids"], batch["attention_mask"],
                        batch["block_attention_mask"])
        ls = jax_bt.block_transformer_forward(
            transform(p, d), cfg, ids, am, bam, remat=True).logits
        lt = jax.lax.stop_gradient(jax_bt.block_transformer_forward(
            tch, cfg, ids, am, bam, remat=True).logits)
        kl = jnp.sum(jax.nn.softmax(lt, -1)
                     * (jax.nn.log_softmax(lt, -1)
                        - jax.nn.log_softmax(ls, -1)), -1)
        w = (batch["labels"][:, 1:, :] != -100).astype(jnp.float32)
        loss = jnp.sum(kl * w) / jnp.maximum(jnp.sum(w), 1.0)
        return loss, {"loss": loss}

    @jax.jit
    def step(state, d, batch):
        if distill:
            (_, metrics), grads = jax.value_and_grad(
                kd_loss, has_aux=True)(state.params, d, teacher, batch)
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            new_p = jax.tree.map(lambda a, u: a + u.astype(a.dtype),
                                 state.params, updates)
            return jax_ts.TrainState(new_p, opt_state,
                                     state.step + 1), metrics
        return jax_ts.make_train_step(
            cfg, tx, remat=True,
            param_transform=lambda q: transform(q, d))(state, batch)

    state = jax_ts.TrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
    losses = []
    for b in batches:
        state, metrics = step(state, deltas(state.params),
                              {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return losses, jax.device_get(state.params)


@pytest.mark.parametrize("distill", [False, True], ids=["plain", "distill"])
def test_qat_steps_equal_jax(corpus, models, distill):
    cfg_j, cfg_t, pj, pt = models
    ds = qr.make_dataset(qr.load_corpus(corpus), MAX_LEN,
                         cfg_t.block_length, seed=11)
    batches = [packing.make_train_batch(
        ds, (np.arange(2) + i * 2) % len(ds), cfg_t.block_length)
        for i in range(2)]
    want, want_params = jax_qat_losses(cfg_j, pj, batches, "mixed48",
                                       distill)
    params = torch_opt.tree_map(lambda t: t.clone(), pt)
    tx, _ = torch_opt.make_optimizer(**QAT_LR)
    teacher = (torch_opt.tree_map(lambda t: t.detach().clone(), params)
               if distill else None)
    step_fn = qat_finetune.make_step_fn(cfg_t, tx, "mixed48", teacher)
    state = torch_ts.TrainState(params, tx.init(params), 0)
    got = []
    for b in batches:
        state, metrics = step_fn(state, packing.to_device(b, "cpu"))
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=0 if distill else LOSS_RTOL,
                               atol=KD_ATOL if distill else 0)
    assert got[1] != got[0]
    flat_want = {tuple(k.key for k in p): np.asarray(v) for p, v in
                 jax.tree_util.tree_leaves_with_path(want_params)}
    flat_got = dict(torch_opt.tree_items(state.params))
    assert sorted(flat_got) == sorted(flat_want)
    for path, w in flat_want.items():
        np.testing.assert_allclose(flat_got[path].detach().numpy(), w,
                                   rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(path))
    if distill:     # the teacher is its own copy, not the trained tree
        for path, t in torch_opt.tree_items(teacher):
            np.testing.assert_array_equal(
                t.numpy(), dict(torch_opt.tree_items(pt))[path].numpy())


# ---------------------------------------------------------------------------
# gate_seed_summary
# ---------------------------------------------------------------------------

def test_gate_seed_summary_equals_jax(tmp_path, monkeypatch):
    rows = {"int8kv": [0.1, 0.2, 0.15], "int4kv": [0.7, 0.9, 0.8],
            "mixed48_int4kv": [0.4, 0.6, 0.5], "w8a8_int8w_int8kv": [0.3]}
    paths = []
    for i, seed in enumerate((3, 17, 29)):
        rep = {"prompt_seed": seed, "variants": {
            name: {"fp32_logprob_delta_pct": v[i]}
            for name, v in rows.items() if i < len(v)}}
        rep["variants"]["failed"] = {"error": "no delta"}
        paths.append(str(tmp_path / f"gate_s{seed}.json"))
        with open(paths[-1], "w") as f:
            json.dump(rep, f)
    jgs = jax_script("gate_seed_summary")
    monkeypatch.setattr(sys, "argv", ["gate_seed_summary.py", *paths,
                                      "--out", str(tmp_path / "jax.json")])
    jgs.main()
    got = gate_seed_summary.main([*paths, "--out",
                                  str(tmp_path / "port.json")])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert got == want
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert {n: r["verdict"] for n, r in got["variants"].items()} == {
        "int8kv": "PASS", "int4kv": "FAIL", "mixed48_int4kv": "BORDERLINE",
        "w8a8_int8w_int8kv": "PASS(n=1)"}


# ---------------------------------------------------------------------------
# real_task_eval and the remaining entry points, on a block_main_b4_5 tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """JAX-initialised ``block_main_b4_5`` (byte vocab, max length 64) and
    ``vanilla_31`` trees saved as the port's checkpoints, as
    ``quality_run`` lays them out: (out dir, JAX config, JAX block
    parameters)."""
    out = tmp_path_factory.mktemp("quality")
    cfg = jax_config.get_config("block_main_b4_5", vocab_size=qr.VOCAB,
                                max_length=MAX_LEN)
    vcfg = jax_config.get_vanilla_config(
        "vanilla_31", vocab_size=qr.VOCAB, max_position_embeddings=MAX_LEN)
    pj = jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(5), cfg))
    vj = jax.device_get(jax_vanilla.init_vanilla_params(
        jax.random.PRNGKey(6), vcfg))
    for name, tree in (("block_main_b4_5", pj), ("vanilla_31", vj)):
        ckpt.save_checkpoint(str(out / name), 1, torch_ts.TrainState(
            bridge.params_from_numpy(tree, "cpu"), None, 1))
    return out, cfg, pj


def test_real_task_eval_equals_jax(checkpoints, tmp_path):
    """``--limit 2``, batch 4: the report of the JAX script's loop
    (``scripts/real_task_eval.py:136-164``) within 1e-4."""
    out, cfg, pj = checkpoints
    jrt = jax_script("real_task_eval")
    fx = {n: jrt.load_fixture(os.path.join(real_task_eval.FIXTURES, f))[:2]
          for n, f in (("lambada", "lambada_pg.jsonl"),
                       ("wikitext", "wikitext_pg.jsonl"),
                       ("trivia", "trivia_real.jsonl"),
                       ("gsm8k", "gsm8k_style.jsonl"))}
    suite = [jax_tasks.LambadaOpenAI(docs=fx["lambada"]),
             jax_tasks.Wikitext(docs=fx["wikitext"]),
             jax_tasks.TriviaQA(docs=fx["trivia"]),
             jax_tasks.GSM8K(docs=fx["gsm8k"])]
    want = {}
    for vname, p in (
            ("fp32", pj),
            ("int8", jax_quant.quantize_block_transformer(pj, bits=8)),
            ("int4_g32", jax_quant.quantize_block_transformer(
                pj, bits=4, group_size=32, lm_head_bits=8))):
        lm = jax_adapters.BlockTransformerLM(p, cfg, jrt.ByteTokenizer(),
                                             max_length=MAX_LEN,
                                             batch_size=4)
        res = jax_harness.evaluate(lm, suite, return_per_doc=True)
        r = res["results"]
        r["lambada_openai"]["acc_split"] = jrt.split_seen(
            res["per_doc"]["lambada_openai"], fx["lambada"], "acc")
        want[vname] = r
    got = real_task_eval.main([
        "--cpu", "--model_dir", str(out / "block_main_b4_5"), "--out",
        str(tmp_path), "--limit", "2", "--batch", "4", "--max_length",
        str(MAX_LEN)])
    for vname, r in want.items():
        g = dict(got[vname], lambada_openai=dict(got[vname]["lambada_openai"]))
        split_w = r["lambada_openai"].pop("acc_split")
        split_g = g["lambada_openai"].pop("acc_split")
        assert sorted(split_g) == sorted(split_w)
        for k, v in split_w.items():
            np.testing.assert_allclose(split_g[k], v, rtol=1e-4, atol=1e-4)
        assert_results_close(g, r)
    assert sorted(got) == ["fp32", "gates_vs_fp32", "int4_g32", "int8",
                           "seen_split_note"]
    with open(tmp_path / "real_tasks.json") as f:
        assert sorted(json.load(f)) == sorted(got)


def test_the_entry_points_run_on_the_cpu(corpus, checkpoints, tmp_path,
                                         monkeypatch):
    """``decode_gate --w8a8`` then ``--only ... --merge``,
    ``gate_seed_summary`` over two prompt seeds, ``gptq_gate``,
    ``qat_finetune --distill`` and ``qat_ppl_gate``, ``kv_quality_cpu`` and
    ``longctx_quality_cpu``, each with ``--cpu`` at max length 64: finite
    numbers in the JAX scripts' layouts."""
    out, _, _ = checkpoints
    block = str(out / "block_main_b4_5")
    common = ["--cpu", "--max_length", str(MAX_LEN)]
    gate = ["--model_dir", block, "--corpus", corpus + "_holdout",
            "--train_corpus", corpus, "--batch", "4", "--prompt_len",
            str(PROMPT_LEN), "--gen_tokens", str(GEN_TOKENS)] + common
    reports = [str(tmp_path / f"gate_s{s}.json") for s in (3, 17)]
    rep = decode_gate.main(gate + ["--w8a8", "--out", reports[0]])
    assert list(rep["variants"]) == [
        "fp32_bf16kv", "int8kv", "int4kv", "int8w_int8kv", "int8w_int4kv",
        "mixed48_int4kv", "mixed48_int8kv", "int4w_int8kv",
        "w8a8_int8w_int8kv", "w8a8_int8w_int4kv"]
    # the control row decodes exactly the reference; on the CPU the W8A8
    # rows take no W8A8, so they decode the INT8 rows' tokens
    v = rep["variants"]
    assert v["fp32_bf16kv"]["greedy_agreement"] == 1.0
    for kv in ("int8", "int4"):
        assert v[f"w8a8_int8w_{kv}kv"] == v[f"int8w_{kv}kv"]
    assert all(np.isfinite(r["fp32_mean_logprob"]) for r in v.values())
    merged = decode_gate.main(gate + ["--only", "int8kv", "--merge",
                                      "--out", reports[0]])
    assert merged["variants"] == v
    with open(reports[0]) as f:           # another reference: refused
        other = dict(json.load(f), fp32_mean_logprob_ref=-1.0)
    with open(tmp_path / "other.json", "w") as f:
        json.dump(other, f)
    with pytest.raises(ValueError, match="refusing to merge"):
        decode_gate.main(gate + ["--only", "int8kv", "--merge", "--out",
                                 str(tmp_path / "other.json")])
    decode_gate.main(gate + ["--only", "int8kv", "--prompt_seed", "17",
                             "--out", reports[1]])
    summary = gate_seed_summary.main(reports)
    assert summary["seeds"] == [3, 17]
    assert summary["variants"]["int8kv"]["n"] == 2

    g = gptq_gate.main(["--model_dir", block, "--corpus", corpus, "--out",
                        str(tmp_path / "gptq.json"), "--calib_samples", "4",
                        "--calib_batch", "2", "--eval_samples", "4",
                        "--eval_batch", "4", "--configs",
                        "gptq_int4_g128,gptq_mixed48"] + common)
    assert list(g["configs"]) == ["rtn_int4_g128", "rtn_int4_g32_head8",
                                  "gptq_int4_g128", "gptq_mixed48"]

    qat_dir = str(tmp_path / "qat")
    meta = qat_finetune.main(["--model_dir", block, "--corpus", corpus,
                              "--recipe", "mixed48", "--distill", "--steps",
                              "2", "--batch", "2", "--out_dir", qat_dir]
                             + common)
    assert meta["distill"] and len(meta["losses_per_100"]) == 1
    q = qat_ppl_gate.main(["--qat_dir", qat_dir, "--baseline_dir", block,
                           "--corpus", corpus, "--eval_samples", "4",
                           "--eval_batch", "4", "--out",
                           str(tmp_path / "qat_ppl.json")] + common)
    assert q["qat_steps"] == 2 and np.isfinite(q["quantized_qat_ppl"])

    monkeypatch.setattr(qr, "decode_agreement", functools.partial(
        qr.decode_agreement, n_prompts=2, prompt_len=PROMPT_LEN,
        gen_tokens=GEN_TOKENS))
    kv = kv_quality_cpu.main(["--out", str(out), "--corpus", corpus]
                             + common)
    assert sorted(kv) == sorted([
        "int8_kv_vs_bf16_kv_match", "int8_w_int8_kv_vs_fp_match",
        "int4_kv_vs_bf16_kv_match", "int8_w_int4_kv_vs_fp_match",
        "mixed48_int4_kv_vs_fp_match"])
    # a corpus of four files, so that its holdout is a few chunks long
    small = tmp_path / "small"
    (small / "tree").mkdir(parents=True)
    for f in sorted(write_text_tree(tmp_path / "tree").glob("lambada*"))[:4]:
        (small / "tree" / f.name).write_text(f.read_text())
    from block_transformer_tpu_torch.scripts import build_byte_corpus
    build_byte_corpus.main(["--out", str(small / "pybytes"), "--roots",
                            str(small / "tree"), "--holdout_every", "2"])
    lc = longctx_quality_cpu.main(["--out", str(out), "--corpus",
                                   str(small / "pybytes"),
                                   "--context_length", str(MAX_LEN),
                                   "--cpu"])
    assert lc["n_chunks"] > 0 and len(lc["needle"]) > 0
    assert np.isfinite(lc["block_loss_last_64_mean"])
