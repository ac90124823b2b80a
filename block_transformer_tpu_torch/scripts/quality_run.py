"""End-to-end quality pipeline: train -> checkpoint -> eval harness -> quant
(port of ``scripts/quality_run.py``).

It measures how much quantization costs a model trained through the port's
whole pipeline (trainer -> checkpoint -> eval adapter -> harness -> the
quantized kernels), on the byte-level local corpus of
``build_byte_corpus``. Phases (training resumes from the checkpoints on
disk):

  1. train a ``block_main_b4_5``-shaped model (byte vocab) on the corpus;
  2. train the ``vanilla_31``-shaped baseline on the same corpus;
  3. held-out teacher-forced ppl: block at fp32, INT8, INT4, mixed48 and the
     INT4 gate recipe (g32 + INT8 head), vanilla at fp32;
  4. harness tasks (byte-level MC + rolling perplexity) at fp32, INT8, INT4;
  5. greedy-decode agreement: bf16 KV against INT8 / INT4 KV and quantized
     weights;
  6. ``quality.json`` and ``QUALITY.md`` into ``--out``.

Everything runs on the card unless ``--cpu`` is given (no environment
switch). The float32 rows are true float32: the script logs
``torch.backends.cuda.matmul.allow_tf32``, which stays False. Checkpoints
are the port's (``utils/checkpoint.py``); their parameters are restored
alone. ``--block_only`` leaves the baseline out of training and of the
report.

    python -m block_transformer_tpu_torch.scripts.quality_run \\
        --corpus results/corpus/pybytes --steps 3000 --batch 32 \\
        --max_length 1024 --gptq --out results/quality
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

# the byte tasks (the JAX script keeps its own copy) and the byte tokenizer;
# OFFSET and tokens_to_text are the JAX script's public names too
from block_transformer_tpu_torch.data.tokenizer import ByteTokenizer
from block_transformer_tpu_torch.eval.byte_tasks import (  # noqa: F401
    OFFSET, byte_tasks, tokens_to_text)

VOCAB = 512          # byte vocab (259 used) rounded up


def device_of(args) -> str:
    return "cpu" if args.cpu else "cuda"


def log_device(tag: str, device: str) -> None:
    """The device a script runs on, and whether float32 matmuls may take
    TF32 (they must not: the fp32 rows are the reference)."""
    name = (torch.cuda.get_device_name(0) if device == "cuda"
            else "cpu")
    print(f"[{tag}] device {device} ({name}), torch {torch.__version__}, "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}", flush=True)


def load_corpus(prefix):
    from block_transformer_tpu_torch.data.mmap_dataset import (
        MMapIndexedDataset)
    from block_transformer_tpu_torch.data.packing import TokenizedCorpus
    mm = MMapIndexedDataset(prefix)
    data, lengths, starts = mm.token_view()
    return TokenizedCorpus(data, lengths, starts)


def make_dataset(corpus, max_length, block_length, seed=42):
    from block_transformer_tpu_torch.data.packing import PackedDataset
    return PackedDataset(corpus, max_length, eos_token=0, pad_token=0,
                         block_length=block_length,
                         random_pad_first_block=True,
                         pad_to_block_boundary=True, seed=seed)


def load_params(out_dir: str, device):
    """(parameters of the latest ``checkpoint-<step>`` under ``out_dir``,
    step)."""
    from block_transformer_tpu_torch.utils import checkpoint as ckpt
    step = ckpt.find_latest_checkpoint(out_dir)
    if not step:
        raise FileNotFoundError(f"no checkpoint-<step> in {out_dir}")
    return ckpt.restore_params(out_dir, step, device=device), step


def add_ignored_optimizer_flags(ap, steps: int, lr: float = 6e-4) -> None:
    """``--lr`` and ``--steps``, which the JAX scripts take to rebuild the
    optimizer state a checkpoint is restored into: accepted, so a JAX
    command line runs unchanged, and ignored, since ``load_params``
    restores the parameters alone (``utils/checkpoint.restore_params``)."""
    why = ("accepted and ignored: the JAX script rebuilds the optimizer "
           "state to restore into; the port restores the parameters alone "
           "(utils/checkpoint.restore_params)")
    ap.add_argument("--lr", type=float, default=lr, help=why)
    ap.add_argument("--steps", type=int, default=steps, help=why)


# ---------------------------------------------------------------------------
# Phase 1+2: training
# ---------------------------------------------------------------------------

def train_block(args, cfg):
    from block_transformer_tpu_torch.train.trainer import (Trainer,
                                                           TrainerConfig)
    out = os.path.join(args.out, "block_main_b4_5")
    tcfg = TrainerConfig(output_dir=out, learning_rate=args.lr,
                         num_train_steps=args.steps,
                         num_warmup_steps=max(100, args.steps // 20),
                         total_batch_size=args.batch,
                         max_length=args.max_length,
                         save_steps=max(1, args.steps // args.n_checkpoints),
                         logging_steps=25, param_dtype="float32")
    ds = make_dataset(load_corpus(args.corpus), args.max_length,
                      cfg.block_length)
    trainer = Trainer(cfg, tcfg, ds, device=device_of(args))
    state = trainer.train(resume=True)
    return out, state


def train_vanilla(args, vcfg):
    from block_transformer_tpu_torch.train.trainer import TrainerConfig
    from block_transformer_tpu_torch.train.vanilla_trainer import (
        VanillaTrainer)
    out = os.path.join(args.out, "vanilla_31")
    tcfg = TrainerConfig(output_dir=out, learning_rate=args.lr,
                         num_train_steps=args.steps,
                         num_warmup_steps=max(100, args.steps // 20),
                         total_batch_size=args.batch,
                         # full-sequence attention residuals are [b,H,S,S]:
                         # keep the vanilla micro batch small (grad accum)
                         micro_batch_size=min(16, args.batch),
                         max_length=args.max_length,
                         save_steps=max(1, args.steps // 2),
                         logging_steps=25, param_dtype="float32")
    ds = make_dataset(load_corpus(args.corpus), args.max_length, 1)
    trainer = VanillaTrainer(vcfg, tcfg, ds, device=device_of(args))
    state = trainer.train(resume=True)
    return out, state


# ---------------------------------------------------------------------------
# Phase 3: held-out teacher-forced perplexity
# ---------------------------------------------------------------------------

def _sample_batches(ds, n_samples, batch):
    """The sample indices of each eval batch, the last one filled up from
    the front (one batch shape throughout, as the JAX script keeps one jit
    shape)."""
    for s in range(0, n_samples, batch):
        idxs = np.arange(s, min(s + batch, n_samples)) % len(ds)
        if len(idxs) < batch:
            idxs = np.concatenate([idxs, idxs[: batch - len(idxs)]])
        yield idxs


@torch.no_grad()
def heldout_ppl_block(params, cfg, ds, n_samples, batch):
    from block_transformer_tpu_torch.data.packing import (make_train_batch,
                                                          to_device)
    from block_transformer_tpu_torch.eval.adapters import params_device
    from block_transformer_tpu_torch.train.train_step import make_loss_fn
    device = params_device(params)
    loss_fn = make_loss_fn(cfg, remat=False)
    tot, n = 0.0, 0
    for idxs in _sample_batches(ds, n_samples, batch):
        b = to_device(make_train_batch(ds, idxs, cfg.block_length), device)
        tot += float(loss_fn(params, b)[0])
        n += 1
    return float(np.exp(tot / max(n, 1)))


@torch.no_grad()
def heldout_ppl_vanilla(params, vcfg, ds, n_samples, batch):
    from block_transformer_tpu_torch.data.packing import add_labels, to_device
    from block_transformer_tpu_torch.eval.adapters import params_device
    from block_transformer_tpu_torch.models import vanilla as vmod
    device = params_device(params)
    tot, n = 0.0, 0
    for idxs in _sample_batches(ds, n_samples, batch):
        raw = ds.get_batch(idxs)
        b = to_device({
            "input_ids": raw["input_ids"].astype(np.int32),
            "attention_mask": raw["attention_mask"].astype(np.int32),
            "labels": add_labels(raw["input_ids"],
                                 raw["attention_mask"]).astype(np.int32)},
            device)
        tot += float(vmod.vanilla_loss(params, vcfg, b["input_ids"],
                                       b["attention_mask"], b["labels"]))
        n += 1
    return float(np.exp(tot / max(n, 1)))


# ---------------------------------------------------------------------------
# Phase 4: harness tasks over held-out text (``byte_tasks``: a 4-way
# next-chunk multiple choice and a rolling perplexity task)
# ---------------------------------------------------------------------------

def run_harness(params, cfg, holdout, max_length, batch):
    from block_transformer_tpu_torch.eval import adapters, harness
    lm = adapters.BlockTransformerLM(params, cfg, ByteTokenizer(),
                                     max_length=max_length, batch_size=batch)
    return harness.evaluate(lm, byte_tasks(holdout), verbose=True)["results"]


# ---------------------------------------------------------------------------
# Phase 5: greedy-decode agreement (KV-cache quantization quality)
# ---------------------------------------------------------------------------

def decode_agreement(params_fp, params_q8, cfg, holdout, params_mixed=None,
                     n_prompts=8, prompt_len=256, gen_tokens=64):
    from block_transformer_tpu_torch.eval.adapters import params_device
    from block_transformer_tpu_torch.inference import generate as gen
    device = params_device(params_fp)
    rng = np.random.default_rng(1)
    prompts = []
    for _ in range(n_prompts):
        i = int(rng.integers(len(holdout.document_lengths)))
        s = int(holdout.document_indices[i])
        l = int(holdout.document_lengths[i])
        if l < prompt_len + 1:
            continue
        st = int(rng.integers(0, l - prompt_len))
        prompts.append(np.asarray(
            holdout.token_data[s + st:s + st + prompt_len], np.int32))
    prompts = np.stack(prompts)

    d = gen.preprocess_inputs(cfg, prompts)
    B, N, L = d["input_ids"].shape
    max_blocks = N + gen_tokens // L

    def run(params, kv_cache):
        res = gen.generate_blocks(
            params, cfg, d["input_ids"], d["attention_mask"],
            d["block_attention_mask"], max_blocks=max_blocks, greedy=True,
            kv_cache=kv_cache, device=device)
        toks = res.tokens.reshape(B, -1).cpu().numpy()
        return toks[:, N * L:(N + gen_tokens // L) * L]

    ref = run(params_fp, "bf16")
    out = {}
    out["int8_kv_vs_bf16_kv_match"] = float((run(params_fp, "int8") == ref).mean())
    out["int8_w_int8_kv_vs_fp_match"] = float((run(params_q8, "int8") == ref).mean())
    out["int4_kv_vs_bf16_kv_match"] = float((run(params_fp, "int4") == ref).mean())
    out["int8_w_int4_kv_vs_fp_match"] = float((run(params_q8, "int4") == ref).mean())
    if params_mixed is not None:
        # the full candidate serving default: mixed48 weights + int4 KV
        out["mixed48_int4_kv_vs_fp_match"] = float(
            (run(params_mixed, "int4") == ref).mean())
    return out


# ---------------------------------------------------------------------------

def calibration_batches(corpus_prefix, cfg, max_length, n_samples, batch):
    """GPTQ calibration samples from the TRAIN corpus (seed 3, every 17th
    sample): ``(input_ids, attention_mask, block_attention_mask)`` numpy
    batches of ``batch`` rows."""
    from block_transformer_tpu_torch.data.packing import make_train_batch
    ds_cal = make_dataset(load_corpus(corpus_prefix), max_length,
                          cfg.block_length, seed=3)
    calib = []
    for s in range(0, n_samples, batch):
        idxs = (np.arange(s, s + batch) * 17) % len(ds_cal)
        b = make_train_batch(ds_cal, idxs, cfg.block_length)
        calib.append((b["input_ids"], b["attention_mask"],
                      b["block_attention_mask"]))
    return calib


def main(argv=None) -> dict:
    """Run the phases; returns the report (``quality.json``'s content), or
    the checkpoint steps alone with ``--train_only``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="results/corpus/pybytes")
    ap.add_argument("--out", default="results/quality")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max_length", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--n_checkpoints", type=int, default=6)
    ap.add_argument("--eval_samples", type=int, default=256)
    ap.add_argument("--eval_batch", type=int, default=16)
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--train_only", action="store_true",
                    help="run phases 1-2 (training) and exit")
    ap.add_argument("--int4_group", type=int, default=128,
                    help="INT4 group size (input rows per scale)")
    ap.add_argument("--gptq", action="store_true",
                    help="quantize the INT4-bearing configs with GPTQ "
                    "error-compensated rounding (ops/gptq.py; calibrated "
                    "on the training corpus, act-order) instead of RTN. "
                    "INT8 stays RTN.")
    ap.add_argument("--calib_samples", type=int, default=256,
                    help="GPTQ calibration samples (--gptq)")
    ap.add_argument("--block_only", action="store_true",
                    help="train/eval only the block model (no vanilla "
                    "baseline)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import (get_config,
                                                    get_vanilla_config)
    from block_transformer_tpu_torch.ops import quant

    device = device_of(args)
    os.makedirs(args.out, exist_ok=True)
    cfg = get_config("block_main_b4_5", vocab_size=VOCAB,
                     max_length=args.max_length)
    vcfg = get_vanilla_config("vanilla_31", vocab_size=VOCAB,
                              max_position_embeddings=args.max_length)

    t0 = time.time()
    log_device("quality", device)
    block_dir = os.path.join(args.out, "block_main_b4_5")
    van_dir = os.path.join(args.out, "vanilla_31")
    if not args.skip_train:
        print("[quality] phase 1: train block_main_b4_5")
        train_block(args, cfg)
        print(f"[quality] block trained ({time.time()-t0:.0f}s)")
        if not args.block_only:
            print("[quality] phase 2: train vanilla_31")
            train_vanilla(args, vcfg)
            print(f"[quality] vanilla trained ({time.time()-t0:.0f}s)")

    block_params, bstep = load_params(block_dir, device)
    van_params, vstep = (None, None) if args.block_only else load_params(
        van_dir, device)
    if args.train_only:
        print("[quality] --train_only: done")
        return {"block_checkpoint_step": bstep,
                "vanilla_checkpoint_step": vstep}
    print(f"[quality] loaded block@{bstep}, vanilla@{vstep}")

    holdout = load_corpus(args.corpus + "_holdout")
    ds_hold_block = make_dataset(holdout, args.max_length, cfg.block_length,
                                 seed=7)
    ds_hold_van = make_dataset(holdout, args.max_length, 1, seed=7)

    q8 = quant.quantize_block_transformer(block_params, bits=8)
    if args.gptq:
        # GPTQ for the INT4-bearing configs: sequential calibration on the
        # training corpus, act-order static groups (ops/gptq.py); packed
        # format identical to RTN, so everything downstream is unchanged
        from block_transformer_tpu_torch.ops import gptq
        calib = calibration_batches(args.corpus, cfg, args.max_length,
                                    args.calib_samples, args.eval_batch)

        def q4_fn(**kw):
            return gptq.gptq_quantize_block_transformer(
                block_params, cfg, calib, act_order=True, device=device,
                **kw)
    else:
        def q4_fn(**kw):
            return quant.quantize_block_transformer(block_params, **kw)
    q4 = q4_fn(bits=4, group_size=args.int4_group)
    # the bench's mixed48 serving config: block INT8 + token INT4 + head INT8
    qmix = q4_fn(bits=8, token_decoder_bits=4, lm_head_bits=8,
                 group_size=args.int4_group)
    # the gate-passing INT4 recipe: g32 groups + INT8 LM head
    q4_gate = q4_fn(bits=4, lm_head_bits=8, group_size=32)

    results = {"steps": args.steps, "batch": args.batch,
               "max_length": args.max_length,
               "block_checkpoint_step": bstep, "vanilla_checkpoint_step": vstep}

    print("[quality] phase 3: held-out teacher-forced ppl")
    n = args.eval_samples

    def ppl(tree):
        return heldout_ppl_block(tree, cfg, ds_hold_block, n, args.eval_batch)

    results["ppl"] = {
        "block_fp32": ppl(block_params),
        "block_int8": ppl(q8),
        "block_int4": ppl(q4),
        "block_mixed48": ppl(qmix),
        "block_int4_gate": ppl(q4_gate),
    }
    if van_params is not None:
        results["ppl"]["vanilla_fp32"] = heldout_ppl_vanilla(
            van_params, vcfg, ds_hold_van, n, args.eval_batch)
    p = results["ppl"]
    fp = p["block_fp32"]
    for name, key in (("int8", "block_int8"), ("int4", "block_int4"),
                      ("mixed48", "block_mixed48"),
                      ("int4_gate", "block_int4_gate")):
        p[f"{name}_delta_pct"] = 100 * (p[key] - fp) / fp
    print(json.dumps(p, indent=2))

    print("[quality] phase 4: harness tasks")
    results["harness"] = {
        name: run_harness(tree, cfg, holdout, args.max_length,
                          args.eval_batch)
        for name, tree in (("fp32", block_params), ("int8", q8),
                           ("int4", q4))}

    print("[quality] phase 5: decode agreement")
    results["decode_agreement"] = decode_agreement(block_params, q8, cfg,
                                                   holdout, params_mixed=qmix)

    with open(os.path.join(args.out, "quality.json"), "w") as f:
        json.dump(results, f, indent=2)

    write_report(args, results)
    print(f"[quality] done in {time.time()-t0:.0f}s -> {args.out}/QUALITY.md")
    return results


def write_report(args, r):
    p = r["ppl"]
    h = r["harness"]
    d = r["decode_agreement"]
    nan = float("nan")

    def task_row(task, metric):
        f = h["fp32"].get(task, {}).get(metric, nan)
        q8v = h["int8"].get(task, {}).get(metric, nan)
        q4v = h["int4"].get(task, {}).get(metric, nan)
        return (f"| {task} {metric} | {f:.4f} | {q8v:.4f} | {q4v:.4f} | "
                f"{100*(q8v-f)/f if f else 0:+.2f}% | "
                f"{100*(q4v-f)/f if f else 0:+.2f}% |")

    def gate(key):
        return "PASS" if abs(p.get(key, 9)) <= 0.5 else "FAIL"

    lines = [
        "# QUALITY — end-to-end quantization quality gate (PyTorch port)",
        "",
        f"Models trained with the port's pipeline (trainer -> checkpoint "
        f"-> eval adapter -> harness) on a {args.steps}-step run "
        f"(batch {args.batch} x {args.max_length} tokens, byte-level local "
        f"real-text corpus; block_transformer_tpu_torch/scripts/"
        f"quality_run.py). Gate: quantized ppl delta <= 0.5%.",
        "",
        "## Held-out teacher-forced perplexity (token-level)",
        "",
        "| Model | ppl | delta vs fp32 |",
        "|---|---|---|",
        f"| block_main_b4_5 fp32 | {p['block_fp32']:.4f} | — |",
        f"| block_main_b4_5 INT8 weights | {p['block_int8']:.4f} | "
        f"{p['int8_delta_pct']:+.3f}% |",
        f"| block_main_b4_5 INT4 weights (g{args.int4_group}) | "
        f"{p['block_int4']:.4f} | {p['int4_delta_pct']:+.3f}% |",
        f"| block_main_b4_5 INT4 gate recipe (g32 + INT8 head) | "
        f"{p['block_int4_gate']:.4f} | {p['int4_gate_delta_pct']:+.3f}% |",
        f"| block_main_b4_5 mixed48 (block int8 + token int4 + head int8) | "
        f"{p['block_mixed48']:.4f} | {p['mixed48_delta_pct']:+.3f}% |",
        f"| vanilla_31 fp32 | {p.get('vanilla_fp32', nan):.4f} | "
        f"(baseline pairing) |",
        "",
        f"INT8 gate (<=0.5%): {gate('int8_delta_pct')}; "
        f"INT4 g{args.int4_group}: {gate('int4_delta_pct')} "
        f"({p['int4_delta_pct']:+.3f}%); INT4 gate recipe: "
        f"{gate('int4_gate_delta_pct')} ({p['int4_gate_delta_pct']:+.3f}%).",
        "",
        "## Harness tasks (byte-level analogues, full adapter path)",
        "",
        "| Task / metric | fp32 | int8 | int4 | d8 | d4 |",
        "|---|---|---|---|---|---|",
        task_row("pybytes_nextchunk", "acc"),
        task_row("pybytes_nextchunk", "acc_norm"),
        task_row("pybytes_wikitext", "byte_perplexity"),
        task_row("pybytes_wikitext", "bits_per_byte"),
        "",
        "## Greedy-decode agreement (KV-cache quantization)",
        "",
        f"- INT8 KV vs bf16 KV (fp32 weights): "
        f"{100*d['int8_kv_vs_bf16_kv_match']:.2f}% token match",
        f"- INT8 weights + INT8 KV vs full precision: "
        f"{100*d['int8_w_int8_kv_vs_fp_match']:.2f}% token match",
        f"- INT4 KV vs bf16 KV (fp32 weights): "
        f"{100*d['int4_kv_vs_bf16_kv_match']:.2f}% token match",
        f"- INT8 weights + INT4 KV vs full precision: "
        f"{100*d['int8_w_int4_kv_vs_fp_match']:.2f}% token match",
        f"- mixed48 weights + INT4 KV vs full precision: "
        f"{100*d.get('mixed48_int4_kv_vs_fp_match', nan):.2f}% token match",
        "",
        "Training loss curves: `<out>/*/metrics.jsonl` "
        "(per-component losses + fp64 loss-by-position).",
    ]
    with open(os.path.join(args.out, "QUALITY.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
