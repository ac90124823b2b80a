"""Run the REAL task classes on real-text fixtures (port of
``scripts/real_task_eval.py``).

Runs ``eval/tasks.py``'s LambadaOpenAI / Wikitext / TriviaQA / GSM8K
classes (lm_eval v0.4.0 semantics) over the committed fixtures in
``assets/real_tasks/`` through the full adapter path (``BlockTransformerLM``
pad adapter -> harness) at fp32, INT8 and INT4 g32 (LM head INT8) weights;
the generate_until tasks run the real extraction regexes on the model's own
generations. It runs on the card unless ``--cpu`` is given.

The fixtures' per-doc ``seen`` flags mark the passages of the essays a
model trained on the pgbytes corpus has seen (``assets/real_tasks/
META.json``). The split means something only for such a model; the report
says so (``seen_split_note``). For a model trained on another corpus (the
stdlib corpus of ``build_byte_corpus``) both halves are unseen text, and the
quantization DELTAS are the gate either way.

    python -m block_transformer_tpu_torch.scripts.real_task_eval \\
        --model_dir results/quality/block_main_b4_5 --out results/real_tasks
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from block_transformer_tpu_torch.scripts.quality_run import (
    add_ignored_optimizer_flags)

VOCAB = 512
OFFSET = 3
FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets", "real_tasks")
SEEN_SPLIT_NOTE = ("seen/holdout follow the fixtures' pgbytes essay split "
                   "(assets/real_tasks/META.json): meaningful only for a "
                   "model trained on that corpus")


class ByteTokenizer:
    eos_token_id = 0

    def encode(self, s: str):
        return [min(ord(c), 255) + OFFSET for c in s]

    def decode(self, toks):
        return "".join(chr(int(t) - OFFSET) for t in toks
                       if t >= OFFSET and t < 256 + OFFSET)


def load_fixture(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def split_seen(per_doc, docs, key):
    """Mean of ``key`` over seen / holdout doc subsets."""
    seen = [r[key] for r, d in zip(per_doc, docs) if d.get("seen", True)]
    held = [r[key] for r, d in zip(per_doc, docs) if not d.get("seen", True)]
    out = {}
    if seen:
        out["seen"] = float(np.mean(seen))
    if held:
        out["holdout"] = float(np.mean(held))
    return out


def main(argv=None) -> dict:
    """Returns the report written to ``<out>/real_tasks.json``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_dir", default="results/quality/block_main_b4_5")
    ap.add_argument("--fixtures", default=FIXTURES)
    ap.add_argument("--out", default="results/real_tasks")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max_length", type=int, default=1024)
    add_ignored_optimizer_flags(ap, steps=3000)
    ap.add_argument("--int4_group", type=int, default=32)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from block_transformer_tpu_torch.config import get_config
    from block_transformer_tpu_torch.eval import adapters, harness, tasks
    from block_transformer_tpu_torch.ops import quant
    from block_transformer_tpu_torch.scripts import quality_run as qr

    device = qr.device_of(args)
    qr.log_device("real_tasks", device)
    cfg = get_config("block_main_b4_5", vocab_size=VOCAB,
                     max_length=args.max_length)
    params, step = qr.load_params(args.model_dir, device)
    print(f"[real_tasks] loaded {args.model_dir}@{step}")

    fx = {n: load_fixture(os.path.join(args.fixtures, f))
          for n, f in (("lambada", "lambada_pg.jsonl"),
                       ("wikitext", "wikitext_pg.jsonl"),
                       ("trivia", "trivia_real.jsonl"),
                       ("gsm8k", "gsm8k_style.jsonl"))}
    if args.limit:
        fx = {k: v[:args.limit] for k, v in fx.items()}

    suite = [tasks.LambadaOpenAI(docs=fx["lambada"]),
             tasks.Wikitext(docs=fx["wikitext"]),
             tasks.TriviaQA(docs=fx["trivia"]),
             tasks.GSM8K(docs=fx["gsm8k"])]

    variants = {
        "fp32": params,
        "int8": quant.quantize_block_transformer(params, bits=8),
        "int4_g32": quant.quantize_block_transformer(
            params, bits=4, group_size=args.int4_group, lm_head_bits=8),
    }

    os.makedirs(args.out, exist_ok=True)
    report = {}
    for vname, p in variants.items():
        lm = adapters.BlockTransformerLM(p, cfg, ByteTokenizer(),
                                         max_length=args.max_length,
                                         batch_size=args.batch)
        t0 = time.time()
        res = harness.evaluate(lm, suite, verbose=True, return_per_doc=True)
        r = res["results"]
        per_doc = res.get("per_doc", {})
        if "lambada_openai" in per_doc:
            r["lambada_openai"]["acc_split"] = split_seen(
                per_doc["lambada_openai"], fx["lambada"], "acc")
        report[vname] = r
        print(f"[real_tasks] {vname} done in {time.time()-t0:.0f}s: "
              f"{json.dumps(r, default=float)[:400]}")

    # deltas vs fp32 (the gate is on ppl/acc deltas)
    gates = {}
    f = report["fp32"]
    for vname in ("int8", "int4_g32"):
        q = report[vname]
        gates[vname] = {
            "lambada_acc_delta": q["lambada_openai"]["acc"]
            - f["lambada_openai"]["acc"],
            "lambada_ppl_delta_pct": 100.0 * (
                q["lambada_openai"]["perplexity"]
                / max(f["lambada_openai"]["perplexity"], 1e-9) - 1.0),
            "wikitext_word_ppl_delta_pct": 100.0 * (
                q["wikitext"]["word_perplexity"]
                / max(f["wikitext"]["word_perplexity"], 1e-9) - 1.0),
        }
    report["gates_vs_fp32"] = gates
    report["seen_split_note"] = SEEN_SPLIT_NOTE

    out_path = os.path.join(args.out, "real_tasks.json")
    with open(out_path, "w") as fjson:
        json.dump(report, fjson, indent=1, default=float)
    print(f"[real_tasks] wrote {out_path}")
    print(json.dumps(gates, indent=1, default=float))
    return report


if __name__ == "__main__":
    main()
