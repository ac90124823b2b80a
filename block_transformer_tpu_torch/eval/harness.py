"""Zero-shot evaluation harness (lm_eval-v0.4-compatible core).

A lean re-implementation of the vendored EleutherAI harness subset the
reference ships (lm_eval/evaluator.py, api/task.py, api/metrics.py): tasks
produce request tuples, the LM scores them in one length-sorted batched
pass, metrics aggregate with bootstrap stderr. Request types:

- ``loglikelihood(context, continuation)`` -> (logprob, is_greedy)
- ``loglikelihood_rolling(text)`` -> summed windowed logprob (perplexity
  tasks, lm_eval/api/task.py:1225 semantics)

Results dict shape matches ``evaluator.simple_evaluate`` consumers
(eval_zero_shot_task.py:220-307): {"results": {task: {metric: value}}}.

A copy of ``block_transformer_tpu/eval/harness.py``: the port keeps its own,
as it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# LM interface
# ---------------------------------------------------------------------------

class LM:
    """Abstract scoring interface (lm_eval/api/model.py:18-150 analogue)."""

    max_length: int = 2048

    def tok_encode(self, s: str) -> List[int]:
        raise NotImplementedError

    def loglikelihood(self, requests: Sequence[Tuple[str, str]]
                      ) -> List[Tuple[float, bool]]:
        """[(context, continuation)] -> [(sum logprob, greedy-match)]."""
        ctx_enc = []
        for context, continuation in requests:
            if context == "":
                c = [self.eot_token_id]
            else:
                c = self.tok_encode(context)
            whole = self.tok_encode(context + continuation)
            # continuation tokens = whole minus the longest matching prefix
            n = 0
            while n < len(c) and n < len(whole) and c[n] == whole[n]:
                n += 1
            ctx_enc.append((whole[:n] if n else [self.eot_token_id], whole[n:]))
        return self._loglikelihood_tokens(ctx_enc)

    def loglikelihood_rolling(self, texts: Sequence[str]) -> List[float]:
        """Disjoint prediction windows with one token of context (upstream
        lm_eval ``get_rolling_token_windows(context_len=1)`` semantics: the
        first window predicts up to ``max_length`` tokens conditioned on the
        EOT prefix; later windows predict ``max_length - 1`` tokens
        conditioned on the single preceding token). Windows from EVERY doc
        are flattened into one length-sorted batched scoring pass."""
        reqs, owner = [], []
        for d, text in enumerate(texts):
            toks = self.tok_encode(text)
            i = 0
            while i < len(toks):
                if i == 0:
                    pred = toks[:self.max_length]
                    ctx = [self.eot_token_id]
                else:
                    pred = toks[i:i + self.max_length - 1]
                    ctx = [toks[i - 1]]
                reqs.append((ctx, pred))
                owner.append(d)
                i += len(pred)
        scores = self._loglikelihood_tokens(reqs)
        out = [0.0] * len(texts)
        for d, (s, _) in zip(owner, scores):
            out[d] += s
        return out

    def _loglikelihood_tokens(self, requests
                              ) -> List[Tuple[float, bool]]:
        """[(ctx_tokens, cont_tokens)] -> [(logprob, greedy)]."""
        raise NotImplementedError

    def generate_until(self, requests: Sequence[Tuple[str, dict]]) -> List[str]:
        """[(context, {"until": [...], "max_gen_toks": N})] -> generations
        (text after the context, truncated at the first stop sequence)."""
        raise NotImplementedError

    @property
    def eot_token_id(self) -> int:
        return 0


# ---------------------------------------------------------------------------
# Metrics (lm_eval/api/metrics.py analogues)
# ---------------------------------------------------------------------------

def mean(xs):
    return float(np.mean(xs))


def perplexity(logprobs):
    return float(math.exp(-np.mean(logprobs)))


def weighted_perplexity(pairs):
    """pairs: [(loglikelihood, n_units)]"""
    lls, ns = zip(*pairs)
    return float(math.exp(-sum(lls) / sum(ns)))


def bits_per_byte(pairs):
    lls, ns = zip(*pairs)
    return float(-sum(lls) / sum(ns) / math.log(2))


def bootstrap_stderr(metric_fn: Callable, values: list, iters: int = 1000,
                     seed: int = 1234) -> float:
    if len(values) <= 1:
        return 0.0
    rng = random.Random(seed)
    stats = []
    for _ in range(min(iters, 1000)):
        sample = [values[rng.randrange(len(values))] for _ in range(len(values))]
        stats.append(metric_fn(sample))
    return float(np.std(stats, ddof=1))


# ---------------------------------------------------------------------------
# Task base
# ---------------------------------------------------------------------------

class Task:
    """A task yields docs; each doc yields requests and a results processor.

    Subclasses (eval/tasks.py) implement multiple-choice or perplexity
    semantics equivalent to lm_eval's ConfigurableTask variants.
    """

    name: str = "task"
    metric_fns: Dict[str, Callable] = {}

    def docs(self) -> list:
        raise NotImplementedError

    def build_requests(self, doc) -> List[Tuple[str, str]]:
        raise NotImplementedError

    def process_results(self, doc, results) -> Dict[str, float]:
        raise NotImplementedError

    def aggregate(self, per_doc: List[Dict[str, float]]) -> Dict[str, float]:
        out = {}
        for metric, fn in self.metric_fns.items():
            vals = [d[metric] for d in per_doc if metric in d]
            if not vals:
                continue
            out[metric] = fn(vals)
            out[metric + "_stderr"] = bootstrap_stderr(fn, vals)
        return out


class GenerateUntilTask(Task):
    """Free-generation task (triviaqa/gsm8k-style): the request is
    (context, gen_kwargs); process_results receives the generated string."""

    metric_fns = {"exact_match": mean}
    until: list = ["\n"]
    max_gen_toks: int = 64

    def doc_to_text(self, doc) -> str:
        raise NotImplementedError

    def extract_answer(self, generation: str) -> str:
        return generation.strip()

    def gold_answers(self, doc) -> list:
        raise NotImplementedError

    def build_requests(self, doc):
        return [("__generate__", (self.doc_to_text(doc),
                                  {"until": self.until,
                                   "max_gen_toks": self.max_gen_toks}))]

    def process_results(self, doc, results):
        (gen,) = results
        pred = self.extract_answer(gen)
        golds = [str(g).strip().lower() for g in self.gold_answers(doc)]
        return {"exact_match": float(pred.strip().lower() in golds)}


class MultipleChoiceTask(Task):
    """acc / acc_norm over per-choice loglikelihoods
    (lm_eval/api/task.py:1178 semantics)."""

    metric_fns = {"acc": mean, "acc_norm": mean}

    def doc_to_text(self, doc) -> str:
        raise NotImplementedError

    def doc_to_choices(self, doc) -> List[str]:
        raise NotImplementedError

    def gold_index(self, doc) -> int:
        raise NotImplementedError

    def build_requests(self, doc):
        ctx = self.doc_to_text(doc)
        return [(ctx, choice) for choice in self.doc_to_choices(doc)]

    def process_results(self, doc, results):
        lls = np.array([r[0] for r in results])
        lengths = np.array([max(1, len(c)) for c in self.doc_to_choices(doc)])
        gold = self.gold_index(doc)
        return {"acc": float(np.argmax(lls) == gold),
                "acc_norm": float(np.argmax(lls / lengths) == gold)}


class PerplexityTask(Task):
    """Rolling word/byte perplexity (wikitext-style;
    lm_eval/api/task.py:1225)."""

    metric_fns = {}  # aggregated specially

    def doc_to_target(self, doc) -> str:
        raise NotImplementedError

    def build_requests(self, doc):
        return [("__rolling__", self.doc_to_target(doc))]

    def count_words(self, s: str) -> int:
        return len(s.split())

    def process_results(self, doc, results):
        (ll,) = results
        target = self.doc_to_target(doc)
        return {"_ll": ll, "_words": self.count_words(target),
                "_bytes": len(target.encode("utf-8"))}

    def aggregate(self, per_doc):
        pairs_w = [(d["_ll"], d["_words"]) for d in per_doc]
        pairs_b = [(d["_ll"], d["_bytes"]) for d in per_doc]
        return {
            "word_perplexity": weighted_perplexity(pairs_w),
            "byte_perplexity": weighted_perplexity(pairs_b),
            "bits_per_byte": bits_per_byte(pairs_b),
        }


# ---------------------------------------------------------------------------
# The evaluation loop
# ---------------------------------------------------------------------------

def evaluate(lm: LM, tasks: Sequence[Task], limit: int = None,
             verbose: bool = False, return_per_doc: bool = False) -> dict:
    """Run all tasks: batch every loglikelihood request through the LM once
    (length-sorted inside the adapter), then dispatch per-doc results.

    ``return_per_doc`` additionally returns each task's per-document
    metric dicts (callers slicing metrics by doc attributes, e.g. the
    real-task fixtures' seen/holdout split)."""
    results = {}
    per_doc_all = {}
    for task in tasks:
        docs = task.docs()
        if limit:
            docs = docs[:limit]
        doc_requests = [task.build_requests(doc) for doc in docs]

        flat_ll, flat_rolling, flat_gen = [], [], []
        index = []  # (doc_i, kind, slot)
        for i, reqs in enumerate(doc_requests):
            for r in reqs:
                if r[0] == "__rolling__":
                    index.append((i, "rolling", len(flat_rolling)))
                    flat_rolling.append(r[1])
                elif r[0] == "__generate__":
                    index.append((i, "gen", len(flat_gen)))
                    flat_gen.append(r[1])
                else:
                    index.append((i, "ll", len(flat_ll)))
                    flat_ll.append(r)

        ll_res = lm.loglikelihood(flat_ll) if flat_ll else []
        roll_res = lm.loglikelihood_rolling(flat_rolling) if flat_rolling else []
        gen_res = lm.generate_until(flat_gen) if flat_gen else []

        per_doc_results = [[] for _ in docs]
        for (i, kind, slot) in index:
            per_doc_results[i].append(
                ll_res[slot] if kind == "ll"
                else roll_res[slot] if kind == "rolling" else gen_res[slot])

        per_doc = [task.process_results(doc, res)
                   for doc, res in zip(docs, per_doc_results)]
        per_doc_all[task.name] = per_doc
        results[task.name] = task.aggregate(per_doc)
        if verbose:
            print(task.name, results[task.name])
    out = {"results": results}
    if return_per_doc:
        out["per_doc"] = per_doc_all
    return out


def make_table(results: dict) -> str:
    lines = [f"{'task':24s} {'metric':18s} {'value':>10s} {'stderr':>10s}"]
    for task, metrics in results["results"].items():
        for m, v in metrics.items():
            if m.endswith("_stderr"):
                continue
            se = metrics.get(m + "_stderr", float("nan"))
            lines.append(f"{task:24s} {m:18s} {v:10.4f} {se:10.4f}")
    return "\n".join(lines)
