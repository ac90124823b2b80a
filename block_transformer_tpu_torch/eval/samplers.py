"""Few-shot context sampling (lm_eval/api/samplers.py analogue): draw k
exemplar docs (excluding the evaluated doc), render them with the task's
formatting, and prepend to the query context.

A copy of ``block_transformer_tpu/eval/samplers.py``: the port keeps its
own, as it imports nothing of the JAX package.
"""

from __future__ import annotations

import random
from typing import Optional


class FewshotSampler:
    def __init__(self, docs, seed: int = 1234):
        self.docs = list(docs)
        self.rng = random.Random(seed)

    def sample(self, k: int, exclude_doc=None):
        pool = [d for d in self.docs if d is not exclude_doc]
        return self.rng.sample(pool, min(k, len(pool)))


def build_fewshot_context(task, doc, k: int,
                          sampler: Optional[FewshotSampler] = None,
                          delimiter: str = "\n\n") -> str:
    """Prefix ``doc``'s query with k rendered exemplars.

    Exemplars render as ``doc_to_text + gold continuation`` — for
    multiple-choice tasks the gold choice, for generation tasks the first
    gold answer.
    """
    if k <= 0:
        return task.doc_to_text(doc)
    sampler = sampler or FewshotSampler(task.docs())
    shots = sampler.sample(k, exclude_doc=doc)
    parts = []
    for s in shots:
        text = task.doc_to_text(s)
        if hasattr(task, "doc_to_choices"):
            gold = task.doc_to_choices(s)[task.gold_index(s)]
        elif hasattr(task, "gold_answers"):
            gold = " " + str(task.gold_answers(s)[0])
        else:
            gold = ""
        parts.append(text + gold)
    return delimiter.join(parts) + delimiter + task.doc_to_text(doc)
