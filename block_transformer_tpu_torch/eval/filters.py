"""Generation post-processing filters (lm_eval/filters analogues):
regex extraction, whitespace cleanup, take-first/take-first-k, and
majority vote — composable over per-doc response lists.

A copy of ``block_transformer_tpu/eval/filters.py``: the port keeps its own,
as it imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import List, Sequence


class Filter:
    def apply(self, responses: List[str]) -> List[str]:
        raise NotImplementedError


class RegexFilter(Filter):
    """Extract the first regex group match (upstream regex filter semantics);
    ``fallback`` when nothing matches."""

    def __init__(self, pattern: str = r"-?[$0-9.,]{2,}|-?[0-9]+",
                 group: int = 0, fallback: str = "[invalid]"):
        self.pattern = re.compile(pattern)
        self.group = group
        self.fallback = fallback

    def apply(self, responses):
        out = []
        for r in responses:
            m = self.pattern.search(r)
            out.append(m.group(self.group) if m else self.fallback)
        return out


class WhitespaceFilter(Filter):
    def apply(self, responses):
        return [r.strip() for r in responses]


class TakeFirst(Filter):
    """Reduce a multi-sample response list to its first element."""

    def apply(self, responses):
        return responses[:1]


class TakeKFilter(Filter):
    def __init__(self, k: int):
        self.k = k

    def apply(self, responses):
        return responses[:self.k]


class MajorityVote(Filter):
    """Reduce multi-sample responses to the most common answer
    (self-consistency)."""

    def apply(self, responses):
        if not responses:
            return responses
        [(winner, _)] = Counter(responses).most_common(1)
        return [winner]


def apply_filters(filters: Sequence[Filter], responses: List[str]) -> List[str]:
    for f in filters:
        responses = f.apply(responses)
    return responses
