"""Request-level result caching (lm_eval ``CachingLM`` analogue,
lm_eval/api/model.py:174-248): memoize loglikelihood / rolling / generation
results in sqlite so checkpoint sweeps don't recompute shared requests.

A copy of ``block_transformer_tpu/eval/caching.py``: the port keeps its own,
as it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
from typing import Sequence, Tuple

from block_transformer_tpu_torch.eval.harness import LM


class CachingLM(LM):
    """Wraps an LM; every request type is cached by a content hash keyed
    with the wrapped model's ``cache_tag`` (e.g. checkpoint step)."""

    def __init__(self, lm: LM, cache_path: str, cache_tag: str = ""):
        self.lm = lm
        self.cache_tag = cache_tag
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        self._db = sqlite3.connect(cache_path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS cache (key TEXT PRIMARY KEY, val TEXT)")
        self._db.commit()
        self.max_length = lm.max_length

    def tok_encode(self, s):
        return self.lm.tok_encode(s)

    @property
    def eot_token_id(self):
        return self.lm.eot_token_id

    # ------------------------------------------------------------------
    def _key(self, kind: str, payload) -> str:
        raw = json.dumps([self.cache_tag, kind, payload], sort_keys=True)
        return hashlib.sha256(raw.encode()).hexdigest()

    def _get(self, key: str):
        row = self._db.execute("SELECT val FROM cache WHERE key=?",
                               (key,)).fetchone()
        return None if row is None else json.loads(row[0])

    def _put(self, key: str, val):
        self._db.execute("INSERT OR REPLACE INTO cache VALUES (?, ?)",
                         (key, json.dumps(val)))

    def _cached_batch(self, kind: str, requests, payloads, compute):
        keys = [self._key(kind, p) for p in payloads]
        hits = [self._get(k) for k in keys]
        misses = [i for i, h in enumerate(hits) if h is None]
        if misses:
            fresh = compute([requests[i] for i in misses])
            for i, r in zip(misses, fresh):
                hits[i] = r
                self._put(keys[i], r)
            self._db.commit()
        return hits

    # ------------------------------------------------------------------
    def loglikelihood(self, requests: Sequence[Tuple[str, str]]):
        out = self._cached_batch("ll", list(requests),
                                 [list(r) for r in requests],
                                 self.lm.loglikelihood)
        return [tuple(r) for r in out]

    def loglikelihood_rolling(self, texts: Sequence[str]):
        return self._cached_batch("rolling", list(texts), list(texts),
                                  self.lm.loglikelihood_rolling)

    def generate_until(self, requests):
        return self._cached_batch("gen", list(requests),
                                  [[c, kw] for c, kw in requests],
                                  self.lm.generate_until)
