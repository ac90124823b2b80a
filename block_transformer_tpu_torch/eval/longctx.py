"""Long-context evaluation: PG19-style positionwise perplexity and
needle-in-a-haystack sample generation/scoring.

Positionwise loss follows util/perplexity.py:29-88: documents are tokenized,
cut into disjoint ``context_length`` chunks (shorter docs skipped, the tail
remainder dropped), and per-position CE is summed over chunks then averaged
— for the block model the first *block* is the unpredicted prefix
(positions ``block_length..context_length-1`` are scored), for the vanilla
model the first token is.

Needle generation follows needle/needle.py:32-98 in spirit: a random
city/7-digit "magic number" statement is inserted at a given depth percent
(by tokens) into a haystack, with several prompt templates; retrieval is
scored by substring match of the number in the generated text.

A copy of ``block_transformer_tpu/eval/longctx.py`` (the port imports
nothing of the JAX package), but for where the positionwise cross-entropy
is taken: in torch on the logits' device, not in numpy on the host.
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Positionwise perplexity (PG19)
# ---------------------------------------------------------------------------

def loss_by_position_over_chunks(logits_fn: Callable, docs_tokens:
                                 Sequence[np.ndarray], context_length: int,
                                 batch_size: int = 8, block_length:
                                 Optional[int] = None):
    """logits_fn(chunk_batch [B, C] int32 numpy) -> logits (a tensor on any
    device, or a numpy array).

    For the block model (block_length given) logits must be
    [B, N-1, L, V] (teacher-forced forward); scored positions are tokens
    L..C-1. For vanilla, logits [B, C, V]; scored positions 1..C-1.
    Returns (avg_loss_by_position [C - offset], n_chunks). The
    cross-entropy is taken in float32 on the logits' device; only its sum
    over the batch comes to the host.
    """
    chunks = []
    for toks in docs_tokens:
        n = len(toks) // context_length
        for i in range(n):
            chunks.append(np.asarray(toks[i * context_length:(i + 1) * context_length]))
    if not chunks:
        raise ValueError("no document long enough for context_length")
    total = None
    count = 0
    for i in range(0, len(chunks), batch_size):
        batch = np.stack(chunks[i:i + batch_size]).astype(np.int32)
        logits = torch.as_tensor(logits_fn(batch)).float()
        if block_length is not None:
            B = batch.shape[0]
            V = logits.shape[-1]
            flat = logits.reshape(B, -1, V)           # [(N-1)*L]
            targets = batch[:, block_length:]         # tokens of blocks 1..N-1
        else:
            flat = logits[:, :-1]
            targets = batch[:, 1:]
        t = torch.from_numpy(targets.astype(np.int64)).to(flat.device)
        ce = (torch.logsumexp(flat, dim=-1)
              - flat.gather(-1, t[..., None])[..., 0])
        del logits, flat
        s = ce.sum(0).cpu().numpy()
        total = s if total is None else total + s
        count += batch.shape[0]
    return total / count, count


# ---------------------------------------------------------------------------
# Needle in a haystack
# ---------------------------------------------------------------------------

_CITIES = ["Chicago", "Yangon", "Antananarivo", "Colombo", "Almaty",
           "Sydney", "Mexico City", "Seattle", "Lagos", "Amsterdam",
           "Belgrade", "Cairo", "Baghdad", "Damascus", "Kigali", "Dakar",
           "Sofia", "Victoria", "Tashkent", "Mumbai", "Barcelona", "Turin",
           "Miami", "Singapore"]

_TEMPLATES = [
    ("{haystack}\n\nWhat is the special magic number for {city} mentioned "
     "in the provided text?\nThe special magic number for {city} mentioned "
     "in the provided text is"),
    ("{haystack}\n\nQuestion: What is the special magic number for {city}?"
     "\nAnswer: The special magic number for {city} is"),
    ("Below is some text. Remember the magic numbers.\n\n{haystack}\n\n"
     "The special magic number for {city} is"),
]


def make_needle_sample(haystack_text: str, tokenizer, context_length: int,
                       depth_percent: float, template_index: int = 0,
                       rng: Optional[random.Random] = None) -> dict:
    """Insert a needle at ``depth_percent`` (by tokens) into the haystack
    truncated to fit ``context_length`` with the prompt template."""
    rng = rng or random.Random(0)
    city = rng.choice(_CITIES)
    number = rng.randint(1_000_000, 9_999_999)
    needle = f" The special magic number for {city} is: {number}."

    template = _TEMPLATES[template_index % len(_TEMPLATES)]
    scaffold = template.format(haystack="", city=city)
    budget = context_length - len(tokenizer.encode(scaffold)) \
        - len(tokenizer.encode(needle)) - 8
    hay_tokens = tokenizer.encode(haystack_text)[:max(budget, 0)]
    insert_at = int(len(hay_tokens) * depth_percent / 100.0)
    needle_tokens = tokenizer.encode(needle)
    merged = hay_tokens[:insert_at] + needle_tokens + hay_tokens[insert_at:]
    haystack = tokenizer.decode(merged)
    return {
        "prompt": template.format(haystack=haystack, city=city),
        "needle": str(number),
        "city": city,
        "depth_percent": depth_percent,
        "template_index": template_index % len(_TEMPLATES),
    }


def generate_needle_suite(haystack_text: str, tokenizer, context_length: int,
                          depths: Sequence[float] = (0, 25, 50, 75, 100),
                          n_templates: int = 3, seed: int = 0) -> List[dict]:
    rng = random.Random(seed)
    return [make_needle_sample(haystack_text, tokenizer, context_length, d, t,
                               rng)
            for d in depths for t in range(n_templates)]


def score_needle_results(samples: List[dict], generations: List[str]) -> dict:
    """Per-depth retrieval accuracy (needle substring in generation)."""
    by_depth = {}
    for s, g in zip(samples, generations):
        ok = s["needle"] in g
        by_depth.setdefault(s["depth_percent"], []).append(float(ok))
    return {d: float(np.mean(v)) for d, v in sorted(by_depth.items())}
