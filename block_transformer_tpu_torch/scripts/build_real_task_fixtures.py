"""Build real-text task fixtures for the eval harness (port of
``scripts/build_real_task_fixtures.py``; offline, host code only).

With no network and no datasets cache, the real lambada / hellaswag /
wikitext test sets cannot be had. The one real English prose corpus the
reference bundles is its Paul Graham essay collection (its needle
haystack, the source of ``assets/needle_haystack.txt``). This script
derives task fixtures from those essays in the REAL tasks' document
schemas, so the real task classes (``eval/tasks.py`` LambadaOpenAI /
Wikitext / TriviaQA / GSM8K) run end to end on real text:

- ``lambada_pg.jsonl``: {"text": passage} cloze docs in the
  lambada_openai schema: passages whose final word also occurs earlier in
  the passage (LAMBADA's guessability design). ``seen`` marks whether the
  source essay is in the training split of the pgbytes corpus
  (``build_pg_corpus``).
- ``wikitext_pg.jsonl``: {"page": encoded} docs in the
  wikitext_document_level schema: paragraphs re-encoded with
  wikitext-2-raw tokenization artifacts (" @-@ ", spaced punctuation) so
  the real ``wikitext_detokenizer`` does its work.
- ``trivia_real.jsonl``: general-knowledge QA pairs in the triviaqa
  rc.nocontext schema ({"question", "answer": {"aliases", "value"}}).
- ``gsm8k_style.jsonl``: arithmetic word problems in the gsm8k schema
  (answer text ending "#### N").

Every draw is ``np.random.default_rng(seed)`` as in the JAX script, so the
same essays give byte-identical fixtures. The essays are not in the
repository: ``--essays`` names a directory of ``*.txt`` files.

    python -m block_transformer_tpu_torch.scripts.build_real_task_fixtures \
        --essays results/corpus/PaulGrahamEssays --out assets/real_tasks
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re

import numpy as np


def wikitext_encoder(text: str) -> str:
    """Inverse-direction analogue of eval.tasks.wikitext_detokenizer:
    re-introduce wikitext-2-raw tokenization artifacts into clean prose
    (the detokenizer then strips them — round-trip tested)."""
    text = text.replace("'s", " 's")
    text = re.sub(r"(\w)-(\w)", r"\1 @-@ \2", text)
    text = re.sub(r"(\d),(\d)", r"\1 @,@ \2", text)
    for p in (":", ";", "!", "?", ","):
        text = text.replace(p, f" {p} ")
    # sentence-final periods (keep decimals intact — those became @.@)
    text = re.sub(r"\.(\s|$)", r" . \1", text)
    text = re.sub(r" +", " ", text)
    return text.strip()


def load_essays(root):
    out = []
    for p in sorted(pathlib.Path(root).glob("*.txt")):
        t = p.read_text(errors="replace")
        t = re.sub(r"\s+", " ", t).strip()
        if len(t) > 2000:
            out.append((p.stem, t))
    return out


WORD_RE = re.compile(r"^[a-zA-Z]{4,}$")


def build_lambada(essays, holdout_names, n_docs, min_ctx=300, max_ctx=600,
                  seed=0):
    rng = np.random.default_rng(seed)
    docs = []
    tries = 0
    while len(docs) < n_docs and tries < n_docs * 200:
        tries += 1
        name, t = essays[int(rng.integers(len(essays)))]
        start = int(rng.integers(0, max(1, len(t) - max_ctx)))
        chunk = t[start:start + int(rng.integers(min_ctx, max_ctx))]
        # align to word boundaries
        chunk = chunk[chunk.find(" ") + 1:chunk.rfind(" ")]
        words = chunk.split(" ")
        if len(words) < 30:
            continue
        target = words[-1].strip()
        # LAMBADA design: the target word must be guessable — require it
        # to occur earlier in the passage, be alphabetic and non-trivial
        if not WORD_RE.match(target):
            continue
        if target.lower() not in (w.lower().strip(".,;:!?\"'()")
                                  for w in words[:-1]):
            continue
        docs.append({"text": " ".join(words),
                     "source": name, "seen": name not in holdout_names})
    return docs


def build_wikitext(essays, holdout_names, n_docs, page_chars=3000, seed=1):
    rng = np.random.default_rng(seed)
    docs = []
    order = rng.permutation(len(essays))
    for i in order[:n_docs]:
        name, t = essays[int(i)]
        start = int(rng.integers(0, max(1, len(t) - page_chars)))
        page = t[start:start + page_chars]
        page = page[page.find(" ") + 1:page.rfind(" ")]
        docs.append({"page": wikitext_encoder(page),
                     "source": name, "seen": name not in holdout_names})
    return docs


TRIVIA = [
    ("What is the capital of France", ["Paris"]),
    ("What is the capital of Japan", ["Tokyo"]),
    ("How many days are in a leap year", ["366", "three hundred and sixty-six"]),
    ("What is the chemical symbol for gold", ["Au"]),
    ("How many legs does a spider have", ["8", "eight"]),
    ("What planet is known as the Red Planet", ["Mars"]),
    ("Who wrote Romeo and Juliet", ["William Shakespeare", "Shakespeare"]),
    ("What is the largest ocean on Earth", ["Pacific", "the Pacific Ocean",
                                            "Pacific Ocean"]),
    ("What is the freezing point of water in degrees Celsius",
     ["0", "zero", "0 degrees"]),
    ("How many continents are there", ["7", "seven"]),
    ("What gas do plants absorb from the atmosphere",
     ["carbon dioxide", "CO2"]),
    ("What is the smallest prime number", ["2", "two"]),
    ("How many sides does a hexagon have", ["6", "six"]),
    ("What is the capital of Italy", ["Rome"]),
    ("Who painted the Mona Lisa", ["Leonardo da Vinci", "da Vinci",
                                   "Leonardo"]),
    ("What is the square root of 64", ["8", "eight"]),
    ("How many minutes are in an hour", ["60", "sixty"]),
    ("What is the first element on the periodic table", ["hydrogen"]),
    ("What is the capital of Spain", ["Madrid"]),
    ("How many colors are in a rainbow", ["7", "seven"]),
    ("What animal is known as the king of the jungle", ["lion", "the lion"]),
    ("How many hours are in a day", ["24", "twenty-four", "twenty four"]),
    ("What is the capital of England", ["London"]),
    ("What is the opposite of hot", ["cold"]),
    ("How many letters are in the English alphabet",
     ["26", "twenty-six", "twenty six"]),
    ("What is the largest planet in the solar system", ["Jupiter"]),
    ("What do bees make", ["honey"]),
    ("What is the capital of Germany", ["Berlin"]),
    ("How many wheels does a bicycle have", ["2", "two"]),
    ("What season comes after winter", ["spring"]),
]


def build_trivia():
    return [{"question": q, "answer": {"aliases": a, "value": a[0]}}
            for q, a in TRIVIA]


def build_gsm8k(n_docs=30, seed=2):
    rng = np.random.default_rng(seed)
    names = ["Alice", "Ben", "Carla", "Dev", "Elena", "Farid"]
    items = ["apples", "books", "pencils", "marbles", "stickers", "coins"]
    docs = []
    for _ in range(n_docs):
        a, b, c = (int(rng.integers(3, 60)) for _ in range(3))
        who = names[int(rng.integers(len(names)))]
        it = items[int(rng.integers(len(items)))]
        kind = int(rng.integers(3))
        if kind == 0:
            q = (f"{who} has {a} {it}. A friend gives {who} {b} more "
                 f"{it}. How many {it} does {who} have now?")
            ans, steps = a + b, f"{a} + {b} = {a + b}"
        elif kind == 1:
            hi = max(a, b) + c
            q = (f"{who} starts with {hi} {it} and gives away "
                 f"{min(a, b)}. How many {it} are left?")
            ans, steps = hi - min(a, b), f"{hi} - {min(a, b)} = {hi - min(a, b)}"
        else:
            q = (f"{who} buys {a} bags with {b} {it} in each bag. "
                 f"How many {it} in total?")
            ans, steps = a * b, f"{a} * {b} = {a * b}"
        docs.append({"question": q, "answer": f"{steps}\n#### {ans}"})
    return docs


def main(argv=None) -> dict:
    """Write the four fixtures and ``META.json``; returns {file: docs,
    "essays", "holdout_essays"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--essays", default="results/corpus/PaulGrahamEssays",
                    help="directory of the essays' *.txt files")
    ap.add_argument("--out", default="assets/real_tasks")
    ap.add_argument("--n_lambada", type=int, default=300)
    ap.add_argument("--n_wikitext", type=int, default=24)
    ap.add_argument("--holdout_every", type=int, default=10,
                    help="every k-th essay (sorted) is eval-only: excluded "
                    "from the pgbytes training corpus by the same rule")
    args = ap.parse_args(argv)

    essays = load_essays(args.essays)
    holdout = {essays[i][0] for i in range(0, len(essays),
                                           args.holdout_every)}
    os.makedirs(args.out, exist_ok=True)

    fixtures = {
        "lambada_pg.jsonl": build_lambada(essays, holdout, args.n_lambada),
        "wikitext_pg.jsonl": build_wikitext(essays, holdout,
                                            args.n_wikitext),
        "trivia_real.jsonl": build_trivia(),
        "gsm8k_style.jsonl": build_gsm8k(),
    }
    report = {}
    for fname, docs in fixtures.items():
        path = os.path.join(args.out, fname)
        with open(path, "w") as f:
            for d in docs:
                f.write(json.dumps(d) + "\n")
        print(f"{path}: {len(docs)} docs")
        report[fname] = len(docs)
    meta = {"essays": len(essays), "holdout_essays": sorted(holdout)}
    with open(os.path.join(args.out, "META.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return {**report, **meta}


if __name__ == "__main__":
    main()
