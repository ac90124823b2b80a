"""Task definitions for the reference's quality-tracking suite.

The reference gitignores its task YAMLs (SURVEY.md §2.4) — these restore
the lm-eval-harness v0.4.0 semantics for the tasks the reference tracks
(conf/trainer/*.yaml zero_shot_eval + conf/eval/eval_multiple_ckpt.yaml):
lambada_openai, wikitext, hellaswag, piqa, arc_easy, arc_challenge, sciq,
winogrande. Prompt formats and preprocessing follow upstream v0.4.0 (the
hellaswag/wikitext preprocessing mirrors the reference's surviving
lm_eval/tasks/{hellaswag/utils.py, wikitext/preprocess_wikitext.py}).

Data loading: ``datasets.load_dataset`` from the local HF cache (nothing
is downloaded), imported only when a task loads; every task also accepts
``docs=`` directly so callers can feed JSONL/parquet exports.

A copy of ``block_transformer_tpu/eval/tasks.py``: the port keeps its own,
as it imports nothing of the JAX package.
"""

from __future__ import annotations

import re

import numpy as np
from typing import List, Optional

from block_transformer_tpu_torch.eval import harness


def _load(path, name, split, docs):
    if docs is not None:
        return list(docs)
    import datasets  # the local cache only; raises without it
    return list(datasets.load_dataset(path, name, split=split))


# ---------------------------------------------------------------------------
# Multiple choice tasks
# ---------------------------------------------------------------------------

class HellaSwag(harness.MultipleChoiceTask):
    name = "hellaswag"

    def __init__(self, docs=None):
        self._docs = _load("hellaswag", None, "validation", docs)

    @staticmethod
    def _preprocess(text: str) -> str:
        text = text.strip()
        text = text.replace(" [title]", ". ")
        text = re.sub(r"\[.*?\]", "", text)
        return text.replace("  ", " ")

    def docs(self):
        return self._docs

    def doc_to_text(self, doc):
        ctx = doc["ctx_a"] + " " + doc["ctx_b"].capitalize()
        return self._preprocess(doc["activity_label"] + ": " + ctx)

    def doc_to_choices(self, doc):
        return [" " + self._preprocess(e) for e in doc["endings"]]

    def gold_index(self, doc):
        return int(doc["label"])


class PIQA(harness.MultipleChoiceTask):
    name = "piqa"

    def __init__(self, docs=None):
        self._docs = _load("piqa", None, "validation", docs)

    def docs(self):
        return self._docs

    def doc_to_text(self, doc):
        return "Question: " + doc["goal"] + "\nAnswer:"

    def doc_to_choices(self, doc):
        return [" " + doc["sol1"], " " + doc["sol2"]]

    def gold_index(self, doc):
        return int(doc["label"])


class ARC(harness.MultipleChoiceTask):
    def __init__(self, subset="ARC-Easy", docs=None):
        self.name = "arc_easy" if subset == "ARC-Easy" else "arc_challenge"
        self._docs = _load("allenai/ai2_arc", subset, "test", docs)

    def docs(self):
        return self._docs

    def doc_to_text(self, doc):
        return "Question: " + doc["question"] + "\nAnswer:"

    def doc_to_choices(self, doc):
        return [" " + t for t in doc["choices"]["text"]]

    def gold_index(self, doc):
        return doc["choices"]["label"].index(doc["answerKey"])


class SciQ(harness.MultipleChoiceTask):
    name = "sciq"

    def __init__(self, docs=None):
        self._docs = _load("sciq", None, "test", docs)

    def docs(self):
        return self._docs

    def doc_to_text(self, doc):
        support = doc.get("support", "").lstrip()
        return f"{support}\nQuestion: {doc['question']}\nAnswer:".strip()

    def doc_to_choices(self, doc):
        return [" " + doc["distractor1"], " " + doc["distractor2"],
                " " + doc["distractor3"], " " + doc["correct_answer"]]

    def gold_index(self, doc):
        return 3


class Winogrande(harness.Task):
    """Partial-evaluation scoring: fill the blank with each option, score
    the common continuation after the blank (upstream v0.4.0 semantics)."""

    name = "winogrande"
    metric_fns = {"acc": harness.mean}

    def __init__(self, docs=None):
        self._docs = _load("winogrande", "winogrande_xl", "validation", docs)

    def docs(self):
        return self._docs

    def build_requests(self, doc):
        idx = doc["sentence"].index("_")
        target = doc["sentence"][idx + 1:].strip()
        reqs = []
        for opt in (doc["option1"], doc["option2"]):
            ctx = doc["sentence"][:idx] + opt
            reqs.append((ctx, " " + target))
        return reqs

    def process_results(self, doc, results):
        gold = int(doc["answer"]) - 1
        lls = [r[0] for r in results]
        return {"acc": float(lls.index(max(lls)) == gold)}


# ---------------------------------------------------------------------------
# Lambada (ppl + acc on final word)
# ---------------------------------------------------------------------------

class LambadaOpenAI(harness.Task):
    name = "lambada_openai"
    metric_fns = {"acc": harness.mean, "perplexity": harness.perplexity}

    def __init__(self, docs=None):
        self._docs = _load("EleutherAI/lambada_openai", "default", "test", docs)

    def docs(self):
        return self._docs

    def build_requests(self, doc):
        text = doc["text"]
        ctx, word = text.rsplit(" ", 1)
        return [(ctx, " " + word)]

    def process_results(self, doc, results):
        (ll, greedy), = results
        return {"acc": float(greedy), "perplexity": ll}

    def aggregate(self, per_doc):
        accs = [d["acc"] for d in per_doc]
        lls = [d["perplexity"] for d in per_doc]
        return {
            "acc": harness.mean(accs),
            "acc_stderr": harness.bootstrap_stderr(harness.mean, accs),
            "perplexity": harness.perplexity(lls),
            "perplexity_stderr": harness.bootstrap_stderr(harness.perplexity, lls),
        }


# ---------------------------------------------------------------------------
# Wikitext rolling perplexity
# ---------------------------------------------------------------------------

def wikitext_detokenizer(string: str) -> str:
    # mirrors lm_eval/tasks/wikitext/preprocess_wikitext.py semantics
    string = string.replace("s '", "s'")
    string = re.sub(r"/' [0-9]/", r"/'[0-9]/", string)
    string = string.replace(" @-@ ", "-")
    string = string.replace(" @,@ ", ",")
    string = string.replace(" @.@ ", ".")
    for p in (":", ";", ".", "!", "?", ","):
        string = string.replace(f" {p} ", f"{p} ")
    string = re.sub(r"\(\s*([^\)]*?)\s*\)", r"(\1)", string)
    string = re.sub(r"\[\s*([^\]]*?)\s*\]", r"[\1]", string)
    string = re.sub(r"{\s*([^}]*?)\s*}", r"{\1}", string)
    string = re.sub(r"\"\s*([^\"]*?)\s*\"", r'"\1"', string)
    string = re.sub(r"'\s*([^']*?)\s*'", r"'\1'", string)
    string = string.replace("= = = =", "====")
    string = string.replace("= = =", "===")
    string = string.replace("= =", "==")
    string = string.replace(" " + chr(176) + " ", chr(176))
    string = string.replace(" \n", "\n").replace("\n ", "\n")
    string = string.replace(" N ", " 1 ")
    string = string.replace(" 's", "'s")
    return string


class Wikitext(harness.PerplexityTask):
    """Word/byte ppl over wikitext-2 test, counting words/bytes of the RAW
    page (pre-detokenization), like upstream."""

    name = "wikitext"

    def __init__(self, docs=None):
        self._docs = _load("EleutherAI/wikitext_document_level",
                           "wikitext-2-raw-v1", "test", docs)

    def docs(self):
        return self._docs

    def doc_to_target(self, doc):
        return wikitext_detokenizer(doc["page"])

    def process_results(self, doc, results):
        (ll,) = results
        raw = doc["page"]
        return {"_ll": ll, "_words": len(re.split(r"\s+", raw)),
                "_bytes": len(raw.encode("utf-8"))}


# ---------------------------------------------------------------------------
# Free-generation tasks (lm_eval generate_until request type)
# ---------------------------------------------------------------------------

class TriviaQA(harness.GenerateUntilTask):
    """Exact match over answer aliases (upstream triviaqa semantics)."""

    name = "triviaqa"
    until = ["\n", ".", ","]
    max_gen_toks = 32

    def __init__(self, docs=None):
        self._docs = _load("mandarjoshi/trivia_qa", "rc.nocontext",
                           "validation", docs)

    def docs(self):
        return self._docs

    def doc_to_text(self, doc):
        return f"Question: {doc['question']}?\nAnswer:"

    def gold_answers(self, doc):
        ans = doc["answer"]
        return list(ans.get("aliases", [])) + [ans.get("value", "")]


class GSM8K(harness.GenerateUntilTask):
    """Final-number extraction after '####' or the last number in the
    generation (upstream gsm8k flexible-extract filter semantics)."""

    name = "gsm8k"
    until = ["\n\n", "Question:"]
    max_gen_toks = 256
    metric_fns = {"exact_match": harness.mean}

    def __init__(self, docs=None):
        self._docs = _load("openai/gsm8k", "main", "test", docs)

    def docs(self):
        return self._docs

    def doc_to_text(self, doc):
        return f"Question: {doc['question']}\nAnswer:"

    @staticmethod
    def _extract_number(text: str) -> str:
        if "####" in text:
            text = text.split("####")[-1]
        nums = re.findall(r"-?[\d,]*\.?\d+", text.replace("$", ""))
        return nums[-1].replace(",", "") if nums else ""

    def extract_answer(self, generation: str) -> str:
        return self._extract_number(generation)

    def gold_answers(self, doc):
        return [self._extract_number(doc["answer"])]


class Arithmetic(harness.MultipleChoiceTask):
    """EleutherAI arithmetic subtasks scored as single-continuation
    loglikelihood greedy-match (acc)."""

    metric_fns = {"acc": harness.mean}

    def __init__(self, subset="arithmetic_2da", docs=None):
        self.name = subset
        self._docs = _load("EleutherAI/arithmetic", subset, "validation", docs)

    def docs(self):
        return self._docs

    def build_requests(self, doc):
        return [(doc["context"], doc["completion"])]

    def process_results(self, doc, results):
        (ll, greedy), = results
        return {"acc": float(greedy)}

    def aggregate(self, per_doc):
        vals = [d["acc"] for d in per_doc]
        return {"acc": harness.mean(vals),
                "acc_stderr": harness.bootstrap_stderr(harness.mean, vals)}


class TruthfulQA_MC1(harness.MultipleChoiceTask):
    name = "truthfulqa_mc1"

    QA_PROMPT = ("Q: What is human life expectancy in the United States?\n"
                 "A: Human life expectancy in the United States is 78 years.\n\n"
                 "Q: Who was president of the United States in 1955?\n"
                 "A: Dwight D. Eisenhower was president of the United States "
                 "in 1955.\n\n"
                 "Q: Which party did he belong to?\n"
                 "A: He belonged to the Republican Party.\n\n"
                 "Q: What is the square root of banana?\n"
                 "A: I have no comment.\n\n"
                 "Q: How does a telescope work?\n"
                 "A: Telescopes use lenses or mirrors to focus light and make "
                 "objects appear closer.\n\n"
                 "Q: Where were the 1992 Olympics held?\n"
                 "A: The 1992 Olympics were held in Barcelona, Spain.")

    def __init__(self, docs=None):
        self._docs = _load("truthfulqa/truthful_qa", "multiple_choice",
                           "validation", docs)

    def docs(self):
        return self._docs

    def doc_to_text(self, doc):
        return self.QA_PROMPT + "\n\nQ: " + doc["question"] + "\nA:"

    def doc_to_choices(self, doc):
        return [" " + c for c in doc["mc1_targets"]["choices"]]

    def gold_index(self, doc):
        return int(np.argmax(doc["mc1_targets"]["labels"]))


TASK_REGISTRY = {
    "hellaswag": HellaSwag,
    "piqa": PIQA,
    "arc_easy": lambda docs=None: ARC("ARC-Easy", docs),
    "arc_challenge": lambda docs=None: ARC("ARC-Challenge", docs),
    "sciq": SciQ,
    "winogrande": Winogrande,
    "lambada_openai": LambadaOpenAI,
    "wikitext": Wikitext,
    "triviaqa": TriviaQA,
    "gsm8k": GSM8K,
    "truthfulqa_mc1": TruthfulQA_MC1,
    "arithmetic_2da": lambda docs=None: Arithmetic("arithmetic_2da", docs),
    "arithmetic_2ds": lambda docs=None: Arithmetic("arithmetic_2ds", docs),
    "arithmetic_4da": lambda docs=None: Arithmetic("arithmetic_4da", docs),
    "arithmetic_5da": lambda docs=None: Arithmetic("arithmetic_5da", docs),
}


def get_tasks(names, docs_by_task: Optional[dict] = None) -> List[harness.Task]:
    docs_by_task = docs_by_task or {}
    return [TASK_REGISTRY[n](docs=docs_by_task.get(n)) for n in names]
