"""In-training zero-shot evaluation hook (port of
``block_transformer_tpu/train/eval_callback.py``, the ZeroshotEvalCallback
analogue, util/callback.py:254-403): every ``eval_steps`` steps, wrap the
current params in the block LM adapter, run the configured task suite, and
append results to ``<output_dir>/zeroshot_eval.jsonl``."""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence


def make_zeroshot_eval_hook(cfg, tokenizer, task_names: Sequence[str],
                            eval_steps: int, output_dir: str,
                            limit: Optional[int] = None, batch_size: int = 8,
                            max_length: int = 2048, nopad: bool = False,
                            docs_by_task: Optional[dict] = None):
    """Returns hook(step, {"params": ...}) for Trainer(eval_hook=...)."""
    from block_transformer_tpu_torch.eval import adapters, harness
    from block_transformer_tpu_torch.eval import tasks as task_mod

    path = os.path.join(output_dir, "zeroshot_eval.jsonl")
    # build the adapter and tasks ONCE: tasks hold their loaded datasets;
    # only params are swapped per call (scoring runs on their device)
    lm = adapters.BlockTransformerLM(None, cfg, tokenizer,
                                     max_length=max_length,
                                     batch_size=batch_size, nopad=nopad)
    tasks = task_mod.get_tasks(task_names, docs_by_task)

    def hook(step: int, state: dict):
        if eval_steps <= 0 or step % eval_steps != 0:
            return None
        lm.params = state["params"]
        results = harness.evaluate(lm, tasks, limit=limit)
        rec = {"step": step, **{f"{t}/{m}": v
                                for t, ms in results["results"].items()
                                for m, v in ms.items()}}
        os.makedirs(output_dir, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return results

    return hook
