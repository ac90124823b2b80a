"""Checkpoint save/restore and discovery (port of
``block_transformer_tpu/utils/checkpoint.py``, which saves through orbax).

A train state (parameters, the AdamW state and the step) goes to
``<dir>/checkpoint-<step>/state.pt`` through ``torch.save`` of plain dicts,
lists and ints of tensors, so ``torch.load`` reads it back with
``weights_only=True``; discovery is the reference's max-step glob
(inference_demo.py:24-41, eval_zero_shot_task.py:330-345), the JAX
package's layout. Every leaf is restored with the dtype it was saved
with: AdamW's moments start in the parameters' dtype and become float32
at the first update when bf16 parameters take float32 gradients
(``train/optimizer.py``), and a resumed run continues from the moments as
they were.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from block_transformer_tpu_torch.train import optimizer as opt
from block_transformer_tpu_torch.train import train_step as ts

_FILE = "state.pt"


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(os.path.abspath(base), f"checkpoint-{step}")


def save_checkpoint(base_dir: str, step: int, state: ts.TrainState) -> str:
    """Write ``state`` under ``<base_dir>/checkpoint-<step>`` (replacing a
    checkpoint of that step); returns the directory."""
    path = _ckpt_dir(base_dir, step)
    os.makedirs(path, exist_ok=True)
    o = state.opt_state
    blob = {"params": state.params, "step": int(state.step),
            "opt_state": None if o is None else {
                "count": int(o.count), "mu": o.mu, "nu": o.nu}}
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def _load(base_dir: str, step: int, device) -> dict:
    return torch.load(os.path.join(_ckpt_dir(base_dir, step), _FILE),
                      map_location=device, weights_only=True)


def _device(tree):
    return opt.tree_leaves(tree)[0].device


def _check_like(name: str, got, like) -> None:
    """The saved tree has ``like``'s paths and shapes."""
    g = {p: tuple(t.shape) for p, t in opt.tree_items(got)}
    w = {p: tuple(t.shape) for p, t in opt.tree_items(like)}
    if g != w:
        diff = sorted(set(g.items()) ^ set(w.items()))[:4]
        raise ValueError(f"checkpoint {name} do not match the state: {diff}")


def restore_checkpoint(base_dir: str, step: int,
                       like: ts.TrainState) -> ts.TrainState:
    """The state saved at ``step``, on the device of ``like``'s parameters;
    its trees must have ``like``'s paths and shapes. Each leaf keeps the
    dtype it was saved with."""
    blob = _load(base_dir, step, _device(like.params))
    _check_like("params", blob["params"], like.params)
    o = blob["opt_state"]
    if o is not None:
        _check_like("moments", o["mu"], like.params)
        _check_like("moments", o["nu"], like.params)
        o = opt.AdamWState(o["count"], o["mu"], o["nu"])
    return ts.TrainState(blob["params"], o, blob["step"])


def find_latest_checkpoint(base_dir: str) -> Optional[int]:
    """The largest step of a ``checkpoint-<N>`` subdirectory, or None."""
    if not os.path.isdir(base_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(base_dir)
             if (m := re.fullmatch(r"checkpoint-(\d+)", name))]
    return max(steps) if steps else None


def restore_params(base_dir: str, step: int, device="cuda"):
    """Only the parameter tree of the state saved at ``step``, whatever
    optimizer made it, on ``device``."""
    return _load(base_dir, step, device)["params"]
