"""The training loop (port of ``block_transformer_tpu/train/trainer.py``,
the analogue of the reference's HF Trainer + DeepSpeed stack,
pretrain_block_transformer.py + util/callback.py), on one device.

One host loop drives the train step (``train_step.make_grad_and_apply``).
What it carries over from the reference, as the JAX package does:

- gradient accumulation derived from ``total_batch_size``
  (util/config.py:42-64): a float32 accumulator, the mean gradient applied
  once a step;
- per-component loss logging with the loss-by-position curve, accumulated
  in float64 on the host (util/callback.py:21-116);
- a fixed stop at ``stop_steps`` with the schedule's horizon kept at
  ``num_train_steps`` (FixedStoppingCallback, util/callback.py:119-132);
- the batch-size ramp-up: half the batch for the first ``rampup_steps`` by
  halving the accumulation, with the samples taken contiguously
  (BatchSizeRampupCallback, util/callback.py:135-180);
- each step's wall time, read after the device has finished the step;
- checkpoints every ``save_steps`` and at the stop, and resume from the
  latest; an optional ``eval_hook(step, {"params": ...})`` after each step
  (the ZeroshotEvalCallback analogue).

Metrics go to ``<output_dir>/metrics.jsonl``, one record a logged step
with the JAX package's keys: ``step``, ``lr`` (the schedule at ``step +
1``), ``grad_norm`` (of the mean gradient), ``wall_time_s``,
``tokens_seen`` (samples consumed times ``max_length``),
``loss_by_position`` (the mean since the last record) and the mean over
the step's micro-batches of each loss.

The JAX trainer runs its step under a (data, model) mesh; this one runs on
one device and takes ``n_data`` and ``n_model`` of None or 1 only. Under
autograd the model's attention and float linears stay on their plain
PyTorch paths, as the JAX trainer's do under its mesh, where Pallas is off
(``ops/linear.py:pallas_allowed``): training launches no hand kernel.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from block_transformer_tpu_torch.config import BlockTransformerConfig
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.train import optimizer as opt_mod
from block_transformer_tpu_torch.train import train_step as ts
from block_transformer_tpu_torch.utils import checkpoint as ckpt


@dataclass
class TrainerConfig:
    output_dir: str = "results/run"
    learning_rate: float = 1e-3
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    weight_decay: float = 0.1
    num_train_steps: int = 1000
    stop_steps: Optional[int] = None
    num_warmup_steps: int = 100
    total_batch_size: int = 8
    micro_batch_size: Optional[int] = None   # per-step device batch
    batch_size_rampup_steps: Optional[int] = None
    max_length: int = 2048
    save_steps: int = 500
    logging_steps: int = 50
    seed: int = 42
    param_dtype: str = "float32"
    remat: bool = True
    n_data: Optional[int] = None
    n_model: Optional[int] = None
    # variable block lengths (util/data_preprocessing.py:123-154): e.g.
    # "uniform" with {"mean": 4, "radius": 3}; None/"fixed" = reshape path.
    # The model's block_length must equal the distribution max.
    block_split_distribution: Optional[str] = None
    block_split_kwargs: Optional[dict] = None


def check_single_device(tcfg: TrainerConfig) -> None:
    if tcfg.n_data not in (None, 1) or tcfg.n_model not in (None, 1):
        raise NotImplementedError(
            f"n_data={tcfg.n_data}, n_model={tcfg.n_model}: data and tensor "
            "parallelism are not ported (ROADMAP.md, Queue 1 item 5); the "
            "trainer runs on one device")


def param_dtype(tcfg: TrainerConfig) -> torch.dtype:
    return torch.float32 if tcfg.param_dtype == "float32" else torch.bfloat16


def make_optimizer(tcfg: TrainerConfig):
    return opt_mod.make_optimizer(
        peak_lr=tcfg.learning_rate, warmup_steps=tcfg.num_warmup_steps,
        total_steps=tcfg.num_train_steps, weight_decay=tcfg.weight_decay,
        b1=tcfg.adam_beta1, b2=tcfg.adam_beta2)


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def append_record(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


class Trainer:
    """``Trainer(model_cfg, tcfg, dataset).train(resume=False)``: random
    parameters from ``tcfg.seed`` on ``device`` (the card unless the caller
    asks for the CPU); ``trainer.state`` may be replaced before ``train``
    (uptraining, or a state taken from elsewhere). ``checkpoint_log``
    lists each checkpoint written or read, ``{"op": "save" | "restore",
    "step", "s"}``, with its host seconds."""

    def __init__(self, model_cfg: BlockTransformerConfig, tcfg: TrainerConfig,
                 dataset: packing.PackedDataset,
                 eval_hook: Optional[Callable[[int, dict], dict]] = None,
                 device="cuda"):
        check_single_device(tcfg)
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.dataset = dataset
        self.eval_hook = eval_hook
        self.device = device
        os.makedirs(tcfg.output_dir, exist_ok=True)
        self._metrics_path = os.path.join(tcfg.output_dir, "metrics.jsonl")
        self.checkpoint_log = []

        self.tx, self.schedule = make_optimizer(tcfg)
        self.state = ts.create_train_state(tcfg.seed, model_cfg, self.tx,
                                           dtype=param_dtype(tcfg),
                                           device=device)
        self.grad_fn, self.apply_fn, self.zeros_fn = ts.make_grad_and_apply(
            ts.make_loss_fn(model_cfg, tcfg.remat), self.tx)

        self.micro_batch = tcfg.micro_batch_size or tcfg.total_batch_size
        if tcfg.total_batch_size % self.micro_batch:
            raise ValueError("total_batch_size must divide by micro_batch_size")
        self.grad_accum = tcfg.total_batch_size // self.micro_batch
        if tcfg.batch_size_rampup_steps and self.grad_accum == 1:
            raise ValueError("batch_size_rampup_steps requires grad "
                             "accumulation > 1 (set micro_batch_size)")
        # the float64 loss-by-position accumulator (reference semantics)
        self._lbp_sum = None
        self._lbp_count = 0

        self._distribution = None
        if tcfg.block_split_distribution not in (None, "fixed"):
            from block_transformer_tpu_torch.data import block_split as bs
            dist_cls = bs.DISTRIBUTIONS[tcfg.block_split_distribution]
            self._distribution = dist_cls(**(tcfg.block_split_kwargs or {}),
                                          seed=tcfg.seed)
            if self._distribution.max != model_cfg.block_length:
                raise ValueError(
                    f"block_split distribution max {self._distribution.max} "
                    f"!= model block_length {model_cfg.block_length} (blocks "
                    f"are padded to the distribution max)")

    # ------------------------------------------------------------------
    def _effective_accum(self, step: int) -> int:
        # the reference's ramp-up halves the accumulation, rounding up
        # (util/callback.py:147-180), and its dataloader keeps taking
        # samples contiguously: the sample cursor does the same
        r = self.tcfg.batch_size_rampup_steps
        if r and step < r:
            return max(1, -(-self.grad_accum // 2))
        return self.grad_accum

    def _samples_consumed_before(self, step: int) -> int:
        r = self.tcfg.batch_size_rampup_steps or 0
        half = max(1, -(-self.grad_accum // 2)) * self.micro_batch
        full = self.grad_accum * self.micro_batch
        ramp_steps = min(step, r)
        return ramp_steps * half + (step - ramp_steps) * full

    # ------------------------------------------------------------------
    def train(self, resume: bool = False) -> ts.TrainState:
        tcfg = self.tcfg
        start_step = 0
        if resume:
            latest = ckpt.find_latest_checkpoint(tcfg.output_dir)
            if latest is not None:
                t0 = time.perf_counter()
                self.state = ckpt.restore_checkpoint(tcfg.output_dir, latest,
                                                     self.state)
                synchronize(self.device)
                self.checkpoint_log.append({"op": "restore", "step": latest,
                                            "s": time.perf_counter() - t0})
                start_step = latest
        stop = tcfg.stop_steps or tcfg.num_train_steps

        cursor = self._samples_consumed_before(start_step)
        for step in range(start_step, stop):
            t0 = time.perf_counter()
            accum = self._effective_accum(step)
            step_metrics = []
            grads = self.zeros_fn(self.state.params)
            for _ in range(accum):
                idxs = (np.arange(cursor, cursor + self.micro_batch)
                        % len(self.dataset))
                cursor += self.micro_batch
                batch = packing.to_device(packing.fetch_train_batch(
                    self.dataset, idxs, self.model_cfg.block_length,
                    distribution=self._distribution), self.device)
                grads, metrics = self.grad_fn(self.state.params, batch, grads)
                step_metrics.append(metrics)
            self.state, grad_norm = self.apply_fn(self.state, grads,
                                                  float(accum))
            del grads
            synchronize(self.device)
            dt = time.perf_counter() - t0

            lbp = np.mean([m["loss_by_position"].cpu().numpy().astype(
                np.float64) for m in step_metrics], axis=0)
            self._lbp_sum = lbp if self._lbp_sum is None else self._lbp_sum + lbp
            self._lbp_count += 1

            if (step + 1) % tcfg.logging_steps == 0 or step == stop - 1:
                mean = {k: float(np.mean([float(m[k]) for m in step_metrics]))
                        for k in step_metrics[0] if k != "loss_by_position"}
                append_record(self._metrics_path, {
                    "step": step + 1,
                    "lr": float(self.schedule(step + 1)),
                    "grad_norm": float(grad_norm),
                    "wall_time_s": dt,
                    "tokens_seen": cursor * tcfg.max_length,
                    "loss_by_position":
                        (self._lbp_sum / self._lbp_count).tolist(),
                    **mean})
                self._lbp_sum, self._lbp_count = None, 0

            if (step + 1) % tcfg.save_steps == 0 or step == stop - 1:
                t0 = time.perf_counter()
                ckpt.save_checkpoint(tcfg.output_dir, step + 1, self.state)
                self.checkpoint_log.append({"op": "save", "step": step + 1,
                                            "s": time.perf_counter() - t0})

            if self.eval_hook is not None:
                self.eval_hook(step + 1, {"params": self.state.params})
        return self.state
