"""The training loop (port of ``block_transformer_tpu/train/trainer.py``,
the analogue of the reference's HF Trainer + DeepSpeed stack,
pretrain_block_transformer.py + util/callback.py), on one device or over a
(data, model) mesh.

One host loop drives the train step (``train_step.make_grad_and_apply``,
or ``make_sharded_grad_and_apply`` over a mesh).
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

Inside a ``torch.distributed`` process group, the trainer runs as one rank
of ``sharding.make_mesh(n_data, n_model)`` over the group's ranks (JAX's
defaults when they are None), as the JAX trainer does over its devices:
every rank builds the same initial state from ``tcfg.seed`` and keeps its
shards (``train_step.shard_state``: ZeRO-placed moments), every rank
draws the same micro-batches and gives each to the sharded step, which
takes the rank's rows. Rank 0 alone writes ``metrics.jsonl`` and the
checkpoints; a checkpoint holds the full (gathered) state in JAX's layout,
the same file a one-device run writes, and a mesh run restores it (so
does a one-device run). Outside a process group it runs on one device,
and ``n_data`` / ``n_model`` other than None or 1 raise. Under autograd the
model's attention and float linears stay on their plain PyTorch paths, as
the JAX trainer's do under its mesh, where Pallas is off
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
import torch.distributed as dist

from block_transformer_tpu_torch.config import BlockTransformerConfig
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.parallel import sharding
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


def trainer_mesh(tcfg: TrainerConfig, device):
    """The trainer's mesh: ``make_mesh(n_data, n_model)`` over the ranks of
    the process group, or None outside one (one device), where a mesh of
    more than one rank cannot be had."""
    if dist.is_initialized():
        return sharding.make_mesh(tcfg.n_data, tcfg.n_model, device=device)
    if tcfg.n_data not in (None, 1) or tcfg.n_model not in (None, 1):
        raise RuntimeError(
            f"n_data={tcfg.n_data}, n_model={tcfg.n_model} ask for a mesh: "
            "start one process a rank and join them in a process group "
            "(torch.distributed.init_process_group) before the trainer")
    return None


class MeshState:
    """A trainer's state over a mesh: the rank's shards under ``spec``
    (``train_step._state_spec``); ``full(state)`` gathers it whole and
    ``shard(full)`` cuts a full state into this rank's shards, both
    collectives. On one device (``mesh`` None) both are the identity."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec

    def full(self, state: ts.TrainState) -> ts.TrainState:
        if self.mesh is None:
            return state
        return ts.gather_state(self.mesh, state, self.spec)

    def shard(self, state: ts.TrainState) -> ts.TrainState:
        if self.mesh is None:
            return state
        return ts.shard_with(self.mesh, state, self.spec)

    @property
    def rank0(self) -> bool:
        return self.mesh is None or dist.get_rank() == 0

    def save(self, out_dir: str, step: int, state: ts.TrainState) -> None:
        """The full state saved by rank 0, gathered leaf by leaf into its
        host memory (``gather_state(to_host=True)``: no device holds the
        whole state); the ranks wait for it."""
        if self.mesh is None:
            ckpt.save_checkpoint(out_dir, step, state)
            return
        full = ts.gather_state(self.mesh, state, self.spec, to_host=True)
        if full is not None:
            ckpt.save_checkpoint(out_dir, step, full)
        del full
        dist.barrier()

    def restore(self, out_dir: str, step: int,
                state: ts.TrainState) -> ts.TrainState:
        """The full state saved at ``step``, as this rank's shards: the file
        mapped into host memory (shapes checked against the full state's),
        each rank's blocks cut from it and copied to its device."""
        if self.mesh is None:
            return ckpt.restore_checkpoint(out_dir, step, state)
        like = ts.empty_full_state(self.mesh, state, self.spec)
        return self.shard(ckpt.restore_checkpoint(out_dir, step, like))


def make_train_fns(mesh, model_cfg, tcfg: TrainerConfig, tx, state,
                   loss_fn=None, keys=ts.BATCH_KEYS):
    """(grad_fn, apply_fn, zeros_fn, MeshState, the rank's state) of a
    trainer from the full initial ``state``: ``make_grad_and_apply`` on
    one device, ``make_sharded_grad_and_apply`` over ``mesh``
    (``train_step.grad_and_apply_on`` with ``loss_fn``, the rank's own
    loss over the batch fields ``keys``, when given)."""
    if mesh is None:
        fns = ts.make_grad_and_apply(
            loss_fn or ts.make_loss_fn(model_cfg, tcfg.remat), tx)
        return (*fns, MeshState(None, None), state)
    spec = ts._state_spec(mesh, state.params)
    if loss_fn is None:
        fns = ts.make_sharded_grad_and_apply(mesh, model_cfg, tx,
                                             state.params, remat=tcfg.remat)
    else:
        fns = ts.grad_and_apply_on(mesh, tx, spec, loss_fn, keys=keys)
    return (*fns, MeshState(mesh, spec), ts.shard_with(mesh, state, spec))


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
    asks for the CPU; over a mesh, the rank's current card); ``trainer.
    state`` may be replaced before ``train`` (uptraining, or a state taken
    from elsewhere; over a mesh, the rank's shards: ``mesh_state.shard``
    of a full state). ``checkpoint_log`` lists each checkpoint written or
    read, ``{"op": "save" | "restore", "step", "s"}``, with its host
    seconds."""

    def __init__(self, model_cfg: BlockTransformerConfig, tcfg: TrainerConfig,
                 dataset: packing.PackedDataset,
                 eval_hook: Optional[Callable[[int, dict], dict]] = None,
                 device="cuda"):
        self.mesh = trainer_mesh(tcfg, device)
        if self.mesh is not None:
            device = sharding.mesh_device(self.mesh)
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.dataset = dataset
        self.eval_hook = eval_hook
        self.device = device
        os.makedirs(tcfg.output_dir, exist_ok=True)
        self._metrics_path = os.path.join(tcfg.output_dir, "metrics.jsonl")
        self.checkpoint_log = []

        self.tx, self.schedule = make_optimizer(tcfg)
        (self.grad_fn, self.apply_fn, self.zeros_fn, self.mesh_state,
         self.state) = make_train_fns(
            self.mesh, model_cfg, tcfg, self.tx, ts.create_train_state(
                tcfg.seed, model_cfg, self.tx, dtype=param_dtype(tcfg),
                device=device))

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
                self.state = self.mesh_state.restore(tcfg.output_dir, latest,
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
                batch = packing.make_train_batch(
                    self.dataset, idxs, self.model_cfg.block_length,
                    distribution=self._distribution)
                if self.mesh is None:     # over a mesh, the step cuts it
                    batch = packing.to_device(batch, self.device)
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
                if self.mesh_state.rank0:
                    mean = {k: float(np.mean([float(m[k])
                                              for m in step_metrics]))
                            for k in step_metrics[0]
                            if k != "loss_by_position"}
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
                self.mesh_state.save(tcfg.output_dir, step + 1, self.state)
                self.checkpoint_log.append({"op": "save", "step": step + 1,
                                            "s": time.perf_counter() - t0})

            if self.eval_hook is not None:
                self.eval_hook(step + 1, {
                    "params": self.mesh_state.full(self.state).params})
        return self.state
