"""The vanilla GPT-NeoX pretraining loop (port of
``block_transformer_tpu/train/vanilla_trainer.py``, the analogue of the
reference's pretrain_vanilla_transformer.py): the baseline family's
training path. It shares the optimizer recipe, the gradient accumulation,
the checkpoints and the metrics file with the block ``Trainer`` and drives
``vanilla_loss`` over flat (unblocked) packed samples. Its records hold
``step``, ``loss`` (the mean over the step's micro-batches), ``lr`` and
``wall_time_s``, as the JAX package's do; the wall time is read after the
device has finished the step. Inside a process group it runs over
``make_mesh(n_data, n_model)`` as the block ``Trainer`` does: the rank's
shards with ZeRO-placed moments, its rows of each micro-batch, the GPT-NeoX
stack split over ``model`` and the LM head's vocab with it, the loss the
masked mean over the whole batch; rank 0 writes the records and the
(full) checkpoints.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from block_transformer_tpu_torch.config import NeoXConfig
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.models import vanilla as vmod
from block_transformer_tpu_torch.parallel import sharding
from block_transformer_tpu_torch.train import train_step as ts
from block_transformer_tpu_torch.train import trainer as trainer_mod
from block_transformer_tpu_torch.utils import checkpoint as ckpt


class VanillaTrainer:
    """``VanillaTrainer(model_cfg, tcfg, dataset).train(resume=False)`` on
    ``device`` (the card unless the caller asks for the CPU; over a mesh,
    the rank's current card); random parameters from ``tcfg.seed``,
    ``trainer.state`` replaceable (over a mesh, by the rank's shards)."""

    def __init__(self, model_cfg: NeoXConfig,
                 tcfg: trainer_mod.TrainerConfig,
                 dataset: packing.PackedDataset, device="cuda"):
        self.mesh = trainer_mod.trainer_mesh(tcfg, device)
        if self.mesh is not None:
            device = sharding.mesh_device(self.mesh)
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.dataset = dataset
        self.device = device
        os.makedirs(tcfg.output_dir, exist_ok=True)
        self._metrics_path = os.path.join(tcfg.output_dir, "metrics.jsonl")

        self.tx, self.schedule = trainer_mod.make_optimizer(tcfg)
        params = vmod.init_vanilla_params(
            tcfg.seed, model_cfg, dtype=trainer_mod.param_dtype(tcfg),
            device=device)

        # over a mesh: the rank's rows and shards, the stack split over
        # ``model`` when the mesh has one
        stack_fn = ts._tp_stack_fn(self.mesh, model_cfg, tcfg.remat)

        def loss_fn(params, batch):
            with ts.mesh_program(self.mesh):
                loss = vmod.vanilla_loss(
                    params, model_cfg, batch["input_ids"],
                    batch["attention_mask"], batch["labels"],
                    remat=tcfg.remat, stack_fn=stack_fn)
            return loss, {"loss": loss}

        (self.grad_fn, self.apply_fn, self.zeros_fn, self.mesh_state,
         self.state) = trainer_mod.make_train_fns(
            self.mesh, model_cfg, tcfg, self.tx,
            ts.TrainState(params, self.tx.init(params), 0), loss_fn=loss_fn,
            keys=("input_ids", "attention_mask", "labels"))
        self.micro_batch = tcfg.micro_batch_size or tcfg.total_batch_size
        if tcfg.total_batch_size % self.micro_batch:
            raise ValueError("total_batch_size must divide by micro_batch_size")
        self.grad_accum = tcfg.total_batch_size // self.micro_batch

    def train(self, resume: bool = False) -> ts.TrainState:
        tcfg = self.tcfg
        start = 0
        if resume:
            latest = ckpt.find_latest_checkpoint(tcfg.output_dir)
            if latest is not None:
                self.state = self.mesh_state.restore(tcfg.output_dir, latest,
                                                     self.state)
                start = latest
        stop = tcfg.stop_steps or tcfg.num_train_steps
        cursor = start * tcfg.total_batch_size
        for step in range(start, stop):
            t0 = time.perf_counter()
            grads = self.zeros_fn(self.state.params)
            losses = []
            for _ in range(self.grad_accum):
                idxs = (np.arange(cursor, cursor + self.micro_batch)
                        % len(self.dataset))
                cursor += self.micro_batch
                raw = self.dataset.get_batch(idxs)
                batch = {
                    "input_ids": raw["input_ids"].astype(np.int32),
                    "attention_mask": raw["attention_mask"].astype(np.int32),
                    "labels": packing.add_labels(
                        raw["input_ids"], raw["attention_mask"]).astype(
                            np.int32)}
                if self.mesh is None:     # over a mesh, the step cuts it
                    batch = packing.to_device(batch, self.device)
                grads, metrics = self.grad_fn(self.state.params, batch, grads)
                losses.append(metrics["loss"])
            self.state, _ = self.apply_fn(self.state, grads,
                                          float(self.grad_accum))
            del grads
            loss = float(torch.stack(losses).mean())
            trainer_mod.synchronize(self.device)
            if ((step + 1) % tcfg.logging_steps == 0 or step == stop - 1) \
                    and self.mesh_state.rank0:
                trainer_mod.append_record(self._metrics_path, {
                    "step": step + 1, "loss": loss,
                    "lr": float(self.schedule(step + 1)),
                    "wall_time_s": time.perf_counter() - t0})
            if (step + 1) % tcfg.save_steps == 0 or step == stop - 1:
                self.mesh_state.save(tcfg.output_dir, step + 1, self.state)
        return self.state
