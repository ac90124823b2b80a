"""The vanilla GPT-NeoX pretraining loop (port of
``block_transformer_tpu/train/vanilla_trainer.py``, the analogue of the
reference's pretrain_vanilla_transformer.py): the baseline family's
training path. It shares the optimizer recipe, the gradient accumulation,
the checkpoints and the metrics file with the block ``Trainer`` and drives
``vanilla_loss`` over flat (unblocked) packed samples. Its records hold
``step``, ``loss`` (the mean over the step's micro-batches), ``lr`` and
``wall_time_s``, as the JAX package's do; the wall time is read after the
device has finished the step.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from block_transformer_tpu_torch.config import NeoXConfig
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.models import vanilla as vmod
from block_transformer_tpu_torch.train import train_step as ts
from block_transformer_tpu_torch.train import trainer as trainer_mod
from block_transformer_tpu_torch.utils import checkpoint as ckpt


class VanillaTrainer:
    """``VanillaTrainer(model_cfg, tcfg, dataset).train(resume=False)`` on
    ``device`` (the card unless the caller asks for the CPU); random
    parameters from ``tcfg.seed``, ``trainer.state`` replaceable."""

    def __init__(self, model_cfg: NeoXConfig,
                 tcfg: trainer_mod.TrainerConfig,
                 dataset: packing.PackedDataset, device="cuda"):
        trainer_mod.check_single_device(tcfg)
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
        self.state = ts.TrainState(params, self.tx.init(params), 0)

        def loss_fn(params, batch):
            loss = vmod.vanilla_loss(params, model_cfg, batch["input_ids"],
                                     batch["attention_mask"],
                                     batch["labels"], remat=tcfg.remat)
            return loss, {"loss": loss}

        self.grad_fn, self.apply_fn, self.zeros_fn = ts.make_grad_and_apply(
            loss_fn, self.tx)
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
                self.state = ckpt.restore_checkpoint(tcfg.output_dir, latest,
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
                batch = packing.to_device({
                    "input_ids": raw["input_ids"].astype(np.int32),
                    "attention_mask": raw["attention_mask"].astype(np.int32),
                    "labels": packing.add_labels(
                        raw["input_ids"], raw["attention_mask"]).astype(
                            np.int32)}, self.device)
                grads, metrics = self.grad_fn(self.state.params, batch, grads)
                losses.append(metrics["loss"])
            self.state, _ = self.apply_fn(self.state, grads,
                                          float(self.grad_accum))
            del grads
            loss = float(torch.stack(losses).mean())
            trainer_mod.synchronize(self.device)
            if (step + 1) % tcfg.logging_steps == 0 or step == stop - 1:
                trainer_mod.append_record(self._metrics_path, {
                    "step": step + 1, "loss": loss,
                    "lr": float(self.schedule(step + 1)),
                    "wall_time_s": time.perf_counter() - t0})
            if (step + 1) % tcfg.save_steps == 0 or step == stop - 1:
                ckpt.save_checkpoint(tcfg.output_dir, step + 1, self.state)
        return self.state
