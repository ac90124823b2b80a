"""The single-device train step (port of
``block_transformer_tpu/train/train_step.py``: ``TrainState``,
``make_loss_fn``, ``make_train_step``, ``create_train_state``, and
``make_grad_and_apply``, the single-device form of
``make_sharded_grad_and_apply`` for gradient accumulation).

One call computes the loss and its metrics, the gradients of every
parameter by autograd, the optimizer's update and the gradients' global
norm. The forward is the model's own (``block_transformer_forward`` with
labels); under autograd its attention stays on the plain path
(``ops.attention``), as the JAX package trains with ``attn_impl="xla"``,
and ``remat`` (the default) checkpoints each layer of both stacks.
``param_transform`` maps the parameters before the forward: QAT passes
``ops.quant.fake_quant_block_transformer`` with its recipe, and the
straight-through estimator carries the gradients to the float master
weights.

Unlike JAX's functional step, this one updates ``state.params`` in place,
puts the optimizer's new moments into the state's own trees, and returns a
state that shares them: at
``block_main_b4_1.2b`` the parameters, gradients and the two moments are
~23 GB in float32, and a second copy of the state would not be cheap.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from block_transformer_tpu_torch.config import BlockTransformerConfig
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.train import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def make_loss_fn(cfg: BlockTransformerConfig, remat: bool = True,
                 param_transform=None):
    """loss_fn(params, batch) -> (loss, metrics): the model's loss and the
    metrics the reference logs (``loss``, ``token_decoding_loss``,
    ``loss_by_position``, and ``block_decoding_loss`` /
    ``auto_encoding_loss`` where the config enables them). ``batch`` holds
    ``input_ids``, ``attention_mask``, ``labels`` [B, N, L] and
    ``block_attention_mask`` [B, N] (``data.packing.make_train_batch`` or
    ``make_train_batch_from_rows``)."""
    def loss_fn(params, batch):
        if param_transform is not None:
            params = param_transform(params)
        out = bt.block_transformer_forward(
            params, cfg, batch["input_ids"], batch["attention_mask"],
            batch["block_attention_mask"], labels=batch["labels"],
            compute_logits=False, remat=remat)
        metrics = {"loss": out.loss,
                   "token_decoding_loss": out.token_decoding_loss,
                   "loss_by_position": out.loss_by_position}
        for name in ("block_decoding_loss", "auto_encoding_loss"):
            if getattr(out, name) is not None:
                metrics[name] = getattr(out, name)
        return out.loss, metrics

    return loss_fn


def make_train_step(cfg: BlockTransformerConfig, tx, remat: bool = True,
                    param_transform=None):
    """train_step(state, batch) -> (state, metrics): metrics are the loss
    function's, detached, plus ``grad_norm`` (the global norm of the raw
    gradients)."""
    loss_fn = make_loss_fn(cfg, remat, param_transform=param_transform)

    def train_step(state: TrainState, batch):
        grads, metrics = _grads(loss_fn, state.params, batch)
        with torch.no_grad():
            opt_state = _apply(tx, state, grads)
            metrics["grad_norm"] = opt.global_norm(grads.values())
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return train_step


def _grads(loss_fn, params, batch):
    """({path: gradient}, detached metrics) of ``loss_fn(params, batch)``,
    the paths in sorted order."""
    live = {path: p.detach().requires_grad_(True)
            for path, p in opt.tree_items(params)}
    with torch.enable_grad():
        loss, metrics = loss_fn(opt.tree_unflatten(live), batch)
        grads = dict(zip(live, torch.autograd.grad(loss,
                                                   list(live.values()))))
    return grads, {k: v.detach() for k, v in metrics.items()}


def _apply(tx, state: TrainState, grads: dict):
    """The optimizer's update of ``grads`` ({path: gradient}) added to
    ``state.params`` in place, cast to each parameter's dtype first (JAX's
    ``p + u.astype(p.dtype)``); returns the new optimizer state."""
    updates, opt_state = tx.update(opt.tree_unflatten(grads),
                                   state.opt_state, state.params)
    for p, u in zip(opt.tree_leaves(state.params), opt.tree_leaves(updates)):
        p.add_(u.to(p.dtype))
    return opt_state


def make_grad_and_apply(loss_fn, tx):
    """(grad_fn, apply_fn, zeros_fn) for exact gradient accumulation: the
    single-device form of the JAX package's ``make_sharded_grad_and_apply``
    (which builds ``make_loss_fn(cfg, remat)`` itself).

    - ``zeros_fn(params)``: a float32 accumulator shaped like ``params``;
    - ``grad_fn(params, batch, acc) -> (acc, metrics)``: one micro-batch's
      gradients, cast to float32 and added into ``acc`` in place;
    - ``apply_fn(state, acc, n_accum) -> (state, grad_norm)``: the mean
      gradient ``acc / n_accum`` through the optimizer, the parameters
      updated in place, and the global norm of the mean gradient.

    ``loss_fn(params, batch) -> (loss, metrics)``: ``make_loss_fn``'s for
    the block trainer, ``vanilla_loss`` with its loss as the one metric for
    the vanilla trainer.
    """
    def zeros_fn(params):
        return opt.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)

    def grad_fn(params, batch, acc):
        grads, metrics = _grads(loss_fn, params, batch)
        with torch.no_grad():
            for a, g in zip(opt.tree_leaves(acc), grads.values()):
                a.add_(g.to(a.dtype))
        return acc, metrics

    def apply_fn(state: TrainState, acc, n_accum: float):
        with torch.no_grad():
            grads = {path: g / n_accum for path, g in opt.tree_items(acc)}
            opt_state = _apply(tx, state, grads)
            norm = opt.global_norm(grads.values())
        return TrainState(state.params, opt_state, state.step + 1), norm

    return grad_fn, apply_fn, zeros_fn


def create_train_state(gen, cfg: BlockTransformerConfig, tx,
                       dtype=torch.float32, device="cuda") -> TrainState:
    """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
    ``device``, or an int seed) and the optimizer's initial state."""
    params = bt.init_block_transformer_params(gen, cfg, dtype=dtype,
                                              device=device)
    return TrainState(params, tx.init(params), 0)
