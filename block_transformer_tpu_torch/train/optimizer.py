"""AdamW with a linear warmup and a cosine decay (port of
``block_transformer_tpu/train/optimizer.py``, which builds it from optax).

The recipe is the reference's DeepSpeed config: clip the gradients by their
global norm, then AdamW with betas (0.9, 0.95), eps 1e-8 and weight decay
0.1, no decay on layer norms and biases (``_decay_mask``), at a learning rate
that rises linearly from 0 over ``warmup_steps`` and then follows a cosine
to ``cos_min_ratio`` of its peak. Each formula is optax's, in float32, in
optax's order of operations:

- clipping keeps g when ``norm < max_norm`` and otherwise takes ``g / norm *
  max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``
  instead, so it is not used);
- ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, then ``u = (mu /
  (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)`` at count ``t`` (1 at the
  first step), plus ``weight_decay * p`` where the mask allows;
- the update is ``-lr(count) * u`` with the schedule read at the count
  *before* the step, so the first step has lr 0.

Parameter trees are nested dicts of tensors; their leaves are visited in
sorted key order, as JAX flattens a dict, so the global norm sums the
leaves in JAX's order. Each new moment and each update is a new tensor;
the new moments replace the old ones in the state's trees.

The dtypes follow optax's arithmetic where bf16 parameters take float32
gradients (the trainer's float32 accumulator): the moments start as zeros
in the parameters' dtype, and ``(1 - b) g + b m`` is float32, so each
moment becomes float32 at the first update; the update is float32, with the decay term ``p *
weight_decay`` rounded in the parameters' dtype before it is added, and
the caller casts it to the parameter's dtype before adding it (``p +
u.astype(p.dtype)`` in JAX). Where the moments already have the
gradient's dtype, every result is what it was, bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


def tree_items(tree, path=()):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    else:
        yield path, tree


def tree_map(fn, tree, *rest):
    """``fn`` on the leaves of ``tree`` (and the matching leaves of
    ``rest``), the dict structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, the leaves
    added one after another (optax's ``global_norm``)."""
    total = 0
    for g in leaves:
        total = total + torch.sum(g * g)
    return torch.sqrt(total)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, cos_min_ratio: float = 0.1
                           ) -> Callable[[int], float]:
    """count -> learning rate: optax's ``join_schedules`` of a linear warmup
    from 0 to ``peak_lr`` over ``warmup_steps`` and a cosine decay from
    ``peak_lr`` to ``cos_min_ratio * peak_lr`` over the remaining ``max(1,
    total_steps - warmup_steps)`` steps, in float32 (the value returned is
    that float32 number)."""
    decay_steps = max(1, total_steps - warmup_steps)

    def warmup(count: int) -> torch.Tensor:
        if warmup_steps <= 0:                  # optax: a constant schedule
            return _f32(0.0)
        c = _f32(min(max(count, 0), warmup_steps))
        frac = 1 - c / _f32(warmup_steps)
        return _f32(0.0 - peak_lr) * frac + _f32(peak_lr)

    def cosine(count: int) -> torch.Tensor:
        c = torch.minimum(_f32(count), _f32(decay_steps))
        decay = 0.5 * (1 + torch.cos(_f32(math.pi) * c / _f32(decay_steps)))
        return _f32(peak_lr) * (_f32(1 - cos_min_ratio) * decay
                                + _f32(cos_min_ratio))

    def schedule(count: int) -> float:
        return float(warmup(count) if count < warmup_steps
                     else cosine(count - warmup_steps))

    return schedule


def _decay_mask(params):
    """True for the leaves that take weight decay: not a bias or a (layer
    norm) scale, and not under ``ln1``, ``ln2`` or ``final_ln``."""
    return {path: not (path[-1] in ("bias", "scale") or any(
                n in path for n in ("ln1", "ln2", "final_ln")))
            for path, _ in tree_items(params)}


class AdamWState(NamedTuple):
    """optax's Adam state: the step count (the schedule's as well) and the
    first and second moments, trees shaped like the parameters."""
    count: int
    mu: dict
    nu: dict


class AdamW(NamedTuple):
    """``init(params) -> AdamWState``; ``update(grads, state, params) ->
    (updates, state)``, optax's interface. ``update`` puts the new moments
    into the trees ``state.mu`` / ``state.nu`` in place of the old ones."""
    schedule: Callable[[int], float]
    weight_decay: float
    b1: float
    b2: float
    eps: float
    grad_clip: float

    def init(self, params) -> AdamWState:
        return AdamWState(0, tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        items = list(tree_items(grads))
        mask = _decay_mask(grads)
        norm = global_norm([g for _, g in items])
        step = self.step_scalars(state.count, norm)
        mu = dict(tree_items(state.mu))
        nu = dict(tree_items(state.nu))
        ps = dict(tree_items(params))
        updates = {}
        for path, g in items:
            # popped, so each old moment is freed as its leaf is done
            m, v, u = self.leaf_update(step, g, mu.pop(path), nu.pop(path),
                                       ps[path], mask[path])
            _set_leaf(state.mu, path, m)
            _set_leaf(state.nu, path, v)
            updates[path] = u
        return tree_unflatten(updates), AdamWState(state.count + 1, state.mu,
                                                   state.nu)

    def step_scalars(self, count: int, norm: torch.Tensor) -> tuple:
        """The step's scalars at ``count`` (the count before the step) and
        the gradients' global ``norm``: (norm, keep = norm < grad_clip, the
        bias corrections (1 - b1^t), (1 - b2^t), -lr), the last three made
        on the host in float32 and copied to the norm's device at once."""
        b = _f32([self.b1, self.b2])
        bc = 1 - b ** (count + 1)
        scalars = torch.cat([bc, _f32([-self.schedule(count)])]).to(
            norm.device)
        return (norm, norm < self.grad_clip, scalars[0], scalars[1],
                scalars[2])

    def leaf_update(self, step: tuple, g, mu, nu, p, decay: bool):
        """One leaf's (new mu, new nu, update) at ``step_scalars``: the
        clipped gradient, then optax's moments (b m in m's dtype, the sum
        in g's), the bias-corrected ratio, the weight decay where
        ``decay``, times -lr. Elementwise, so a slice of a leaf updates as
        it would inside the whole."""
        norm, keep, bc1, bc2, neg_lr = step
        g = torch.where(keep, g, g / norm * self.grad_clip)
        m = (g * (1 - self.b1)) + (mu * self.b1)
        v = (g * g * (1 - self.b2)) + (nu * self.b2)
        u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        if decay:
            u = u + p * self.weight_decay
        return m, v, u * neg_lr


def _set_leaf(tree: dict, path: tuple, leaf) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = leaf


def tree_unflatten(flat: dict) -> dict:
    """{path: leaf} -> the nested dict."""
    out = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def make_optimizer(peak_lr: float = 1e-3, warmup_steps: int = 3000,
                   total_steps: int = 572000, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95, grad_clip: float = 1.0,
                   cos_min_ratio: float = 0.1):
    """(tx, schedule), as the JAX package's ``make_optimizer``."""
    schedule = warmup_cosine_schedule(peak_lr, warmup_steps, total_steps,
                                      cos_min_ratio)
    return AdamW(schedule, weight_decay, b1, b2, 1e-8, grad_clip), schedule
