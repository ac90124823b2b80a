"""Collectives with a backward, for the per-rank training programs over a
mesh (``train/train_step.py``, ``parallel/pipeline.py``).

JAX trains under a mesh by annotating shardings and leaving the
collectives to GSPMD, which differentiates through them. Here every rank
runs the same Python on its own shards, and each collective the forward
needs is placed by hand as a ``torch.autograd.Function`` whose backward is
the collective the gradient needs. Two conventions meet:

- over ``model`` (Megatron's tensor parallelism) the ranks compute one
  replicated loss: ``copy_to`` (identity forward, all-reduce backward) at
  the input of a column-parallel linear, ``reduce_from`` (all-reduce
  forward, identity backward) at the output of a row-parallel one, and
  ``gather_from`` (all-gather forward, the rank's slice backward) where a
  column-sharded weight is used whole;
- over the data axes, ``seq`` and ``pipe`` the loss is the sum of the
  ranks' parts: the gradient of a parameter held on several such ranks is
  the sum of theirs (``train_step`` all-reduces it), an all-gather's
  backward is a reduce-scatter (``gather_sum``: an all-reduce, then the
  rank's slice), and a shift to the next rank (``shift``, JAX's
  ``ppermute``) sends its gradient back to the rank before.

Every rank must issue the same collectives in the same order, forward
and backward: an output of ``copy_to``, ``gather_sum``, ``shift`` or
``from_last`` must reach the loss on every rank (a backward that does not
run on one rank leaves the others waiting). ``shift`` and ``from_last``
are built from ``all_gather``, which NCCL and gloo (on CUDA tensors too)
both take: they move ``size`` times the bytes a point-to-point send would.

The masked cross-entropy of both model families is here too
(``masked_ce``): its sums run over the ranks of a mesh, its softmax over
the vocab slices of ``model``.

Under ``torch.no_grad()`` (serving) ``copy_to`` is the identity and
``reduce_from`` one in-place all-reduce, with no autograd node.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from block_transformer_tpu_torch.parallel import sharding


def all_reduce_(t: torch.Tensor, groups, op=dist.ReduceOp.SUM):
    """All-reduce ``t`` in place over each group in turn (None skipped)."""
    for g in groups:
        if g is not None:
            dist.all_reduce(t, op=op, group=g)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, group, size: int):
    """The ranks' ``t`` joined along ``dim``, in group order (no grad)."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, index, reduce_grad):
        ctx.dim, ctx.group, ctx.index = dim, group, index
        ctx.chunk, ctx.reduce_grad = x.shape[dim], reduce_grad
        return all_gather_cat(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.group)
        g = g.narrow(ctx.dim, ctx.index * ctx.chunk, ctx.chunk)
        return g.contiguous(), None, None, None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.size, ctx.index = group, size, index
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return parts[index - 1] if index > 0 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g) for _ in range(ctx.size)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        out = (parts[ctx.index + 1] if ctx.index < ctx.size - 1
               else torch.zeros_like(g))
        return out, None, None, None


class _FromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.last = group, index == size - 1
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return parts[-1]

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


class Axis(NamedTuple):
    """One mesh axis (or several, flattened) as a rank sees it: its size,
    the rank's index along it, and its process group (None at size 1)."""
    size: int
    index: int
    group: object


ONE = Axis(1, 0, None)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``group`` (None:
    one rank) backward: the input of a column-parallel linear."""
    if group is None or not _needs_grad(x):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, groups) -> torch.Tensor:
    """All-reduce SUM over each of ``groups`` (None skipped) forward,
    identity backward: a row-parallel linear's partial sums, or a loss's
    per-rank sums. Without autograd, ``x`` itself is reduced in place and
    returned."""
    groups = tuple(g for g in groups if g is not None)
    if not groups:
        return x
    if not _needs_grad(x):
        return all_reduce_(x, groups)
    return _ReduceFrom.apply(x, groups)


def gather_from(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` over ``ax``; backward, the
    rank's slice of the gradient (a replicated loss: each rank's gradient
    of the whole is the same)."""
    if ax.group is None:
        return x
    return _Gather.apply(x, dim % x.dim(), ax.group, ax.size, ax.index,
                         False)


def gather_sum(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` over ``ax``; backward, the
    gradients summed over the ranks and the rank's slice kept (a
    reduce-scatter: the loss is the sum of the ranks' parts)."""
    if ax.group is None:
        return x
    return _Gather.apply(x, dim % x.dim(), ax.group, ax.size, ax.index, True)


def shift(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Rank i gets rank i - 1's ``x`` (zeros on rank 0), JAX's
    ``ppermute`` over ``[(i, i + 1)]``; backward, the reverse shift."""
    if ax.group is None:
        return torch.zeros_like(x)
    return _Shift.apply(x, ax.group, ax.size, ax.index)


def from_last(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The last rank's ``x`` on every rank of ``ax``; backward, every
    rank's gradient summed onto the last rank (zeros elsewhere)."""
    if ax.group is None:
        return x
    return _FromLast.apply(x, ax.group, ax.size, ax.index)


class TrainAxes(NamedTuple):
    """A rank's axes on a training mesh: ``model``, ``seq`` and ``pipe``
    (``ONE`` where the mesh has none), and ``loss``: the data axes and
    ``seq`` of more than one rank, over which the loss's sums are added up;
    ``loss_groups`` their process groups."""
    model: Axis
    seq: Axis
    pipe: Axis
    loss: tuple

    @property
    def loss_groups(self) -> tuple:
        return tuple(a.group for a in self.loss)


def axis(mesh, axes) -> Axis:
    """``Axis`` of ``axes`` (a name or a tuple of names, flattened) on
    ``mesh``; names the mesh lacks count as size 1."""
    axes = tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                 if a in mesh.mesh_dim_names)
    if not axes:
        return ONE
    index, size = sharding.shard_index(mesh, axes)
    return Axis(size, index, sharding.axes_group(mesh, axes))


def train_axes(mesh=None) -> Optional[TrainAxes]:
    """``TrainAxes`` of ``mesh`` (the ambient mesh by default; kept on the
    mesh), or None off a mesh."""
    mesh = sharding.current_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    if "_train_axes" not in mesh.__dict__:
        loss = tuple(axis(mesh, a) for a in sharding.data_axes(mesh)
                     + ("seq",) * ("seq" in mesh.mesh_dim_names))
        mesh.__dict__["_train_axes"] = TrainAxes(
            axis(mesh, "model"), axis(mesh, "seq"), axis(mesh, "pipe"),
            tuple(a for a in loss if a.size > 1))
    return mesh.__dict__["_train_axes"]


def vocab_log_likelihood(logits: torch.Tensor, labels: torch.Tensor,
                         model: Axis) -> torch.Tensor:
    """log p(label) of each row of ``logits`` [.., V_local], float32: the
    rank's vocab slice over ``model`` (its first index ``model.index *
    V_local``; the whole vocab on one rank). Over ``model``: the max by an
    all-reduce MAX (no gradient: the result does not depend on it), then
    the sum of exponentials and the label's logit by one ``reduce_from``.
    Labels below 0 read index 0 (their weight is 0)."""
    labels = labels.clamp(min=0).long()[..., None]
    if model.group is None:
        return torch.log_softmax(logits, dim=-1).gather(-1, labels)[..., 0]
    v = logits.shape[-1]
    m = all_reduce_(logits.detach().amax(-1), [model.group],
                    dist.ReduceOp.MAX)
    sumexp = torch.exp(logits - m[..., None]).sum(-1)
    local = labels - model.index * v
    here = (local >= 0) & (local < v)
    picked = logits.gather(-1, local.clamp(0, v - 1)) * here
    both = reduce_from(torch.stack([sumexp, picked[..., 0]]), (model.group,))
    return both[1] - m - torch.log(both[0])


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              weight: torch.Tensor) -> tuple:
    """The masked token cross-entropy of both model families: logits [R, L,
    V] float32, labels [R, L], weight [R, L] float32 (0 = excluded).
    Returns (the weighted mean, the mean by position [L]). Inside
    ``sharding.set_mesh`` the sums of the CE and of the weights run over
    every rank's rows (``TrainAxes.loss``), so the loss is the mean over
    the whole batch, not a mean of the ranks' means, and over ``model``
    the logits are the rank's vocab slice (``vocab_log_likelihood``)."""
    ax = train_axes()
    model, groups = (ONE, ()) if ax is None else (ax.model, ax.loss_groups)
    ce = -vocab_log_likelihood(logits, labels, model) * weight
    sums = reduce_from(torch.cat([ce.sum()[None], ce.sum(0)]), groups)
    counts = all_reduce_(torch.cat([weight.sum()[None], weight.sum(0)]),
                         groups)
    means = sums / counts.clamp(min=1.0)
    return means[0], means[1:]
