"""The train step (port of ``block_transformer_tpu/train/train_step.py``:
``TrainState``, ``make_loss_fn``, ``make_train_step``,
``create_train_state``, ``make_grad_and_apply``, the single-device form of
``make_sharded_grad_and_apply`` for gradient accumulation, and the steps
over a mesh: ``make_sharded_train_step``, ``make_sharded_grad_and_apply``,
``shard_state``, ``_opt_state_pspecs``).

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

Over a mesh (``parallel.sharding.make_mesh``: data axes, ``seq``,
``model``; ``parallel/pipeline.py`` adds ``pipe``) each rank is one
process that holds its shards of the state (``shard_state``) and runs the
same step on its rows of the batch, the collectives placed by hand where
JAX leaves them to GSPMD (``parallel/collectives.py``):

- the batch (the global one, as JAX's jitted step takes it) is cut to the
  rank's block by ``sharding.batch_pspec``; the loss is the masked mean
  over the whole batch (``models/block_transformer.py``);
- ``model``: Megatron's column / row splits by ``param_pspecs`` (the
  layers' own code, ``parallel/tp_decode.py``'s ``_tp_finish``), the
  vocab-sharded LM head reduced inside the cross-entropy, the
  column-sharded expansion layer all-gathered where it is used. A rank's
  QKV columns are its heads' q, k and v: each stack's QKV leaves (and their
  moments) are held with their columns in shard-major order, (3, tp,
  h/tp) -> (tp, 3, h/tp), which needs no head count, so each rank holds
  JAX's shard size, and ``gather_state`` gives them back in JAX's order;
- ``seq``: a rank holds a contiguous chunk of blocks; the block decoder's
  attention all-gathers K / V over ``seq`` (its backward a reduce-scatter)
  with the chunk's global block indices and RoPE positions;
- a gradient is summed over the axes (but ``model``) its parameter is
  replicated on, once a step (``apply_fn``); its global norm adds each
  leaf's square sum over the axes the leaf is split on;
- ZeRO: the Adam moments are placed as ``_opt_state_pspecs`` says, JAX's
  rule with its quirks. A moment split where its parameter is not (a
  replicated parameter's moments over the axes but ``model``) is updated
  on the rank's slice, and the parameter's new slices are all-gathered.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from block_transformer_tpu_torch.config import BlockTransformerConfig
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import masks
from block_transformer_tpu_torch.parallel import collectives
from block_transformer_tpu_torch.parallel import sharding
from block_transformer_tpu_torch.parallel.sharding import P
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
    return _loss_fn(cfg, remat, param_transform)


def _loss_fn(cfg: BlockTransformerConfig, remat: bool, param_transform=None,
             block_decoder_fn=None, token_decoder_stack_fn=None):
    """``make_loss_fn`` with the forward's two stack hooks."""
    def loss_fn(params, batch):
        if param_transform is not None:
            params = param_transform(params)
        out = bt.block_transformer_forward(
            params, cfg, batch["input_ids"], batch["attention_mask"],
            batch["block_attention_mask"], labels=batch["labels"],
            compute_logits=False, remat=remat,
            block_decoder_fn=block_decoder_fn,
            token_decoder_stack_fn=token_decoder_stack_fn)
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


def _grads(loss_fn, params, batch, scale: float = 1.0):
    """({path: gradient}, detached metrics) of ``loss_fn(params, batch)``
    (its loss times ``scale``), the paths in sorted order. A leaf the loss
    does not reach raises (autograd's error), on one device and on every
    rank of a mesh: each rank's loss reaches every leaf it holds."""
    live = {path: p.detach().requires_grad_(True)
            for path, p in opt.tree_items(params)}
    with torch.enable_grad():
        loss, metrics = loss_fn(opt.tree_unflatten(live), batch)
        got = torch.autograd.grad(loss * scale if scale != 1.0 else loss,
                                  list(live.values()))
    return dict(zip(live, got)), {k: v.detach() for k, v in metrics.items()}


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


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------

BATCH_KEYS = ("input_ids", "attention_mask", "block_attention_mask",
              "labels")


def _names(part) -> tuple:
    """The axis names of one spec entry (a name, a tuple of names, None)."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _spec_axes(spec) -> tuple:
    return tuple(a for part in spec for a in _names(part))


def _dims(spec, ndim: int) -> tuple:
    """A spec as one tuple of axis names a dimension, ``ndim`` long."""
    return tuple(_names(p) for p in spec) + ((),) * (ndim - len(spec))


def _opt_state_pspecs(tx, params, pspecs, mesh=None):
    """Partition specs of the optimizer state (ZeRO), JAX's rule exactly:
    a moment leaf takes the spec of the FIRST parameter of its (shape,
    dtype), in sorted path order; if that spec names no axis (a replicated
    parameter: embedding tables, layer norms, biases), the moment is split
    over every mesh axis but ``model`` (``seq`` and ``pipe`` included),
    flattened, on the FIRST dimension that the product divides. The count
    is replicated. Returns an ``AdamWState`` of specs (``tx`` is taken for
    JAX's signature: the port's AdamW state has one form)."""
    del tx
    shape_to_spec = {}
    for path, leaf in opt.tree_items(params):
        spec = sharding._at(pspecs, path)
        shape_to_spec.setdefault((tuple(leaf.shape), leaf.dtype), spec)
    if mesh is not None:
        data_ax = tuple(a for a in mesh.mesh_dim_names if a != "model")
        n_data = int(np.prod([mesh.shape[mesh.mesh_dim_names.index(a)]
                              for a in data_ax]))
        data_name = data_ax[0] if len(data_ax) == 1 else data_ax
    else:
        n_data, data_name = 1, None

    def zero_shard(shape, spec):
        if any(s is not None for s in spec):
            return spec                      # split already
        if n_data <= 1 or not shape:
            return spec
        for axis, dim in enumerate(shape):
            if dim % n_data == 0 and dim >= n_data:
                names = [None] * len(shape)
                names[axis] = data_name
                return P(*names)
        return spec

    def spec_for(leaf):
        key = (tuple(leaf.shape), leaf.dtype)
        if key in shape_to_spec:
            return zero_shard(tuple(leaf.shape), shape_to_spec[key])
        return P(*([None] * leaf.dim()))

    moments = opt.tree_map(spec_for, params)
    return opt.AdamWState(P(), moments, opt.tree_map(lambda s: s, moments))


def _is_qkv(path: tuple) -> bool:
    return len(path) >= 4 and path[-4] == "layers" and path[-3:-1] == (
        "attn", "qkv")


def _qkv_perm(width: int, tp: int, device) -> torch.Tensor:
    """Columns (q|k|v, tp, h/tp) -> (tp, q|k|v, h/tp): each contiguous
    3h/tp chunk holds one shard's heads' q, then k, then v."""
    idx = np.arange(width).reshape(3, tp, width // (3 * tp))
    return torch.from_numpy(idx.transpose(1, 0, 2).reshape(-1)).to(device)


class _Layout(NamedTuple):
    """Where every leaf lives on the mesh: the parameters' and moments'
    specs by path, the model-axis size ``tp`` (QKV held shard-major when
    > 1), and by path the process groups a gradient is summed over."""
    mesh: Any
    pspecs: dict
    mspecs: dict
    tp: int
    reduce: dict


def _layout(mesh, state_spec) -> _Layout:
    names = mesh.mesh_dim_names
    pspecs = dict(opt.tree_items(state_spec.params))
    mspecs = dict(opt.tree_items(state_spec.opt_state.mu))
    tp = collectives.axis(mesh, "model").size
    reduce = {}
    for path, spec in pspecs.items():
        held = set(_spec_axes(spec))
        reduce[path] = tuple(collectives.axis(mesh, a).group for a in names
                             if a != "model" and a not in held
                             and collectives.axis(mesh, a).size > 1)
    # every group a gather may need, made now in one order on every rank
    for spec in (*pspecs.values(), *mspecs.values()):
        for part in spec:
            collectives.axis(mesh, _names(part))
    return _Layout(mesh, pspecs, mspecs, tp, reduce)


def _state_spec(mesh, params, pspecs=None) -> TrainState:
    pspecs = sharding.param_pspecs(params) if pspecs is None else pspecs
    return TrainState(pspecs, _opt_state_pspecs(None, params, pspecs, mesh),
                      P())


def _place(layout: _Layout, path, t: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of the full leaf ``t`` (QKV made shard-major
    first)."""
    if layout.tp > 1 and _is_qkv(path):
        t = t.index_select(-1, _qkv_perm(t.shape[-1], layout.tp, t.device))
    return sharding.local_shard(layout.mesh, t, spec)


def _gather(layout: _Layout, t: torch.Tensor, spec) -> torch.Tensor:
    """The full leaf from the ranks' blocks ``t`` under ``spec`` (in the
    held order: QKV stays shard-major)."""
    for dim, part in enumerate(spec):
        if _names(part):
            ax = collectives.axis(layout.mesh, _names(part))
            t = collectives.all_gather_cat(t, dim, ax.group, ax.size)
    return t


def _unplace(layout: _Layout, path, t: torch.Tensor, spec) -> torch.Tensor:
    t = _gather(layout, t, spec)
    if layout.tp > 1 and _is_qkv(path):
        perm = _qkv_perm(t.shape[-1], layout.tp, t.device)
        t = t.index_select(-1, torch.argsort(perm))
    return t


def shard_with(mesh, state: TrainState, state_spec: TrainState
               ) -> TrainState:
    """This rank's shards of a full ``state`` under ``state_spec`` (a
    ``TrainState`` of spec trees, as ``pipeline.make_pp_train_step``
    returns), on the mesh's device."""
    layout = _layout(mesh, state_spec)
    o = state.opt_state

    def place(tree, specs):
        return opt.tree_unflatten({
            path: _place(layout, path, t, specs[path])
            for path, t in opt.tree_items(tree)})

    params = place(state.params, layout.pspecs)
    if o is not None:
        o = opt.AdamWState(o.count, place(o.mu, layout.mspecs),
                           place(o.nu, layout.mspecs))
    return TrainState(params, o, state.step)


def gather_state(mesh, state: TrainState, state_spec: TrainState,
                 to_host: bool = False):
    """The full state (JAX's layout) from the ranks' shards: a collective,
    every rank gets it (what a one-device run holds). ``to_host`` (what a
    checkpoint saves): leaf by leaf, rank 0 keeps each full leaf in host
    memory and the other ranks drop theirs, so that no device holds more
    than one full leaf at a time; the other ranks get None."""
    layout = _layout(mesh, state_spec)
    keep = not to_host or dist.get_rank() == 0
    o = state.opt_state

    def full(tree, specs):
        out = {}
        for path, t in opt.tree_items(tree):
            f = _unplace(layout, path, t, specs[path])
            if keep:
                out[path] = f.cpu() if to_host else f
        return opt.tree_unflatten(out)

    params = full(state.params, layout.pspecs)
    if o is not None:
        o = opt.AdamWState(o.count, full(o.mu, layout.mspecs),
                           full(o.nu, layout.mspecs))
    return TrainState(params, o, state.step) if keep else None


def empty_full_state(mesh, state: TrainState, state_spec: TrainState,
                     device="cpu") -> TrainState:
    """Uninitialised tensors of the full state's shapes and dtypes on
    ``device``, from the rank's shards ``state`` and no collective: the
    template a checkpoint restores into (``restore_checkpoint``'s
    ``like``)."""
    layout = _layout(mesh, state_spec)

    def empty(tree, specs):
        def one(path, t):
            shape = [n * collectives.axis(mesh, names).size
                     for n, names in zip(t.shape, _dims(specs[path], t.dim()))]
            return torch.empty(shape, dtype=t.dtype, device=device)
        return opt.tree_unflatten({path: one(path, t)
                                   for path, t in opt.tree_items(tree)})

    o = state.opt_state
    if o is not None:
        o = opt.AdamWState(o.count, empty(o.mu, layout.mspecs),
                           empty(o.nu, layout.mspecs))
    return TrainState(empty(state.params, layout.pspecs), o, state.step)


def shard_state(mesh, tx, state: TrainState) -> TrainState:
    """This rank's shards of the full ``state``: the parameters by
    ``param_pspecs``, the moments by ``_opt_state_pspecs``."""
    del tx
    return shard_with(mesh, state, _state_spec(mesh, state.params))


def _local_batch(mesh, batch, spec, keys=BATCH_KEYS) -> dict:
    """The rank's block of the global batch (numpy or tensors) under
    ``spec``, on the mesh's device."""
    out = {}
    for k in keys:
        t = batch[k]
        t = t if isinstance(t, torch.Tensor) else torch.from_numpy(
            np.asarray(t))
        out[k] = sharding.local_shard(mesh, t, spec)
    return out


def _reduce_grads(layout: _Layout, grads: dict) -> None:
    """Sum each gradient over the axes its parameter is replicated on (but
    ``model``), in place."""
    for path, g in grads.items():
        collectives.all_reduce_(g, layout.reduce[path])


def _global_norm(layout: _Layout, grads: dict) -> torch.Tensor:
    """The norm of the whole gradient: each leaf's square sum (optax's
    order within a rank), added over the axes of more than one rank its
    parameter is split on. Leaves split over the same such axes are
    summed together first, so on a mesh of one rank the sum is optax's,
    bit for bit."""
    by_axes = {}
    for path, g in grads.items():
        axes = tuple(a for a in _spec_axes(layout.pspecs[path])
                     if collectives.axis(layout.mesh, a).size > 1)
        by_axes[axes] = by_axes.get(axes, 0) + torch.sum(g * g)
    total = 0
    for axes, s in sorted(by_axes.items()):
        s = s.float().reshape(1)
        collectives.all_reduce_(s, [collectives.axis(layout.mesh, a).group
                                    for a in axes])
        total = total + s[0]
    return torch.sqrt(total)


@torch.no_grad()
def _apply_sharded(layout: _Layout, tx, state: TrainState, grads: dict):
    """The optimizer's step on the rank's shards, the gradients reduced
    already; the parameters updated in place. Returns (new optimizer
    state, the gradients' global norm)."""
    norm = _global_norm(layout, grads)
    o = state.opt_state
    step = tx.step_scalars(o.count, norm)
    decay = opt._decay_mask(state.params)
    mu, nu = dict(opt.tree_items(o.mu)), dict(opt.tree_items(o.nu))
    params = dict(opt.tree_items(state.params))
    for path, g in grads.items():
        p, ps, ms = params[path], layout.pspecs[path], layout.mspecs[path]
        if _dims(ps, p.dim()) == _dims(ms, p.dim()):
            m, v, u = tx.leaf_update(step, g, mu.pop(path), nu.pop(path), p,
                                     decay[path])
            p.add_(u.to(p.dtype))
        else:
            # the moment's block: the rank's slice of the parameter
            full_p, full_g = _gather(layout, p, ps), _gather(layout, g, ps)
            p_r = sharding.local_shard(layout.mesh, full_p, ms, p.device)
            g_r = sharding.local_shard(layout.mesh, full_g, ms, p.device)
            m, v, u = tx.leaf_update(step, g_r, mu.pop(path), nu.pop(path),
                                     p_r, decay[path])
            new = _gather(layout, p_r + u.to(p.dtype), ms)
            p.copy_(sharding.local_shard(layout.mesh, new, ps, p.device))
        opt._set_leaf(o.mu, path, m)
        opt._set_leaf(o.nu, path, v)
    return opt.AdamWState(o.count + 1, o.mu, o.nu), norm


def _tp_parts(mesh):
    """(qkv, finish): a GPT-NeoX layer's halves on the rank's shards over
    ``model`` (the plain halves at tp = 1); ``qkv`` all-gathers K / V over
    its ``kv_axis`` (``collectives.ONE``: none)."""
    from block_transformer_tpu_torch.parallel import tp_decode
    model = collectives.train_axes(mesh).model

    def qkv(p, x, *, cfg, cos, sin, positions, kv_axis):
        if model.group is None:
            q, k, v = neox.layer_qkv(p, x, cfg=cfg, cos=cos, sin=sin,
                                     positions=positions)
        else:
            # the column-parallel QKV of the rank's heads (shard-major
            # columns: q, k, v of H/tp heads)
            B, S, H, D = x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim
            attn_in = collectives.copy_to(
                neox.layer_norm(x, p["ln1"], cfg.layer_norm_eps),
                model.group)
            qkv_ = linear_ops.apply_linear(attn_in, p["attn"]["qkv"])
            qkv_ = qkv_.reshape(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
            q = neox.apply_rope(qkv_[0], cos, sin, positions)
            k = neox.apply_rope(qkv_[1], cos, sin, positions)
            v = qkv_[2]
        return (q, collectives.gather_sum(k, 2, kv_axis),
                collectives.gather_sum(v, 2, kv_axis))

    finish = (functools.partial(tp_decode._tp_finish, group=model.group)
              if model.group is not None else neox.layer_finish)
    return qkv, finish


def _local_cfg(mesh, ncfg):
    """``ncfg`` with its hidden size, heads and FFN divided over
    ``model``; the stack must be the parallel-residual GPT-NeoX layout."""
    from block_transformer_tpu_torch.parallel import tp_decode
    tp = collectives.train_axes(mesh).model.size
    if tp == 1:
        return ncfg
    if not ncfg.use_parallel_residual:
        raise NotImplementedError("tensor-parallel training implements the "
                                  "parallel-residual (Pythia) layout")
    if ncfg.vocab_size % tp:
        raise ValueError(f"vocab {ncfg.vocab_size} does not split over "
                         f"tp={tp}")
    return tp_decode._local_cfg(ncfg, tp)


def _tp_stack_fn(mesh, ncfg, remat: bool):
    """``stack_fn(params, x, mask, positions)`` of a GPT-NeoX stack on the
    rank's shards over ``model``, final-normed, its output entering the
    column-parallel LM head (``collectives.copy_to``); None (the plain
    stack) off a mesh or on one without a ``model`` axis."""
    if mesh is None or collectives.train_axes(mesh).model.group is None:
        return None
    qkv, finish = _tp_parts(mesh)
    lcfg = _local_cfg(mesh, ncfg)
    model = collectives.train_axes(mesh).model

    def stack_fn(params, x, mask, positions):
        h, _ = neox._stack(params, x, cfg=lcfg, mask=mask,
                           positions=positions, remat=remat,
                           qkv=functools.partial(qkv,
                                                 kv_axis=collectives.ONE),
                           finish=finish)
        return collectives.copy_to(h, model.group)

    return stack_fn


def _mesh_stacks(mesh, cfg: BlockTransformerConfig, remat: bool):
    """(block_decoder_fn, token_decoder_stack_fn) of a rank on ``mesh``:
    the GPT-NeoX stacks on the rank's shards over ``model`` (its heads and
    FFN slice, one all-reduce forward a layer) and, for the block decoder,
    its chunk of blocks over ``seq``. (None, None) on a mesh with neither."""
    ax = collectives.train_axes(mesh)
    model, seq = ax.model, ax.seq
    if model.group is None and seq.group is None:
        return None, None
    tcfg = cfg.token_decoder
    if cfg.block_decoder_cls != "gpt-neo-x" or (
            model.group is not None and tcfg.cls != "gpt-neo-x"):
        raise NotImplementedError("mesh training runs GPT-NeoX stacks")
    qkv, finish = _tp_parts(mesh)

    def block_decoder_fn(params, bcfg, inputs_embeds, block_attention_mask,
                         n_embedding_tokens, remat=False, cls="gpt-neo-x",
                         window=256):
        if cls != "gpt-neo-x":
            raise NotImplementedError("mesh training runs GPT-NeoX stacks")
        n = n_embedding_tokens
        Sc = inputs_embeds.shape[1]
        ar = functools.partial(torch.arange, dtype=torch.int32,
                               device=inputs_embeds.device)
        # the chunk's global block indices and positions; every chunk's
        # keys (K / V gathered over seq in ``qkv``)
        off = seq.index * Sc
        kv_valid = collectives.all_gather_cat(
            block_attention_mask, 1, seq.group, seq.size).repeat_interleave(
                n, dim=1)
        mask = masks.AttnMask((off + ar(Sc)) // n, ar(Sc * seq.size) // n,
                              kv_valid)
        hidden, _ = neox._stack(
            params, inputs_embeds, cfg=_local_cfg(mesh, bcfg), mask=mask,
            positions=off + ar(Sc), remat=remat,
            qkv=functools.partial(qkv, kv_axis=seq), finish=finish)
        return hidden

    return block_decoder_fn, _tp_stack_fn(mesh, tcfg.neox, remat)


def _gathered_expansion(params, model: collectives.Axis):
    """The token decoder's column-sharded expansion layer, gathered whole
    (``collectives.gather_from``) where the forward uses it."""
    td = params["token_decoder"]
    if model.group is None or "expansion" not in td:
        return params
    exp = {k: collectives.gather_from(v, -1, model)
           for k, v in td["expansion"].items()}
    return {**params, "token_decoder": {**td, "expansion": exp}}


@contextlib.contextmanager
def mesh_program(mesh):
    """Run the code inside as a rank's program on ``mesh``
    (``sharding.set_mesh``, and ``linear_ops.sharded_program``); nothing
    off a mesh (``mesh`` None)."""
    if mesh is None:
        yield
        return
    with sharding.set_mesh(mesh), linear_ops.sharded_program():
        yield


def _mesh_loss_fn(mesh, cfg: BlockTransformerConfig, remat: bool,
                  block_decoder_fn=None, token_decoder_stack_fn=None):
    """A rank's loss function on ``mesh``: the forward on its shards and
    rows, under ``set_mesh``; the stacks default to ``_mesh_stacks``."""
    if block_decoder_fn is None and token_decoder_stack_fn is None:
        block_decoder_fn, token_decoder_stack_fn = _mesh_stacks(mesh, cfg,
                                                                remat)
    inner = _loss_fn(cfg, remat, block_decoder_fn=block_decoder_fn,
                     token_decoder_stack_fn=token_decoder_stack_fn)
    model = collectives.train_axes(mesh).model

    def loss_fn(params, batch):
        with mesh_program(mesh):
            return inner(_gathered_expansion(params, model), batch)

    return loss_fn


def _mesh_step(mesh, tx, state_spec, loss_fn, scale: float = 1.0):
    """``make_sharded_train_step``'s train_step (and the pipeline's: the
    loss scaled by ``scale`` for the backward)."""
    layout = _layout(mesh, state_spec)
    bspec = sharding.batch_pspec(mesh)

    def train_step(state: TrainState, batch):
        grads, metrics = _grads(loss_fn, state.params,
                                _local_batch(mesh, batch, bspec), scale)
        with torch.no_grad():
            _reduce_grads(layout, grads)
            opt_state, norm = _apply_sharded(layout, tx, state, grads)
        metrics["grad_norm"] = norm
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return train_step


def make_sharded_train_step(mesh, cfg: BlockTransformerConfig, tx,
                            params, remat: bool = True):
    """train_step(state, batch) -> (state, metrics) of one rank on
    ``mesh``: ``state`` is the rank's shards (``shard_state``), ``batch``
    the global batch (every rank gets the same; each takes its block), the
    metrics those of the whole batch, and ``grad_norm``. ``params``: the
    full tree (its shapes and dtypes place the moments)."""
    return _mesh_step(mesh, tx, _state_spec(mesh, params),
                      _mesh_loss_fn(mesh, cfg, remat))


def make_sharded_grad_and_apply(mesh, cfg: BlockTransformerConfig, tx,
                                params, remat: bool = True):
    """(grad_fn, apply_fn, zeros_fn) of one rank on ``mesh``, for exact
    gradient accumulation, as ``make_grad_and_apply``: ``grad_fn(params,
    batch, acc) -> (acc, metrics)`` adds the gradient of the rank's part of
    the global micro-batch ``batch`` into its float32 ``acc`` (the metrics
    are the whole micro-batch's); ``apply_fn(state, acc, n_accum) ->
    (state, grad_norm)`` sums ``acc`` over the ranks it is replicated on
    (once a step, where JAX reduces each micro-batch's gradients), divides
    by ``n_accum`` and steps the optimizer on the rank's shards;
    ``zeros_fn(params)`` the accumulator of the rank's shards. ``params``:
    the full tree (its shapes and dtypes place the moments)."""
    return grad_and_apply_on(mesh, tx, _state_spec(mesh, params),
                             _mesh_loss_fn(mesh, cfg, remat))


def grad_and_apply_on(mesh, tx, state_spec: TrainState, loss_fn,
                      keys=BATCH_KEYS):
    """``make_sharded_grad_and_apply`` for any rank loss function
    ``loss_fn(params, local_batch) -> (loss, metrics)`` over the batch
    fields ``keys`` (the vanilla trainer's too)."""
    layout = _layout(mesh, state_spec)
    bspec = sharding.batch_pspec(mesh)
    _, _, zeros_fn = make_grad_and_apply(loss_fn, tx)

    def grad_fn(params, batch, acc):
        grads, metrics = _grads(loss_fn, params,
                                _local_batch(mesh, batch, bspec, keys))
        with torch.no_grad():
            for a, g in zip(opt.tree_leaves(acc), grads.values()):
                a.add_(g.to(a.dtype))
        return acc, metrics

    def apply_fn(state: TrainState, acc, n_accum: float):
        with torch.no_grad():
            grads = dict(opt.tree_items(acc))
            _reduce_grads(layout, grads)
            grads = {path: g / n_accum for path, g in grads.items()}
            opt_state, norm = _apply_sharded(layout, tx, state, grads)
        return TrainState(state.params, opt_state, state.step + 1), norm

    return grad_fn, apply_fn, zeros_fn
