"""Mesh construction and parameter sharding rules (port of
``block_transformer_tpu/parallel/sharding.py``).

One mesh ``(data, model)``: the batch on ``data``, tensor-parallel weight
shards on ``model``. The mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` over the ranks of the default process group, one rank a
device; its dimension names are JAX's axis names. Where JAX places a global
array onto devices, every rank here holds the whole (host) tree and keeps
its own shard of each leaf (``shard_params``): a contiguous copy of the
rank's slice, as the hand kernels take only contiguous, 16-byte-aligned
operands.

The ambient mesh (``set_mesh``, JAX's ``jax.sharding.set_mesh``) tells the
model code it runs as one rank's program of a training mesh: the loss
sums, the vocab-sharded LM head and the sequence axis read it
(``parallel/collectives.py``).

The TP layout is the Megatron split as partition specs: column-parallel
QKV / MLP-up (output dim on ``model``), row-parallel out / down (input dim
on ``model``), vocab-sharded LM head; embedding tables replicated; the
global block-level KV cache sharded on heads over ``model``. A spec (``P``)
gives each dimension of a leaf one axis name, a tuple of axis names (the
dimension split over their product, the first axis outermost) or None
(replicated), as JAX's ``PartitionSpec``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard


class P(tuple):
    """A partition spec: one entry a dimension (axis name, tuple of axis
    names, or None); trailing dimensions not named are replicated. A tuple
    of one name is that name, as in JAX."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"

    def __getnewargs__(self):          # pickled as P(*parts)
        return tuple(self)


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              devices=None, n_dcn: Optional[int] = None,
              n_seq: Optional[int] = None, *, device="cuda") -> DeviceMesh:
    """The (data, model) mesh over ``devices`` (ranks of the default process
    group; all of them by default), with JAX's axis tables and defaults
    (``mesh_shape``). ``device`` is the device type each rank runs on
    ("cuda" or "cpu"). Without a process group, one is made from the
    environment (``env://``): NCCL on "cuda", gloo on "cpu"."""
    devices = _ranks(devices, device)
    shape, names = mesh_shape(len(devices), n_data, n_model, n_dcn, n_seq)
    return named_mesh(shape, names, devices, device=device)


def _ranks(devices, device) -> list:
    """``devices`` as a list of ranks (all of the default group's by
    default), the group made from the environment if there is none."""
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo")
    return (list(range(dist.get_world_size())) if devices is None
            else list(devices))


def mesh_shape(n: int, n_data: Optional[int] = None,
               n_model: Optional[int] = None, n_dcn: Optional[int] = None,
               n_seq: Optional[int] = None) -> tuple:
    """(shape, axis names) of ``make_mesh`` over ``n`` devices: (data,
    model) by default, with the model axis min(4, n) when neither size is
    given; ``n_dcn`` gives (dcn, data, model), the batch over dcn x data;
    ``n_seq`` gives (data, seq, model)."""
    if n_seq:
        if n_dcn:
            raise ValueError("combine seq with dcn by extending this table")
        n_model = n_model or 1
        n_data = n_data or n // (n_seq * n_model)
        shape, names = (n_data, n_seq, n_model), ("data", "seq", "model")
    elif n_dcn:
        n_per = n // n_dcn
        if n_dcn * n_per != n:
            raise ValueError(f"n_dcn {n_dcn} does not divide {n} devices")
        if n_model is None:
            n_model = 1 if n_per == 1 else min(4, n_per)
        if n_data is None:
            n_data = n_per // n_model
        shape, names = (n_dcn, n_data, n_model), ("dcn", "data", "model")
    else:
        if n_data is None and n_model is None:
            n_model = 1 if n == 1 else min(4, n)
            n_data = n // n_model
        elif n_data is None:
            n_data = n // n_model
        elif n_model is None:
            n_model = n // n_data
        shape, names = (n_data, n_model), ("data", "model")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} does not hold "
                         f"{n} devices")
    return shape, names


def data_axes(mesh: DeviceMesh) -> tuple:
    """Every mesh axis that shards the batch (all but ``model`` and the
    activation-structure axes ``seq`` / ``pipe``)."""
    return tuple(a for a in mesh.mesh_dim_names
                 if a not in ("model", "seq", "pipe"))


def seq_constraint(x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
    """JAX constrains ``x``'s sequence dimension onto the ambient mesh's
    ``seq`` axis (and dim 0 onto the data axes), so that GSPMD keeps the
    block decoder's activations sharded between attention layers. A rank's
    program here holds every activation as its own block already: the
    batch arrives split over the data axes and, on a mesh with a ``seq``
    axis, its block axis split into one contiguous chunk a ``seq`` rank
    (``batch_pspec``). So the constraint holds by construction and ``x``
    comes back as it is; what keeps the chunks apart is the block
    decoder's attention, which all-gathers K/V over ``seq`` (its backward a
    reduce-scatter), and the one-block halo of the shift to the token
    decoder (``train/train_step.py``, ``models/block_transformer.py``).
    Off an ambient mesh with such an axis it is JAX's no-op."""
    del seq_dim
    return x


_MESH: contextvars.ContextVar = contextvars.ContextVar("bt_mesh",
                                                      default=None)


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh):
    """Run the code inside as this rank's program of a training mesh (JAX's
    ``jax.sharding.set_mesh``): ``current_mesh()`` returns ``mesh``."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh() -> Optional[DeviceMesh]:
    """The mesh of the innermost ``set_mesh``, or None."""
    return _MESH.get()


def named_mesh(shape: tuple, names: tuple, devices=None, *,
               device="cuda") -> DeviceMesh:
    """A mesh of any axis names over ``devices`` (ranks of the default
    process group; all of them by default), as JAX's ``Mesh(devices.
    reshape(shape), names)``: e.g. ``(data, pipe)`` for the pipeline."""
    devices = _ranks(devices, device)
    if int(np.prod(shape)) != len(devices) or len(shape) != len(names):
        raise ValueError(f"mesh {dict(zip(names, shape))} does not hold "
                         f"{len(devices)} devices")
    ranks = torch.tensor(devices, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(torch.device(device).type, ranks,
                      mesh_dim_names=tuple(names))


def axes_group(mesh: DeviceMesh, axes: tuple):
    """The process group of the ranks that share this rank's coordinates on
    every axis but ``axes``, ordered by their index over ``axes`` flattened
    (first axis outermost, as ``shard_index``); None when ``axes`` hold
    one rank. More than one axis makes a group for every such set of ranks
    (kept on the mesh), a collective call: every rank makes the same calls
    in the same order."""
    axes = tuple(axes)
    if shard_index(mesh, axes)[1] == 1:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_flattened_groups", {})
    if axes not in groups:
        dims = [mesh.mesh_dim_names.index(a) for a in axes]
        rest = [d for d in range(mesh.ndim) if d not in dims]
        t = mesh.mesh.permute(*rest, *dims).reshape(
            -1, int(np.prod([mesh.shape[d] for d in dims])))
        groups[axes], _ = dist.new_subgroups_by_enumeration(
            [[int(r) for r in row] for row in t])
    return groups[axes]


# ---------------------------------------------------------------------------
# Parameter partition specs by path pattern
# ---------------------------------------------------------------------------

def _neox_pspec(path_tail: tuple, ndim: int = None) -> P:
    """Rules for one neox stack (``layers`` leaves carry the stacked layer
    axis first). ``kernel_q8`` / ``kernel_q4`` follow their float kernel's
    spec; a linear's ``scale`` shards on ``model`` exactly when its kernel
    is column-parallel, else it is replicated (row-parallel partial sums
    are scaled after the reduction)."""
    if path_tail and path_tail[-1] in ("kernel_q8", "kernel_q4"):
        path_tail = path_tail[:-1] + ("kernel",)
    elif path_tail and path_tail[-1] == "scale" and len(path_tail) > 1 \
            and path_tail[-2] in ("qkv", "out", "up", "down", "embed_out",
                                  "expansion"):
        base = _neox_pspec(path_tail[:-1] + ("kernel",))
        n = ndim if ndim is not None else len(base)
        last = "model" if base[-1] == "model" else None
        return P(*([None] * (n - 1) + [last]))
    rules = {
        "layers/attn/qkv/kernel": P(None, None, "model"),
        "layers/attn/qkv/bias": P(None, "model"),
        "layers/attn/out/kernel": P(None, "model", None),
        "layers/attn/out/bias": P(None),
        "layers/mlp/up/kernel": P(None, None, "model"),
        "layers/mlp/up/bias": P(None, "model"),
        "layers/mlp/down/kernel": P(None, "model", None),
        "layers/mlp/down/bias": P(None),
        "layers/ln1/scale": P(None), "layers/ln1/bias": P(None),
        "layers/ln2/scale": P(None), "layers/ln2/bias": P(None),
        "final_ln/scale": P(None), "final_ln/bias": P(None),
        "embed_in/weight": P(None, None),
        "embed_out/kernel": P(None, "model"),
        "expansion/kernel": P(None, "model"),
        "expansion/bias": P("model"),
    }
    return rules["/".join(path_tail)]


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts; ``path`` a tuple of keys."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(params) -> dict:
    """Partition-spec tree for a block-transformer or vanilla param tree."""

    def spec(names, leaf):
        if names[0] == "embedder":
            if names[-2:] == ("embeddings", "weight"):
                return P(None, None)
            if names[-2:] == ("projection", "kernel"):
                return P(None, None, None)
            return P(None)
        if names[0] in ("block_decoder", "token_decoder"):
            names = names[1:]
        return _neox_pspec(names, ndim=getattr(leaf, "ndim", None))

    return map_with_path(spec, params)


def placements(mesh: DeviceMesh, spec: P) -> tuple:
    """A spec as DTensor placements, one a mesh axis: ``Shard(dim)`` on each
    axis that splits dimension ``dim``, ``Replicate()`` on the others."""
    out = [Replicate()] * mesh.ndim
    for dim, part in enumerate(spec):
        for name in (part if isinstance(part, tuple) else (part,)):
            if name is not None:
                out[mesh.mesh_dim_names.index(name)] = Shard(dim)
    return tuple(out)


def param_shardings(mesh: DeviceMesh, params):
    """The tree of ``placements`` of ``param_pspecs``."""
    return map_with_path(lambda _, s: placements(mesh, s),
                         param_pspecs(params))


def batch_pspec(mesh: Optional[DeviceMesh] = None) -> P:
    """Spec for [B, N, ...] batch tensors: B over the data axes, and, when
    the mesh has a ``seq`` axis, the block axis N over ``seq``."""
    if mesh is not None and "seq" in mesh.mesh_dim_names:
        return P(data_axes(mesh), "seq")
    if mesh is not None and "dcn" in mesh.mesh_dim_names:
        return P(("dcn", "data"))
    return P("data")


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_index(mesh: DeviceMesh, axes) -> tuple:
    """(this rank's index over ``axes`` flattened, first axis outermost;
    their size product)."""
    coord = mesh.get_coordinate()
    idx, size = 0, 1
    for a in axes:
        d = mesh.mesh_dim_names.index(a)
        idx, size = idx * mesh.shape[d] + coord[d], size * mesh.shape[d]
    return idx, size


def local_shard(mesh: DeviceMesh, t: torch.Tensor, spec: P,
                device=None) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, on ``device`` (the mesh's
    by default): a contiguous copy where ``t`` is split, ``t`` itself (moved
    if need be) where it is replicated."""
    device = mesh_device(mesh) if device is None else torch.device(device)
    out = t
    for dim, part in enumerate(spec):
        if part is None:
            continue
        idx, size = shard_index(mesh, part if isinstance(part, tuple)
                                else (part,))
        if size == 1:
            continue
        if t.shape[dim] % size:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split over {size} shards")
        step = t.shape[dim] // size
        out = out.narrow(dim, idx * step, step)
    if out is t:
        return t.to(device)
    return out.to(device, copy=out.device == device,
                  memory_format=torch.contiguous_format)


def local_shards(mesh: DeviceMesh, params, specs, device=None):
    """``local_shard`` of every leaf of ``params`` under the spec tree
    ``specs``."""
    return map_with_path(
        lambda path, t: local_shard(mesh, t, _at(specs, path), device),
        params)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def shard_params(mesh: DeviceMesh, params):
    """This rank's shards of a (host or device) param tree under
    ``param_pspecs``, on the mesh's device."""
    return local_shards(mesh, params, param_pspecs(params))


def kv_cache_pspec() -> P:
    """[layers, batch, heads, capacity, head_dim]: batch on data, heads on
    model."""
    return P(None, "data", "model", None, None)
