"""Tensor-parallel two-level decode on ``torch.distributed`` (port of
``block_transformer_tpu/parallel/tp_decode.py``).

JAX runs these programs under ``jax.shard_map``: every array a per-device
shard, every collective placed by hand. Here every rank of a ``(data,
model)`` mesh (``parallel/sharding.make_mesh``) is one process that runs
the same Python on its own shards, and each JAX collective is one
``torch.distributed`` collective on the mesh's group for its axis:

- QKV / MLP-up are column-parallel (the rank's heads, its slice of the
  FFN), attention-out / MLP-down row-parallel. Their two partial sums share
  ONE all-reduce a layer over ``model``, of ``[B_local, S, hidden]`` (legal
  because GPT-NeoX adds attention and MLP in parallel); the activations are
  never gathered.
- The LM head is vocab-sharded. Greedy and temperature sampling need only
  the global top-1: each rank reduces its slice to (best score, index),
  then an all-reduce MAX of the scores and an all-reduce MIN of the global
  index among the ranks that hold that maximum pick the token, ties going
  to the lowest index (JAX's ``argmax``). Top-k / top-p gather the logits:
  an all-reduce SUM of each rank's slice placed in zeros, which is exact.
- The global block-level KV cache lives sharded over (data: rows, model:
  heads) and is never gathered; the engine's paged pool partitions its
  pages over the data shards.
- The stop flag is all-reduced over the data axes once a block: one host
  sync a block, where the single-device loop reads ``unfinished.any()``.

Every collective is a plain ``all_reduce``, on NCCL and on gloo alike: on
NCCL it is queued on the device like a kernel and the host goes on, on
gloo the host waits for it.

This module builds hooks only (``_decoders``, an ``inference.generate.
Decoders``): the generation loops (``generate._generate``) and the
serving engine's window (``inference/engine.py``) are the single-device
ones, run on a rank's hooks. Its stacks are the single-device stack
(``models/neox._stack``, ``_prefill_fresh``) with its layer's two halves
given (``_tp_layer_qkv``, ``_tp_finish``) and a local ``NeoXConfig`` whose
hidden size, heads and FFN are divided by the model-axis size, so the
hand kernels run on each rank's shards: K1 / K4 on the column and row
slices, K2 on the head-sharded cache, K3 in the fresh prefill, K5 fused
into the decode writes, K6 / K7 on the rank's sub-pool and K8 at its
admission (the stack picks the paged pool's route from the cache it is
given, so JAX's ``_tp_stack_paged`` is the same stack). W8A8 is off inside
these programs (``ops.linear.sharded_program``), as under JAX's
``shard_map``.

``overlap_streams=2`` keeps JAX's schedule, ``TD(A); TD(B); BD(A); BD(B)``
over two half-batch streams, and its numerics (greedy tokens are those of
one stream); the host issues the streams in that order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from block_transformer_tpu_torch.config import (BlockTransformerConfig,
                                                NeoXConfig)
from block_transformer_tpu_torch.inference import generate as gen
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import linear as linear_ops
from block_transformer_tpu_torch.ops import quant
from block_transformer_tpu_torch.ops.linear import StackedLinear
from block_transformer_tpu_torch.parallel import collectives
from block_transformer_tpu_torch.parallel import sharding
from block_transformer_tpu_torch.parallel.sharding import P

# the engine's cache kinds over a mesh
MESH_KINDS = ("bf16", "int8", "paged", "paged-int4")

# ---------------------------------------------------------------------------
# Partition specs of the tensor-parallel programs
# ---------------------------------------------------------------------------

def _neox_tp_spec(tail: str) -> Optional[P]:
    rules = {
        "layers/attn/qkv/kernel": P(None, None, "model"),
        "layers/attn/qkv/bias": P(None, "model"),
        "layers/attn/qkv/kernel_q8": P(None, None, "model"),
        "layers/attn/qkv/kernel_q4": P(None, None, "model"),
        "layers/attn/qkv/scale": P(None, "model"),
        "layers/attn/out/kernel": P(None, "model", None),
        "layers/attn/out/kernel_q8": P(None, "model", None),
        "layers/attn/out/kernel_q4": P(None, "model", None),
        "layers/attn/out/scale": P(None, None),
        "layers/attn/out/bias": P(None, None),
        "layers/mlp/up/kernel": P(None, None, "model"),
        "layers/mlp/up/kernel_q8": P(None, None, "model"),
        "layers/mlp/up/kernel_q4": P(None, None, "model"),
        "layers/mlp/up/scale": P(None, "model"),
        "layers/mlp/up/bias": P(None, "model"),
        "layers/mlp/down/kernel": P(None, "model", None),
        "layers/mlp/down/kernel_q8": P(None, "model", None),
        "layers/mlp/down/kernel_q4": P(None, "model", None),
        "layers/mlp/down/scale": P(None, None),
        "layers/mlp/down/bias": P(None, None),
        "embed_out/kernel": P(None, "model"),
        "embed_out/kernel_q8": P(None, "model"),
        "embed_out/kernel_q4": P(None, "model"),
        "embed_out/scale": P("model",),
    }
    return rules.get(tail)


def tp_param_specs(params: dict):
    """Partition specs of a block-transformer param tree for these programs.

    The embedder, layer norms, row-parallel biases and the expansion layer
    are replicated; the matmul weights shard as in ``_neox_tp_spec``. INT4
    packed kernels shard like their float kernels (the packed axis K/2 is
    still the row axis), but a row-parallel one is shard-valid only after
    ``prepare_tp_params(..., tp=...)`` repacked it. INT4 group scales
    ``[L, G, N]`` (``[G, V]`` for the LM head) shard by role: column-
    parallel on N, row-parallel on G (G == 1 replicates)."""

    def spec(names, leaf):
        if names[0] == "embedder":
            return P()
        tail = "/".join(names[1:])
        ndim = leaf.dim()
        if tail.endswith("/scale") and ndim == 3:      # int4 [L, G, N]
            role = tail.rsplit("/", 2)[-2]
            if role in ("out", "down"):                # row-parallel
                return P(None, "model", None) if leaf.shape[1] > 1 else P()
            if role in ("qkv", "up"):                  # column-parallel
                return P(None, None, "model")
        if tail == "embed_out/scale" and ndim == 2:    # int4 [G, V]
            return P(None, "model")
        s = _neox_tp_spec(tail)
        return P() if s is None else s

    return sharding.map_with_path(spec, params)


def shard_tp_params(mesh, params: dict) -> dict:
    """This rank's shards of a ``prepare_tp_params`` tree under
    ``tp_param_specs``, on the mesh's device."""
    return sharding.local_shards(mesh, params, tp_param_specs(params))


# ---------------------------------------------------------------------------
# Host-side param preparation: head-major QKV layout
# ---------------------------------------------------------------------------

def _qkv_head_major_perm(hidden: int, num_heads: int) -> torch.Tensor:
    """Column permutation (q|k|v, head, d) -> (head, q|k|v, d), so that each
    contiguous 3h/tp chunk of the QKV columns holds the (q, k, v) of H/tp
    whole heads."""
    D = hidden // num_heads
    idx = np.arange(3 * hidden).reshape(3, num_heads, D)
    return torch.from_numpy(idx.transpose(1, 0, 2).reshape(-1))


def _repack_q4_rows_for_tp(w_p: torch.Tensor, tp: int) -> torch.Tensor:
    """Re-lay a split-half packed INT4 kernel [L, K/2, N] so that each of
    ``tp`` contiguous row shards is itself a split-half packing of its own
    K/tp rows: packed row ``j*K/2t + p`` holds shard j's local rows ``p``
    (low nibble) and ``p + K/2t`` (high)."""
    L, Kh, N = w_p.shape
    K = 2 * Kh
    if K % (2 * tp):
        raise ValueError(f"INT4 rows {K} do not split into {tp} packings")
    v = quant.unpack_int4(w_p).to(torch.int32).reshape(L, tp, K // tp, N)
    half = K // (2 * tp)
    packed = (v[:, :, :half] & 0xF) | ((v[:, :, half:] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8).reshape(L, Kh, N)


def prepare_tp_params(params: dict, cfg: BlockTransformerConfig,
                      tp: int = None) -> dict:
    """Permute every stack's QKV node (kernel, quantized kernel, bias,
    scale) to head-major column order, so that ``tp_param_specs``'
    contiguous column shards carry whole heads, and repack row-parallel
    INT4 kernels (attention-out, MLP-down) for ``tp`` shards. ``tp`` (the
    model-axis size) is needed when the tree holds ``kernel_q4`` leaves.
    Returns a new tree; the leaves it does not change are shared."""
    out = dict(params)
    for name, ncfg in (("block_decoder", cfg.block_decoder),
                       ("token_decoder", cfg.token_decoder.neox)):
        if name not in params:
            continue
        stack = dict(params[name])
        layers = dict(stack["layers"])
        attn = dict(layers["attn"])
        qkv = dict(attn["qkv"])
        perm = _qkv_head_major_perm(ncfg.hidden_size, ncfg.num_heads)
        for k in list(qkv):
            qkv[k] = qkv[k].index_select(-1, perm.to(qkv[k].device))
        attn["qkv"] = qkv
        mlp = dict(layers["mlp"])
        for parent, role in ((attn, "out"), (mlp, "down")):
            node = dict(parent[role])
            if "kernel_q4" in node:
                if not tp:
                    raise ValueError("prepare_tp_params needs tp (the model "
                                     "axis size) to repack INT4 kernels")
                G = node["scale"].shape[1] if node["scale"].dim() == 3 else 1
                if G != 1 and G % tp:
                    raise ValueError(f"{name}/{role}: INT4 group count {G} "
                                     f"is not a multiple of tp={tp}")
                node["kernel_q4"] = _repack_q4_rows_for_tp(node["kernel_q4"],
                                                           tp)
                parent[role] = node
        layers["attn"], layers["mlp"] = attn, mlp
        stack["layers"] = layers
        out[name] = stack
    return out


# ---------------------------------------------------------------------------
# The mesh as these programs see it
# ---------------------------------------------------------------------------

class _Axes(NamedTuple):
    """This rank's place in the mesh: the model axis (its size ``tp``, the
    rank's index, its group) and the data axes (every other axis: their
    size product ``dp``, the rank's flattened index, their groups)."""
    tp: int
    model_index: int
    model: object
    dp: int
    data_index: int
    data: tuple
    device: torch.device


def _axes(mesh) -> _Axes:
    names = tuple(mesh.mesh_dim_names)
    d_axes = tuple(a for a in names if a != "model")
    m_index, tp = sharding.shard_index(mesh, ("model",))
    d_index, dp = sharding.shard_index(mesh, d_axes)
    return _Axes(tp, m_index, mesh.get_group("model"), dp, d_index,
                 tuple(mesh.get_group(a) for a in d_axes),
                 sharding.mesh_device(mesh))


def _all_reduce(t: torch.Tensor, groups, op=dist.ReduceOp.SUM):
    """All-reduce ``t`` in place over each group in turn (JAX's psum over
    each axis)."""
    for g in groups:
        dist.all_reduce(t, op=op, group=g)
    return t


def _any_over(flag: torch.Tensor, *, ax: _Axes) -> bool:
    """Whether ``flag`` (a bool tensor) holds anywhere on the data axes:
    one all-reduce and one host read."""
    n = flag.any().to(torch.int32).reshape(1)
    return bool(_all_reduce(n, ax.data).item())


# ---------------------------------------------------------------------------
# Local (per-rank) layer step with one all-reduce
# ---------------------------------------------------------------------------

def _tp_layer_qkv(p, x, *, cfg: NeoXConfig, cos, sin, positions):
    """``neox.layer_qkv`` for the head-major local QKV shard: the local
    columns are (head, q|k|v, d) over the rank's heads."""
    B, S, H, D = x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim
    attn_in = neox.layer_norm(x, p["ln1"], cfg.layer_norm_eps)
    qkv = linear_ops.apply_linear(attn_in, p["attn"]["qkv"])   # [B, S, H*3D]
    qkv = qkv.reshape(B, S, H, 3, D).permute(3, 0, 2, 1, 4)    # [3, B, H, S, D]
    q = neox.apply_rope(qkv[0], cos, sin, positions)
    k = neox.apply_rope(qkv[1], cos, sin, positions)
    return q, k, qkv[2]


def _local_cfg(cfg: NeoXConfig, tp: int) -> NeoXConfig:
    if cfg.num_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(f"{cfg.num_heads} heads / FFN "
                         f"{cfg.intermediate_size} do not split over tp={tp}")
    return dataclasses.replace(cfg, hidden_size=cfg.hidden_size // tp,
                               num_heads=cfg.num_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp)


def _nobias(lin: StackedLinear) -> StackedLinear:
    return StackedLinear({k: v for k, v in lin.node.items() if k != "bias"},
                         lin.layer)


def _tp_finish(p, h, attn, *, cfg: NeoXConfig, group):
    """The layer's row-parallel half: attention-out and MLP-down partial
    sums, ONE all-reduce of their sum, then the replicated biases and the
    residual. Differentiable (the training stacks of ``train/
    train_step.py``): the MLP's input enters its column-parallel half
    through ``collectives.copy_to`` and the sum leaves through
    ``reduce_from``; under ``torch.no_grad()`` these are the identity and
    one in-place all-reduce."""
    B, S = h.shape[:2]
    out, down = p["attn"]["out"], p["mlp"]["down"]
    a_part = linear_ops.apply_linear(attn.transpose(1, 2).reshape(B, S, -1),
                                     _nobias(out))
    mlp_in = collectives.copy_to(
        neox.layer_norm(h, p["ln2"], cfg.layer_norm_eps), group)
    u = linear_ops.apply_linear(mlp_in, p["mlp"]["up"])     # bias is sharded
    m_part = linear_ops.apply_linear(F.gelu(u, approximate="none"),
                                     _nobias(down))
    tot = collectives.reduce_from(a_part + m_part, (group,))
    for lin in (out, down):
        if "bias" in lin.node:
            tot = tot + lin.node["bias"][lin.layer].to(tot.dtype)
    return h + tot.to(h.dtype)


# ---------------------------------------------------------------------------
# Sampling over the vocab-sharded head
# ---------------------------------------------------------------------------

class _Rng(NamedTuple):
    """Sampling generators of one program call: ``shared`` is the same on
    the model ranks of one data shard (top-k / top-p draws from the full
    logits there), ``own`` is this rank's (Gumbel noise of its vocab
    slice). Both None for greedy decoding."""
    shared: Optional[torch.Generator]
    own: Optional[torch.Generator]


def _rngs(generator: Optional[torch.Generator], greedy: bool, *,
          ax: _Axes) -> _Rng:
    """Seed a call's generators from one draw of ``generator`` (the same on
    every rank), decorrelated over the data shards (JAX folds its key with
    their indices) and, for the noise, over the model shards."""
    if greedy:
        return _Rng(None, None)
    if generator is None:
        raise ValueError("sampling over a mesh needs a generator")
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())

    def seeded(*parts):
        s = base
        for x in parts:
            s = (s * 1_000_003 + x + 1) % 2 ** 63
        return torch.Generator(ax.device).manual_seed(s)

    return _Rng(seeded(ax.data_index), seeded(ax.data_index, ax.model_index))


def _local_logits(params, hidden, ax: _Axes):
    """This rank's vocab slice of the LM head, float32 [.., V_local], and
    the slice's first global index."""
    lin = params["embed_out"]
    local = linear_ops.apply_linear(
        hidden, {k: v for k, v in lin.items() if k != "bias"})
    v_local = local.shape[-1]
    lo = ax.model_index * v_local
    if "bias" in lin:       # replicated: this rank's slice of it
        local = local + lin["bias"][lo:lo + v_local].to(local.dtype)
    return local.float(), lo


def _tp_logits(params, hidden, ax: _Axes):
    """Vocab-sharded LM head, gathered: [.., V] float32 on every rank."""
    local, lo = _local_logits(params, hidden, ax)
    full = local.new_zeros((*local.shape[:-1], local.shape[-1] * ax.tp))
    full[..., lo:lo + local.shape[-1]] = local
    return _all_reduce(full, (ax.model,))


def _tp_sample_tokens(params, hidden, greedy, temperature, rng: _Rng,
                      top_k: int = 0, top_p: float = 1.0, *, ax: _Axes):
    """Sample [B] tokens from the vocab-sharded head without gathering the
    logits, where the global top-1 is enough:

    - greedy: the argmax of the full logits, bit for bit (the lowest index
      among equal maxima, as a single device's argmax);
    - temperature: Gumbel-max over each rank's logits with its own noise,
      distributionally exact but not the single-device draw;
    - top-k / top-p need a global sort and gather the logits."""
    if top_k or top_p < 1.0:
        return gen._sample(_tp_logits(params, hidden, ax), greedy,
                           temperature, rng.shared, top_k, top_p)
    score, lo = _local_logits(params, hidden, ax)           # [B, V_local]
    if not greedy:
        noise = torch.empty_like(score).exponential_(generator=rng.own)
        score = score / temperature - noise.clamp_min(1e-30).log()
    idx = torch.argmax(score, dim=-1, keepdim=True)
    val = score.gather(-1, idx)[:, 0]
    top = _all_reduce(val.clone(), (ax.model,), dist.ReduceOp.MAX)
    cand = torch.where(val == top, idx[:, 0] + lo,
                       torch.iinfo(torch.int64).max)
    return _all_reduce(cand, (ax.model,), dist.ReduceOp.MIN).to(torch.int32)


# ---------------------------------------------------------------------------
# A rank's hooks, and the two programs' makers
# ---------------------------------------------------------------------------

def _gather_rows(local: torch.Tensor, *, ax: _Axes) -> torch.Tensor:
    """[B_local, ...] -> [B, ...] on every rank: each data shard's rows
    placed in zeros, then one all-reduce SUM over the data axes."""
    b = local.shape[0]
    full = local.new_zeros((b * ax.dp, *local.shape[1:]))
    full[ax.data_index * b:(ax.data_index + 1) * b] = local
    return _all_reduce(full, ax.data)


def _decoders(mesh, cfg: BlockTransformerConfig,
              overlap_streams: int) -> gen.Decoders:
    """This rank's hooks for the generation loops and the engine: the
    stacks on its shards with one all-reduce a layer over ``model``, the
    token decoder's loop on its heads with the pick over its vocab shard,
    the stop test and the window's tokens over the data axes, and its rows
    of every batch (its data shard's)."""
    if overlap_streams not in (1, 2):
        raise ValueError(f"overlap_streams {overlap_streams} (1 or 2)")
    tcfg = cfg.token_decoder
    if (cfg.block_decoder_cls != "gpt-neo-x" or tcfg.cls != "gpt-neo-x"
            or tcfg.decoding_strategy != "prefix"):
        raise NotImplementedError("tensor-parallel decode runs the GPT-NeoX "
                                  "block decoder and prefix token decoder")
    if not (cfg.block_decoder.use_parallel_residual
            and tcfg.neox.use_parallel_residual):
        raise NotImplementedError("tensor-parallel decode implements the "
                                  "parallel-residual (Pythia) layout")
    ax = _axes(mesh)
    halves = dict(qkv=_tp_layer_qkv,
                  finish=functools.partial(_tp_finish, group=ax.model))
    stack = functools.partial(neox._stack, **halves)
    tokens = functools.partial(
        gen._prefix_decode, token_cfg=_local_cfg(tcfg.neox, ax.tp),
        stack=stack, pick=functools.partial(_tp_sample_tokens, ax=ax))
    return gen.Decoders(
        _local_cfg(cfg.block_decoder, ax.tp), stack,
        functools.partial(neox._prefill_fresh, **halves), tokens,
        functools.partial(_any_over, ax=ax), ax.dp, ax.data_index,
        functools.partial(_gather_rows, ax=ax),
        functools.partial(_rngs, ax=ax), linear_ops.sharded_program,
        overlap_streams)


def make_tp_generate_blocks(mesh, cfg: BlockTransformerConfig, params_tree,
                            *, max_blocks: int, greedy: bool = True,
                            temperature: float = 1.0,
                            kv_cache: str = "bf16",
                            overlap_streams: int = 1):
    """The two-level generator over ``mesh``, run by every rank alike: the
    single-device loop (``generate._generate``) on this rank's hooks.

    Returns ``fn(params, input_ids, attention_mask, block_attention_mask,
    generator=None) -> (tokens [B, max_blocks, L], n_blocks)``: ``params``
    are the rank's shards (``shard_tp_params`` of a ``prepare_tp_params``
    tree), the inputs the whole batch (every rank takes its data shard's
    rows), ``generator`` the same on every rank (sampling only), and the
    tokens the whole batch on every rank (gathered once, at the end). The
    prompt goes in by the fresh prefill (JAX's default). ``kv_cache``:
    "bf16" or "int8" (the global cache). ``params_tree`` is taken for JAX's
    signature: the shards already carry their layout.

    ``overlap_streams=2`` splits the local batch into two half-batch
    streams and runs ``TD(A); TD(B); BD(A); BD(B)`` a block, as JAX does;
    greedy tokens are those of one stream."""
    del params_tree
    if kv_cache not in ("bf16", "int8"):
        raise ValueError(f"kv_cache {kv_cache!r} (bf16 or int8)")
    dec = _decoders(mesh, cfg, overlap_streams)
    device = sharding.mesh_device(mesh)

    def fn(params, input_ids, attention_mask, block_attention_mask,
           generator: Optional[torch.Generator] = None):
        res = gen._generate(params, cfg, input_ids, attention_mask,
                            block_attention_mask, dec, max_blocks=max_blocks,
                            greedy=greedy, temperature=temperature,
                            generator=generator, kv_cache=kv_cache,
                            device=device)
        return res.tokens, res.n_blocks

    return fn


def engine_state_specs(cache, data_axes=("data",)) -> tuple:
    """(cache specs, kv_valid, next_embeds, per-slot) partition specs of the
    engine's state: slots shard over the data axes, K/V heads over
    ``model``. A paged pool's axis 1 (pages) partitions over the data axes
    (each shard's sub-pool holds its own slots' pages at shard-local ids)
    and its page table shards with its slot rows."""
    dd = tuple(data_axes)

    def cache_spec(x):
        if not isinstance(x, torch.Tensor):
            return P()                      # length
        if x.dim() == 5:                    # k/v [L, B|P, H, cap|ps, D]
            return P(None, dd, "model", None, None)
        if x.dim() == 4:                    # scales [L, B|P, H, cap|ps]
            return P(None, dd, "model", None)
        if x.dim() == 2:                    # page_table [n_slots, n_virt]
            return P(dd)
        return P()

    cache_specs = type(cache)(*(cache_spec(x) for x in cache))
    return cache_specs, P(dd), P(dd), P(dd)


def make_tp_engine_programs(mesh, cfg: BlockTransformerConfig, params_tree,
                            cache_tmpl, *, n_slots: int, capacity: int,
                            max_window: int, kv_cache: str = "int8",
                            greedy: bool = True, temperature: float = 1.0,
                            top_k: int = 0, top_p: float = 1.0,
                            overlap_streams: int = 1) -> gen.Decoders:
    """The serving engine's programs on this rank: the hooks its admission
    prefill and decode window run on (``ContinuousBatchingEngine`` over a
    mesh). A rank holds the slots of its data shard (rows ``data_index *
    n_slots / dp`` on) and its heads; a paged pool, its own sub-pool. The
    window stops once no slot of any shard is live (one all-reduce a
    block), and its tokens come back for every slot on every rank (one
    all-reduce a window).

    ``overlap_streams=2`` runs the token decoder as two half-batch streams
    a block (JAX's schedule for the engine: the block decoder stays joint).
    ``params_tree``, ``cache_tmpl``, ``capacity``, ``max_window`` and the
    sampling options are taken for JAX's signature: the engine passes its
    state and options at each call."""
    del params_tree, cache_tmpl, capacity, max_window
    del greedy, temperature, top_k, top_p
    if kv_cache not in MESH_KINDS:
        raise ValueError(f"kv_cache {kv_cache!r} over a mesh (expected one "
                         f"of {MESH_KINDS})")
    dec = _decoders(mesh, cfg, overlap_streams)
    if n_slots % dec.data_shards:
        raise ValueError(f"{n_slots} slots do not split over "
                         f"{dec.data_shards} data shards")
    return dec
