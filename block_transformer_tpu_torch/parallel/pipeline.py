"""Pipeline parallelism for the decoder stacks, GPipe schedule (port of
``block_transformer_tpu/parallel/pipeline.py``).

A ``pipe`` mesh axis (``sharding.named_mesh``, e.g. ``(data, pipe)``)
splits the stacked layers ``[L, ...]`` of the block decoder (and of the
token decoder's GPT-NeoX stack, when its depth divides) into contiguous
stages, one a ``pipe`` rank; the embedder and the LM head stay data
parallel. A rank's batch is cut into ``n_micro`` micro-batches; at tick
``t`` stage ``p`` runs micro-batch ``t - p`` (before its first and after
its last it runs on data whose output no one reads), and the activations
move one stage a tick by ``collectives.shift`` (JAX's ``ppermute``, built
from one all-gather over ``pipe``; its backward is the reverse shift). The
loop over the ``m + P - 1`` ticks is plain autograd, so the backward runs
the schedule in reverse, as JAX's differentiated ``scan`` does. The last
stage's output reaches every ``pipe`` rank through
``collectives.from_last`` (JAX slices ``out[n_stages - 1]``, a broadcast
under GSPMD); its backward sums every rank's gradient onto the last stage.
Each ``pipe`` rank computes the same loss after the pipeline, so the
train step scales it by 1/P for the backward, and the gradients of what is
replicated over ``pipe`` (the embedder, the LM head, an unpipelined token
decoder) are summed over ``pipe``. ``remat`` checkpoints each layer of a
stage.

Every rank runs every tick's stage, the don't-care ticks too, and takes
both the micro-batch and the shifted activations into its stage input
(``torch.where`` on the stage index), so each rank issues the same
collectives forward and backward. The bubble is (P-1)/(m+P-1); pick
``n_micro`` >= 4P to keep it under ~20%.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import masks as masks_lib
from block_transformer_tpu_torch.parallel import collectives
from block_transformer_tpu_torch.parallel import sharding
from block_transformer_tpu_torch.parallel.sharding import P


def _pipe(mesh) -> collectives.Axis:
    if "pipe" not in mesh.mesh_dim_names:
        raise ValueError(f"no pipe axis in {mesh.mesh_dim_names}")
    for a in ("model", "seq"):
        if collectives.axis(mesh, a).size > 1:
            raise NotImplementedError("the pipeline runs over data and pipe "
                                      "axes only")
    return collectives.axis(mesh, "pipe")


def make_pp_neox_layers(mesh, cfg, n_micro: int, remat: bool = False):
    """The pipelined layer stack: ``fn(layers, x, q_idx, kv_idx, kv_valid)
    -> hidden`` on every ``pipe`` rank, before the final layer norm.
    ``layers`` is the rank's stage (its ``[L / P, ...]`` slice of the
    stacked layers), ``x`` [B, S, h] the rank's rows (the same on every
    ``pipe`` rank of a data shard), and the mask triple
    ``ops.masks.AttnMask``'s fields."""
    pipe = _pipe(mesh)
    n_stages = pipe.size
    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} layers do not split into "
                         f"{n_stages} stages")
    m = n_micro

    def stage_layers(layers, x, mask, cos, sin, positions):
        def body(h, i):
            h, _ = neox.neox_layer(neox.layer_view(layers, i), h, cfg=cfg,
                                   mask=mask, cos=cos, sin=sin,
                                   positions=positions)
            return h

        h = x
        for i in range(cfg.num_layers // n_stages):
            h = (checkpoint(body, h, i, use_reentrant=False) if remat
                 else body(h, i))
        return h

    def fn(layers, x, q_idx, kv_idx, kv_valid):
        B, S, H = x.shape
        if B % m:
            raise ValueError(f"{B} rows do not split into {m} micro-batches")
        mb = B // m
        cos, sin = neox.rope_tables(cfg, max(cfg.max_position_embeddings, S),
                                    x.device)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        x_mb = x.reshape(m, mb, S, H)
        kv_mb = kv_valid.reshape(m, mb, -1)
        first = torch.tensor(pipe.index == 0, device=x.device)
        state = torch.zeros((mb, S, H), dtype=x.dtype, device=x.device)
        ys = []
        for t in range(m + n_stages - 1):
            # stage p works on micro-batch t - p; outside its range it
            # runs on don't-care data whose outputs are never read
            my = min(max(t - pipe.index, 0), m - 1)
            x_in = torch.where(first, x_mb[my], state)
            mask = masks_lib.AttnMask(q_idx, kv_idx, kv_mb[my])
            y = stage_layers(layers, x_in, mask, cos, sin, positions)
            state = collectives.shift(y, pipe)
            ys.append(y)
        # micro-batch i leaves the last stage at tick i + P - 1
        out = torch.cat(ys[n_stages - 1:n_stages - 1 + m])
        return collectives.from_last(out, pipe)

    return fn


def make_pp_block_decoder_forward(mesh, n_micro: int):
    """A drop-in for ``models.block_decoder.block_decoder_forward`` that
    runs the layer stack pipelined over ``pipe`` (the GPT-NeoX block
    decoder only)."""

    def forward(params, cfg, inputs_embeds, block_attention_mask,
                n_embedding_tokens: int, remat: bool = False,
                cls: str = "gpt-neo-x", window: int = 256):
        if cls != "gpt-neo-x":
            raise NotImplementedError("pipeline parallel supports the NeoX "
                                      "block decoder")
        fn = make_pp_neox_layers(mesh, cfg, n_micro, remat=remat)
        mask = masks_lib.block_decoder_train_mask(block_attention_mask,
                                                  n_embedding_tokens)
        h = fn(params["layers"], inputs_embeds, mask.q_idx, mask.kv_idx,
               mask.kv_valid)
        return neox.layer_norm(h, params["final_ln"], cfg.layer_norm_eps)

    return forward


def make_pp_token_decoder_stack(mesh, td_cfg, n_micro: int,
                                remat: bool = False):
    """``stack_fn`` for ``models.token_decoder.token_decoder_train_forward``:
    the token decoder's GPT-NeoX stack pipelined over ``pipe``, the same
    schedule as the block decoder's (both trunks share the axis)."""
    fn = make_pp_neox_layers(mesh, td_cfg.neox, n_micro, remat=remat)

    def stack(params, x, mask, positions):
        del positions      # the pipelined stack uses arange(S), the same
        h = fn(params["layers"], x, mask.q_idx, mask.kv_idx, mask.kv_valid)
        return neox.layer_norm(h, params["final_ln"],
                               td_cfg.neox.layer_norm_eps)

    return stack


def pp_param_pspecs(params, mesh, pipe_token_decoder: bool = False) -> dict:
    """``param_pspecs`` with the decoder layer stacks split over ``pipe``
    on their leading (layer) axis (the token decoder's only when its stack
    runs pipelined); axes the mesh lacks (``model`` on a (data, pipe) mesh)
    become replicated."""
    have = set(mesh.mesh_dim_names)
    piped = (("block_decoder", "token_decoder") if pipe_token_decoder
             else ("block_decoder",))

    def scrub(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in have)
            return kept or None
        return entry if entry in have else None

    def reshard(names, spec):
        parts = [scrub(e) for e in spec]
        if names[0] in piped and "layers" in names:
            parts[0] = "pipe"
        return P(*parts)

    pspecs = sharding.param_pspecs(params)
    return sharding.map_with_path(
        lambda names, _: reshard(names, sharding._at(pspecs, names)), params)


def make_pp_train_step(mesh, cfg, tx, params, n_micro: int,
                       remat: bool = True):
    """(train_step, state_spec): the (data x pipe) step of one rank, the
    block decoder (and the token decoder's stack, when its depth divides)
    pipelined over ``pipe``, everything else data parallel, the moments
    placed by ``train_step._opt_state_pspecs`` as in the plain sharded
    step. ``train_step(state, batch) -> (state, {"loss", "grad_norm"})``
    takes the rank's shards (``train_step.shard_with(mesh, full_state,
    state_spec)``) and the global batch. ``params``: the full tree."""
    from block_transformer_tpu_torch.train import train_step as ts

    pipe = _pipe(mesh)
    td = cfg.token_decoder
    bd_fn = make_pp_block_decoder_forward(mesh, n_micro)
    td_fn = (make_pp_token_decoder_stack(mesh, td, n_micro, remat=remat)
             if td.cls == "gpt-neo-x"
             and td.decoding_strategy != "cross_attention"
             and td.neox.num_layers % pipe.size == 0 else None)
    pspecs = pp_param_pspecs(params, mesh, pipe_token_decoder=td_fn is not None)
    state_spec = ts._state_spec(mesh, params, pspecs)
    inner = ts._mesh_loss_fn(mesh, cfg, remat, block_decoder_fn=bd_fn,
                             token_decoder_stack_fn=td_fn)

    def loss_fn(p, batch):
        loss, metrics = inner(p, batch)
        return loss, {"loss": metrics["loss"]}

    step = ts._mesh_step(mesh, tx, state_spec, loss_fn,
                         scale=1.0 / pipe.size)
    return step, state_spec
