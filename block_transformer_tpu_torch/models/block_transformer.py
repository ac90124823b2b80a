"""The composite Block Transformer: embed -> block-decode -> shift ->
token-decode (port of ``block_transformer_tpu/models/block_transformer.py``).

The block decoder's output at block i conditions the token decoding of
block i+1; the token decoder reads ``[BOS, x1..xL]`` and predicts
``[x1..xL]``. The loss is the token cross-entropy, masked over padding
tokens, ignored labels (-100) and padding blocks. Two auxiliary losses
can be added: the block-decoding loss (``block_decoder.block_decoding_loss``
on the block decoder's hidden states) and the auto-encoding loss (the token
decoder conditioned on each block's own embedding), each weighted.

Inside ``parallel.sharding.set_mesh`` the forward is one rank's part of a
training mesh (``train/train_step.py``, ``parallel/pipeline.py``): the
loss's sums are added up over the data axes and ``seq``
(``parallel/collectives.py``), so the loss is the masked mean over the
whole batch, not a mean of the ranks' means; on a ``model`` axis the LM
head's logits are the rank's vocab slice and the cross-entropy reduces
over them; on a ``seq`` axis the rank holds a chunk of blocks, and the
first block of its chunk is conditioned on the previous rank's last block
(a one-block halo). The stacks come in through ``block_decoder_fn`` and
``token_decoder_stack_fn``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from block_transformer_tpu_torch.config import BlockTransformerConfig
from block_transformer_tpu_torch.models import block_decoder as bd
from block_transformer_tpu_torch.models import embedder as emb
from block_transformer_tpu_torch.models import token_decoder as td
from block_transformer_tpu_torch.parallel import collectives
from block_transformer_tpu_torch.parallel import sharding as _sh


def init_block_transformer_params(gen, cfg: BlockTransformerConfig,
                                  dtype=torch.float32, device="cuda"):
    """Random parameters drawn from ``gen``: a ``torch.Generator`` on
    ``device``, or an int seed for a new one. The expansion layer is sized
    by ``cfg.expansion_ratio``, which reads a ratio of None as the block
    length, as every forward does (the JAX package's init multiplies by
    the None and raises, so it cannot build the shipped summation and
    cross-attention configs)."""
    if isinstance(gen, int):
        gen = torch.Generator(device=device).manual_seed(gen)
    tcfg = dataclasses.replace(cfg.token_decoder,
                               expansion_ratio=cfg.expansion_ratio)
    return {
        "embedder": emb.init_embedder_params(gen, cfg.embedder,
                                             cfg.block_length, dtype, device),
        "block_decoder": bd.init_block_decoder_params(
            gen, cfg.block_decoder, dtype, device, cls=cfg.block_decoder_cls,
            window=cfg.block_decoder_window),
        "token_decoder": td.init_token_decoder_params(
            gen, tcfg, cfg.embedder.projection_hidden_size, dtype, device),
    }


def count_params(params) -> int:
    """Elements in every tensor leaf of a (nested dict) parameter tree."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


class BlockTransformerOutput(NamedTuple):
    logits: Optional[torch.Tensor]          # [B, N-1, L, V] float32
    loss: Optional[torch.Tensor]
    token_decoding_loss: Optional[torch.Tensor]
    block_decoding_loss: Optional[torch.Tensor]
    auto_encoding_loss: Optional[torch.Tensor]
    loss_by_position: Optional[torch.Tensor]   # [L] mean CE by position


def _seq_shifted(hidden, block_attention_mask, n_emb: int,
                 seq: collectives.Axis):
    """The shift to the token decoder over a chunk of blocks: block i's
    output conditions block i + 1. The chunk's first block takes the
    previous ``seq`` rank's last block (``collectives.shift``); on the
    first rank it has none and is masked (its rows are computed, with zero
    weight, so that every rank runs the same backward). Returns (the
    conditioning hidden states and the block mask of all the chunk's
    blocks)."""
    halo = collectives.shift(hidden[:, -n_emb:], seq)
    blk = block_attention_mask
    if seq.index == 0:
        keep = torch.ones_like(blk[:1])
        keep[:, 0] = 0
        blk = blk * keep
    return torch.cat([halo, hidden[:, :-n_emb]], dim=1), blk


def block_transformer_forward(params, cfg: BlockTransformerConfig, input_ids,
                              attention_mask, block_attention_mask,
                              labels=None, compute_logits: bool = None,
                              remat: bool = False, block_decoder_fn=None,
                              token_decoder_stack_fn=None
                              ) -> BlockTransformerOutput:
    """input_ids / attention_mask [B, N, L]; block_attention_mask [B, N];
    labels [B, N, L] with -100 on ignored positions, or None. Returns the
    logits [B, N-1, L, V] when ``compute_logits`` (default: no labels) and,
    when labels are given, the losses the config enables and their sum as
    ``loss``. ``remat`` checkpoints each layer of the GPT-NeoX stacks (the
    training forward: ``train.train_step``). ``block_decoder_fn`` replaces
    ``block_decoder.block_decoder_forward`` (same arguments) and
    ``token_decoder_stack_fn`` the token decoder's stack
    (``token_decoder_train_forward(stack_fn=)``): the mesh training
    programs and the pipeline plug their stacks in there."""
    B, N, L = input_ids.shape
    n_emb = cfg.n_embedding_tokens
    ph = cfg.embedder.projection_hidden_size
    if compute_logits is None:
        compute_logits = labels is None
    ax = collectives.train_axes()
    seq = ax.seq if ax is not None else collectives.ONE

    block_embeds = emb.embed_blocks(params["embedder"], cfg.embedder,
                                    cfg.block_length, input_ids,
                                    attention_mask=attention_mask)
    inputs_embeds = _sh.seq_constraint(block_embeds.reshape(B, N * n_emb, ph))
    bd_forward = block_decoder_fn or bd.block_decoder_forward
    hidden = bd_forward(params["block_decoder"], cfg.block_decoder,
                        inputs_embeds, block_attention_mask, n_emb,
                        remat=remat, cls=cfg.block_decoder_cls,
                        window=cfg.block_decoder_window)
    hidden = _sh.seq_constraint(hidden)
    block_loss = None
    if cfg.use_block_decoding_loss and labels is not None:
        if ax is not None and (ax.loss or ax.model.group is not None):
            raise NotImplementedError("the block-decoding loss is not "
                                      "computed over a mesh")
        block_loss = cfg.block_decoding_loss_weight * bd.block_decoding_loss(
            hidden, inputs_embeds, block_attention_mask, n_emb,
            cfg.block_decoding_loss_type)

    if seq.group is not None:
        cond, blk = _seq_shifted(hidden, block_attention_mask, n_emb, seq)
        ids, att, lab = input_ids, attention_mask, labels
        own_embeds = block_embeds
    else:
        # block i's output conditions block i+1's tokens
        ids, att = input_ids[:, 1:, :], attention_mask[:, 1:, :]
        blk = block_attention_mask[:, 1:]
        lab = None if labels is None else labels[:, 1:, :]
        cond = hidden[:, :-n_emb, :]
        own_embeds = block_embeds[:, 1:, :, :]
    nb = ids.shape[1]
    Bb = B * nb
    ids_s, att_s = ids.reshape(Bb, L), att.reshape(Bb, L)
    blk_s = blk.reshape(Bb)
    block_embeddings = cond.reshape(Bb, n_emb, ph)

    bos = torch.full((Bb, 1), cfg.bos_token_id, dtype=ids_s.dtype,
                     device=ids_s.device)
    td_ids = torch.cat([bos, ids_s], dim=1)                    # [Bb, L+1]
    td_att = torch.cat([torch.ones_like(att_s[:, :1]), att_s], dim=1)

    def token_logits(embeddings):
        return td.token_decoder_train_forward(
            params["token_decoder"], cfg.token_decoder, td_ids, td_att,
            embeddings, cfg.expansion_ratio, cfg.block_length, remat=remat,
            stack_fn=token_decoder_stack_fn)

    logits = token_logits(block_embeddings)
    token_loss = loss_by_pos = auto_loss = total = None
    if labels is not None:
        labels_s = lab.reshape(Bb, L)
        # content positions: attended, a label, in a block that is not pad
        weight = (att_s.float() * (labels_s != -100).float()
                  * blk_s.float()[:, None])
        if cfg.use_token_decoding_loss:
            token_loss, loss_by_pos = collectives.masked_ce(
                logits.float(), labels_s, weight)
            total = token_loss
        if cfg.use_auto_encoding_loss:
            # the token decoder conditioned on the block's own embedding
            own = own_embeds.reshape(Bb, n_emb, ph)
            ae, _ = collectives.masked_ce(token_logits(own).float(),
                                          labels_s, weight)
            auto_loss = cfg.auto_encoding_loss_weight * ae
            total = auto_loss if total is None else total + auto_loss
    if block_loss is not None:
        total = block_loss if total is None else total + block_loss

    out_logits = logits.reshape(B, nb, L, -1) if compute_logits else None
    return BlockTransformerOutput(out_logits, total, token_loss, block_loss,
                                  auto_loss, loss_by_pos)
