"""The composite Block Transformer: embed -> block-decode -> shift ->
token-decode (port of ``block_transformer_tpu/models/block_transformer.py``).

The block decoder's output at block i conditions the token decoding of
block i+1; the token decoder reads ``[BOS, x1..xL]`` and predicts
``[x1..xL]``. The loss is the token cross-entropy, masked over padding
tokens, ignored labels (-100) and padding blocks. Two auxiliary losses
can be added: the block-decoding loss (``block_decoder.block_decoding_loss``
on the block decoder's hidden states) and the auto-encoding loss (the token
decoder conditioned on each block's own embedding), each weighted.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from block_transformer_tpu_torch.config import BlockTransformerConfig
from block_transformer_tpu_torch.models import block_decoder as bd
from block_transformer_tpu_torch.models import embedder as emb
from block_transformer_tpu_torch.models import token_decoder as td


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


class BlockTransformerOutput(NamedTuple):
    logits: Optional[torch.Tensor]          # [B, N-1, L, V] float32
    loss: Optional[torch.Tensor]
    token_decoding_loss: Optional[torch.Tensor]
    block_decoding_loss: Optional[torch.Tensor]
    auto_encoding_loss: Optional[torch.Tensor]
    loss_by_position: Optional[torch.Tensor]   # [L] mean CE by position


def _token_ce(logits, labels, weight):
    """Masked token CE. logits [Bb, L, V] f32; labels [Bb, L]; weight
    [Bb, L] f32 (0 = excluded). Returns (mean loss, per-position mean [L])."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    ce = -ll * weight
    loss = ce.sum() / weight.sum().clamp(min=1.0)
    loss_by_pos = ce.sum(0) / weight.sum(0).clamp(min=1.0)
    return loss, loss_by_pos


def block_transformer_forward(params, cfg: BlockTransformerConfig, input_ids,
                              attention_mask, block_attention_mask,
                              labels=None, compute_logits: bool = None,
                              remat: bool = False) -> BlockTransformerOutput:
    """input_ids / attention_mask [B, N, L]; block_attention_mask [B, N];
    labels [B, N, L] with -100 on ignored positions, or None. Returns the
    logits [B, N-1, L, V] when ``compute_logits`` (default: no labels) and,
    when labels are given, the losses the config enables and their sum as
    ``loss``. ``remat`` checkpoints each layer of the GPT-NeoX stacks (the
    training forward: ``train.train_step``)."""
    B, N, L = input_ids.shape
    n_emb = cfg.n_embedding_tokens
    ph = cfg.embedder.projection_hidden_size
    if compute_logits is None:
        compute_logits = labels is None

    block_embeds = emb.embed_blocks(params["embedder"], cfg.embedder,
                                    cfg.block_length, input_ids,
                                    attention_mask=attention_mask)
    inputs_embeds = block_embeds.reshape(B, N * n_emb, ph)
    hidden = bd.block_decoder_forward(params["block_decoder"],
                                      cfg.block_decoder, inputs_embeds,
                                      block_attention_mask, n_emb,
                                      remat=remat, cls=cfg.block_decoder_cls,
                                      window=cfg.block_decoder_window)
    block_loss = None
    if cfg.use_block_decoding_loss and labels is not None:
        block_loss = cfg.block_decoding_loss_weight * bd.block_decoding_loss(
            hidden, inputs_embeds, block_attention_mask, n_emb,
            cfg.block_decoding_loss_type)

    # block i's output conditions block i+1's tokens
    Bb = B * (N - 1)
    ids_s = input_ids[:, 1:, :].reshape(Bb, L)
    att_s = attention_mask[:, 1:, :].reshape(Bb, L)
    blk_s = block_attention_mask[:, 1:].reshape(Bb)
    block_embeddings = hidden[:, :-n_emb, :].reshape(Bb, n_emb, ph)

    bos = torch.full((Bb, 1), cfg.bos_token_id, dtype=ids_s.dtype,
                     device=ids_s.device)
    td_ids = torch.cat([bos, ids_s], dim=1)                    # [Bb, L+1]
    td_att = torch.cat([torch.ones_like(att_s[:, :1]), att_s], dim=1)

    def token_logits(embeddings):
        return td.token_decoder_train_forward(
            params["token_decoder"], cfg.token_decoder, td_ids, td_att,
            embeddings, cfg.expansion_ratio, cfg.block_length, remat=remat)

    logits = token_logits(block_embeddings)
    token_loss = loss_by_pos = auto_loss = total = None
    if labels is not None:
        labels_s = labels[:, 1:, :].reshape(Bb, L)
        # content positions: attended, a label, in a block that is not pad
        weight = (att_s.float() * (labels_s != -100).float()
                  * blk_s.float()[:, None])
        if cfg.use_token_decoding_loss:
            token_loss, loss_by_pos = _token_ce(logits.float(), labels_s,
                                                weight)
            total = token_loss
        if cfg.use_auto_encoding_loss:
            # the token decoder conditioned on the block's own embedding
            own = block_embeds[:, 1:, :, :].reshape(Bb, n_emb, ph)
            ae, _ = _token_ce(token_logits(own).float(), labels_s, weight)
            auto_loss = cfg.auto_encoding_loss_weight * ae
            total = auto_loss if total is None else total + auto_loss
    if block_loss is not None:
        total = block_loss if total is None else total + block_loss

    out_logits = logits.reshape(B, N - 1, L, -1) if compute_logits else None
    return BlockTransformerOutput(out_logits, total, token_loss, block_loss,
                                  auto_loss, loss_by_pos)
