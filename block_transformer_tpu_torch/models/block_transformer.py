"""The composite Block Transformer: embed -> block-decode -> shift ->
token-decode (port of ``block_transformer_tpu/models/block_transformer.py``).

The block decoder's output at block i conditions the token decoding of
block i+1; the token decoder reads ``[BOS, x1..xL]`` and predicts
``[x1..xL]``. The loss is the token cross-entropy, masked over padding
tokens, ignored labels (-100) and padding blocks. The auxiliary block-
decoding and auto-encoding losses are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from block_transformer_tpu_torch.config import BlockTransformerConfig
from block_transformer_tpu_torch.models import block_decoder as bd
from block_transformer_tpu_torch.models import embedder as emb
from block_transformer_tpu_torch.models import token_decoder as td


def init_block_transformer_params(gen, cfg: BlockTransformerConfig,
                                  dtype=torch.float32, device="cuda"):
    """Random parameters drawn from ``gen``: a ``torch.Generator`` on
    ``device``, or an int seed for a new one."""
    if isinstance(gen, int):
        gen = torch.Generator(device=device).manual_seed(gen)
    if cfg.block_decoder_cls != "gpt-neo-x":
        raise NotImplementedError(f"block decoder {cfg.block_decoder_cls!r}")
    return {
        "embedder": emb.init_embedder_params(gen, cfg.embedder,
                                             cfg.block_length, dtype, device),
        "block_decoder": bd.init_block_decoder_params(
            gen, cfg.block_decoder, dtype, device),
        "token_decoder": td.init_token_decoder_params(
            gen, cfg.token_decoder, cfg.embedder.projection_hidden_size,
            dtype, device),
    }


class BlockTransformerOutput(NamedTuple):
    logits: Optional[torch.Tensor]          # [B, N-1, L, V] float32
    loss: Optional[torch.Tensor]
    token_decoding_loss: Optional[torch.Tensor]
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
    logits [B, N-1, L, V] when ``compute_logits`` (default: no labels) and
    the token loss when labels are given. ``remat`` checkpoints each layer
    of both stacks (the training forward: ``train.train_step``)."""
    if labels is not None and (cfg.use_block_decoding_loss
                               or cfg.use_auto_encoding_loss):
        raise NotImplementedError("auxiliary losses are not ported")
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
                                      remat=remat)

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
    logits = td.token_decoder_train_forward(
        params["token_decoder"], cfg.token_decoder, td_ids, td_att,
        block_embeddings, cfg.expansion_ratio, cfg.block_length,
        remat=remat)

    token_loss = loss_by_pos = None
    if labels is not None and cfg.use_token_decoding_loss:
        labels_s = labels[:, 1:, :].reshape(Bb, L)
        weight = (att_s.float() * (labels_s != -100).float()
                  * blk_s.float()[:, None])
        token_loss, loss_by_pos = _token_ce(logits.float(), labels_s, weight)

    out_logits = logits.reshape(B, N - 1, L, -1) if compute_logits else None
    return BlockTransformerOutput(out_logits, token_loss, token_loss,
                                  loss_by_pos)
