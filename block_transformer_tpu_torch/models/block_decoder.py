"""Block decoder: coarse autoregressive self-attention over block
embeddings (port of ``block_transformer_tpu/models/block_decoder.py``).

A GPT-NeoX stack (the main family) or a GPT-Neo one (``cls="gpt-neo"``:
learned positions, global and local layers, the local band ``window``
blocks wide) with no token embedding and no LM head; the block-causal mask
lets every embedding token of block i attend through block i. Returns the
final-normed hidden states.

Also the auxiliary block-decoding loss: the hidden state at block i should
predict block i+1's input embedding, by MSE or by an InfoNCE contrast at
temperature 0.07, in float32.
"""

from __future__ import annotations

import torch

from block_transformer_tpu_torch.config import NeoXConfig
from block_transformer_tpu_torch.models import gpt_neo as gn
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import masks


def _gpt_neo_cfg(cfg: NeoXConfig, window: int) -> gn.GPTNeoConfig:
    return gn.GPTNeoConfig(vocab_size=cfg.vocab_size,
                           hidden_size=cfg.hidden_size,
                           num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                           intermediate_size=cfg.intermediate_size,
                           max_position_embeddings=cfg.max_position_embeddings,
                           window_size=window,
                           pad_token_id=cfg.pad_token_id,
                           eos_token_id=cfg.eos_token_id)


def init_block_decoder_params(gen: torch.Generator, cfg: NeoXConfig,
                              dtype=torch.float32, device="cuda",
                              cls: str = "gpt-neo-x", window: int = 256):
    if cls == "gpt-neo":
        return gn.init_gpt_neo_params(gen, _gpt_neo_cfg(cfg, window),
                                      with_embed=True, with_lm_head=False,
                                      dtype=dtype, device=device)
    return neox.init_neox_params(gen, cfg, with_embed_in=False,
                                 with_lm_head=False, dtype=dtype,
                                 device=device)


def block_decoder_forward(params, cfg: NeoXConfig, inputs_embeds,
                          block_attention_mask, n_embedding_tokens: int,
                          remat: bool = False, cls: str = "gpt-neo-x",
                          window: int = 256):
    """inputs_embeds [B, N * n_emb, hidden]; block_attention_mask [B, N];
    ``remat`` checkpoints each layer of a GPT-NeoX stack
    (``neox.neox_stack``)."""
    if cls == "gpt-neo":
        return gn.gpt_neo_block_decoder_forward(
            params, _gpt_neo_cfg(cfg, window), inputs_embeds,
            block_attention_mask, n_embedding_tokens)
    S = inputs_embeds.shape[1]
    mask = masks.block_decoder_train_mask(block_attention_mask,
                                          n_embedding_tokens)
    positions = torch.arange(S, dtype=torch.int32, device=inputs_embeds.device)
    hidden, _ = neox.neox_stack(params, inputs_embeds, cfg=cfg, mask=mask,
                                positions=positions, remat=remat)
    return hidden


def block_decoding_loss(hidden_states, inputs_embeds, block_attention_mask,
                        n_embedding_tokens: int,
                        loss_type: str = "contrastive") -> torch.Tensor:
    """hidden_states / inputs_embeds [B, N * n_emb, h]; block_attention_mask
    [B, N]. ``loss_type``: "mse" or "contrastive"; no gradient flows into
    the targets."""
    n = n_embedding_tokens
    attn = block_attention_mask.repeat_interleave(n, dim=1)    # [B, S]
    label_mask = attn[:, n:, None].float()
    h = hidden_states[:, :-n, :].float() * label_mask
    y = inputs_embeds[:, n:, :].detach().float() * label_mask
    hs = h.reshape(-1, h.shape[-1])
    ys = y.reshape(-1, y.shape[-1])
    if loss_type == "mse":
        return (hs - ys).square().mean()
    if loss_type == "contrastive":
        hs = hs / (torch.linalg.vector_norm(hs, dim=-1, keepdim=True) + 1e-12)
        ys = ys / (torch.linalg.vector_norm(ys, dim=-1, keepdim=True) + 1e-12)
        logits = (hs @ ys.t()) / 0.07
        logits = logits - logits.amax(dim=-1, keepdim=True).detach()
        log_prob = logits - torch.log(torch.exp(logits).sum(dim=1,
                                                            keepdim=True))
        return -torch.diagonal(log_prob).mean()
    raise ValueError(f"unknown block_decoding_loss_type {loss_type!r}")
