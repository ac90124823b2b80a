"""Block decoder: a GPT-NeoX stack over block embeddings (port of
``block_transformer_tpu/models/block_decoder.py``, NeoX family).

No token embedding and no LM head; the block-causal mask lets every
embedding token of block i attend through block i. Returns the final-normed
hidden states.
"""

from __future__ import annotations

import torch

from block_transformer_tpu_torch.config import NeoXConfig
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import masks


def init_block_decoder_params(gen: torch.Generator, cfg: NeoXConfig,
                              dtype=torch.float32, device="cuda"):
    return neox.init_neox_params(gen, cfg, with_embed_in=False,
                                 with_lm_head=False, dtype=dtype,
                                 device=device)


def block_decoder_forward(params, cfg: NeoXConfig, inputs_embeds,
                          block_attention_mask, n_embedding_tokens: int,
                          remat: bool = False):
    """inputs_embeds [B, N * n_emb, hidden]; block_attention_mask [B, N];
    ``remat`` checkpoints each layer (``neox.neox_stack``)."""
    S = inputs_embeds.shape[1]
    mask = masks.block_decoder_train_mask(block_attention_mask,
                                          n_embedding_tokens)
    positions = torch.arange(S, dtype=torch.int32, device=inputs_embeds.device)
    hidden, _ = neox.neox_stack(params, inputs_embeds, cfg=cfg, mask=mask,
                                positions=positions, remat=remat)
    return hidden
