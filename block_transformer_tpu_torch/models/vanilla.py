"""Vanilla GPT-NeoX causal LM, the baseline family ``vanilla_31`` ..
``vanilla_410`` (port of ``block_transformer_tpu/models/vanilla.py``).

The head-to-head baseline of the Block Transformer: one NeoX stack over
token positions with a token-level KV cache. The cached forwards write the
new K/V into the given cache in place (``neox.neox_stack``) and return a
cache tuple that shares its buffers.
"""

from __future__ import annotations

import torch

from block_transformer_tpu_torch.config import NeoXConfig
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import masks


def init_vanilla_params(gen, cfg: NeoXConfig, dtype=torch.float32,
                        device="cuda"):
    """Random parameters drawn from ``gen``: a ``torch.Generator`` on
    ``device``, or an int seed for a new one."""
    if isinstance(gen, int):
        gen = torch.Generator(device=device).manual_seed(gen)
    return neox.init_neox_params(gen, cfg, with_embed_in=True,
                                 with_lm_head=True, dtype=dtype,
                                 device=device)


def vanilla_forward(params, cfg: NeoXConfig, input_ids: torch.Tensor,
                    attention_mask=None, remat: bool = False) -> torch.Tensor:
    """input_ids [B, S] -> logits [B, S, V] float32; ``remat`` checkpoints
    each layer (``neox.neox_stack``)."""
    S = input_ids.shape[1]
    x = neox.embed_tokens(params, input_ids)
    positions = torch.arange(S, dtype=torch.int32, device=input_ids.device)
    mask = masks.causal_mask(positions, positions, kv_valid=attention_mask)
    hidden, _ = neox.neox_stack(params, x, cfg=cfg, mask=mask,
                                positions=positions, remat=remat)
    return neox.lm_logits(params, hidden)


def vanilla_loss(params, cfg: NeoXConfig, input_ids: torch.Tensor,
                 attention_mask, labels: torch.Tensor,
                 remat: bool = False) -> torch.Tensor:
    """The shifted cross-entropy (labels -100 and unattended positions
    ignored), a float32 scalar. ``remat=True`` checkpoints each layer so
    the backward recomputes attention instead of keeping every layer's
    [B, H, S, S] probabilities."""
    logits = vanilla_forward(params, cfg, input_ids, attention_mask,
                             remat=remat)
    lg = logits[:, :-1].float()
    tgt = labels[:, 1:].long()
    w = (tgt != -100).float()
    if attention_mask is not None:
        w = w * attention_mask[:, 1:].float()
    logp = torch.log_softmax(lg, dim=-1)
    ll = torch.gather(logp, -1, tgt.clamp(min=0)[..., None])[..., 0]
    return torch.sum(-ll * w) / torch.clamp(torch.sum(w), min=1.0)


@torch.no_grad()
def vanilla_prefill(params, cfg: NeoXConfig, input_ids: torch.Tensor, cache,
                    attention_mask=None):
    """Prefill the cache with a prompt [B, S]; returns (last-position logits
    [B, V], cache)."""
    B, S = input_ids.shape
    device = input_ids.device
    x = neox.embed_tokens(params, input_ids)
    capacity = cache.k.shape[3]
    kv_valid = None
    if attention_mask is not None:
        pad = torch.zeros((B, capacity - S), dtype=attention_mask.dtype,
                          device=device)
        kv_valid = torch.cat([attention_mask, pad], dim=1)
    mask = masks.decode_mask(cache.length, capacity, S, kv_valid,
                             device=device)
    positions = cache.length + torch.arange(S, dtype=torch.int32,
                                            device=device)
    hidden, cache = neox.neox_stack(params, x, cfg=cfg, mask=mask,
                                    positions=positions, cache=cache)
    return neox.lm_logits(params, hidden[:, -1, :]), cache


@torch.no_grad()
def vanilla_decode_step(params, cfg: NeoXConfig, token_ids: torch.Tensor,
                        cache):
    """token_ids [B] -> (logits [B, V], cache)."""
    device = token_ids.device
    x = neox.embed_tokens(params, token_ids[:, None])
    mask = masks.decode_mask(cache.length, cache.k.shape[3], 1, device=device)
    positions = cache.length + torch.arange(1, dtype=torch.int32,
                                            device=device)
    hidden, cache = neox.neox_stack(params, x, cfg=cfg, mask=mask,
                                    positions=positions, cache=cache)
    return neox.lm_logits(params, hidden[:, -1, :]), cache
