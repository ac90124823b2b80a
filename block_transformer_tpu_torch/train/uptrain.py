"""Uptraining initialization: seed a block transformer from a pretrained
vanilla GPT-NeoX (port of ``block_transformer_tpu/train/uptrain.py``,
model/utils.py:231-343 semantics).

Layer mappings: ``skip`` (block/token decoder layer i <- vanilla layer 2i,
which needs the vanilla depth to be twice the target's), ``partition``
(the block decoder takes the first ``block_layers`` vanilla layers, the
token decoder the last ``token_layers``), ``duplicate`` (both take all
vanilla layers). Options: the mean projection init (the strided-conv
embedder projection = the mean of the block's token embeddings), the
identity expansion init (each of the ``expansion_ratio`` output slots =
identity), and ``compute_token_decoder_embeddings`` (the token decoder's
input embeddings = the block decoder's outputs over single-token inputs).
The two initialized layers' kernels take the vanilla tree's dtype and
their biases are float32 zeros, as in the JAX package.

Every leaf of the result is a tensor of its own (a copy where JAX shares
the vanilla array): the train step updates parameters in place, and a
tensor shared by two leaves would take both updates.
"""

from __future__ import annotations

import numpy as np
import torch

from block_transformer_tpu_torch.config import BlockTransformerConfig, NeoXConfig
from block_transformer_tpu_torch.models import neox
from block_transformer_tpu_torch.ops import masks
from block_transformer_tpu_torch.train import optimizer as opt


def _copy(tree):
    return opt.tree_map(lambda a: a.clone(), tree)


def _layer_slice(stacked, idx: np.ndarray):
    return opt.tree_map(lambda a: a[torch.as_tensor(idx, device=a.device)],
                        stacked)


def _layer_indices(method: str, vanilla_layers: int, target_layers: int,
                   role: str) -> np.ndarray:
    if method == "skip":
        if target_layers * 2 != vanilla_layers:
            raise ValueError(f"skip requires vanilla depth = 2x target "
                             f"({vanilla_layers} vs {target_layers})")
        return np.arange(target_layers) * 2
    if method == "partition":
        if role == "block":
            return np.arange(target_layers)
        return np.arange(target_layers) + (vanilla_layers - target_layers)
    if method == "duplicate":
        if target_layers != vanilla_layers:
            raise ValueError("duplicate requires equal depth")
        return np.arange(target_layers)
    raise ValueError(f"invalid method {method!r}")


@torch.no_grad()
def load_block_from_vanilla(block_params, cfg: BlockTransformerConfig,
                            vanilla_params, vanilla_cfg: NeoXConfig,
                            method: str = "partition",
                            initialize_mean_embedder_projection: bool = False,
                            initialize_identity_expansion_layer: bool = False,
                            compute_token_decoder_embeddings: bool = False):
    """A new block-transformer parameter tree seeded from the vanilla one;
    the leaves it does not set are ``block_params``' own tensors."""
    out = dict(block_params)
    bd_cfg, td_cfg = cfg.block_decoder, cfg.token_decoder.neox
    vl = vanilla_cfg.num_layers
    embed_in = vanilla_params["embed_in"]["weight"]

    # embedder embeddings <- vanilla input embeddings
    out["embedder"] = dict(out["embedder"])
    out["embedder"]["embeddings"] = {"weight": embed_in.clone()}

    if initialize_mean_embedder_projection:
        # strided-conv projection = mean over the block's tokens (identity
        # per channel scaled 1/block_length); meant for a projection_layer
        # embedder whose hidden equals the projection hidden
        ksz = cfg.block_length // cfg.n_embedding_tokens
        h = cfg.embedder.hidden_size
        ph = cfg.embedder.projection_hidden_size
        eye = torch.eye(h, ph, dtype=torch.float32, device=embed_in.device)
        kern = (eye / cfg.block_length)[None].repeat(ksz, 1, 1)
        out["embedder"]["projection"] = {
            "kernel": kern.to(embed_in.dtype),
            "bias": torch.zeros((ph,), device=embed_in.device)}

    # block decoder layers
    bidx = _layer_indices(method, vl, bd_cfg.num_layers, "block")
    out["block_decoder"] = dict(out["block_decoder"])
    out["block_decoder"]["layers"] = _layer_slice(vanilla_params["layers"],
                                                  bidx)

    # token decoder
    tidx = _layer_indices(method, vl, td_cfg.num_layers, "token")
    out["token_decoder"] = dict(out["token_decoder"])
    out["token_decoder"]["layers"] = _layer_slice(vanilla_params["layers"],
                                                  tidx)
    out["token_decoder"]["final_ln"] = _copy(vanilla_params["final_ln"])
    out["token_decoder"]["embed_out"] = _copy(vanilla_params["embed_out"])

    if compute_token_decoder_embeddings:
        # embed_in[v] <- block_decoder(embed_in[v] as a length-1 sequence)
        emb = out["embedder"]["embeddings"]["weight"][:, None, :]  # [V, 1, h]
        zero = torch.zeros((1,), dtype=torch.int32, device=emb.device)
        hidden, _ = neox.neox_stack(out["block_decoder"], emb, cfg=bd_cfg,
                                    mask=masks.causal_mask(zero, zero),
                                    positions=zero)
        out["token_decoder"]["embed_in"] = {"weight": hidden[:, 0, :]
                                            .contiguous()}
    else:
        out["token_decoder"]["embed_in"] = {"weight": embed_in.clone()}

    if initialize_identity_expansion_layer:
        h = td_cfg.hidden_size
        ph = cfg.embedder.projection_hidden_size
        eye = torch.eye(ph, h, dtype=torch.float32, device=embed_in.device)
        kern = torch.cat([eye] * cfg.expansion_ratio, dim=1)  # [ph, h*ratio]
        out["token_decoder"]["expansion"] = {
            "kernel": kern.to(embed_in.dtype),
            "bias": torch.zeros((h * cfg.expansion_ratio,),
                                device=embed_in.device)}
    return out
