"""Export the port's parameter trees to the reference's HF checkpoint layout
(port of ``block_transformer_tpu/utils/torch_export.py``).

Inverse of utils/torch_import.py for the main (GPT-NeoX) family: writes
the per-component ``save_pretrained``-style directories the reference
produces at the end of training (pretrain_block_transformer.py:145-155):

    <out>/embedder/model.safetensors        (+ config.json)
    <out>/block_decoder/model.safetensors
    <out>/token_decoder/model.safetensors

so a checkpoint trained here round-trips through the reference tooling and
through ``utils/torch_import.load_checkpoint``. Weight-layout conversions
mirror the import exactly: Linear kernels transpose to torch [out, in]; the
fused QKV permutes from the tree's (q|k|v, head, dim) column order to HF's
(head, q|k|v, dim) row order. Every tensor is written in float32, as the
JAX package writes it, through the port's own writer
(``utils/safetensors_io.py``).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from block_transformer_tpu_torch.config import (BlockTransformerConfig,
                                                NeoXConfig,
                                                TokenDecoderConfig)
from block_transformer_tpu_torch.utils import safetensors_io


def _f32(x) -> torch.Tensor:
    return x.detach().float().cpu()


def _qkv_weight_to_hf(w, num_heads: int, head_dim: int) -> torch.Tensor:
    """ours [h, 3h] cols (qkv, head, dim) -> HF [3h, h] rows (head, qkv, dim)."""
    h = num_heads * head_dim
    w = _f32(w).reshape(h, 3, num_heads, head_dim)
    return w.permute(2, 1, 3, 0).reshape(3 * h, h)


def _qkv_bias_to_hf(b, num_heads: int, head_dim: int) -> torch.Tensor:
    b = _f32(b).reshape(3, num_heads, head_dim)
    return b.permute(1, 0, 2).reshape(3 * num_heads * head_dim)


def neox_state_dict(params, cfg: NeoXConfig, *, prefix: str = "",
                    with_embed_in: bool = True,
                    with_lm_head: bool = True) -> Dict[str, torch.Tensor]:
    """The stacked tree -> GPTNeoXForCausalLM-style state dict."""
    H, D = cfg.num_heads, cfg.head_dim
    g = prefix + "gpt_neox."
    layers = params["layers"]
    if "kernel" not in layers["attn"]["qkv"]:
        raise ValueError("export requires full-precision kernels "
                         "(quantized trees cannot round-trip to HF)")
    sd: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        l = f"{g}layers.{i}."
        sd[l + "input_layernorm.weight"] = _f32(layers["ln1"]["scale"][i])
        sd[l + "input_layernorm.bias"] = _f32(layers["ln1"]["bias"][i])
        sd[l + "post_attention_layernorm.weight"] = _f32(
            layers["ln2"]["scale"][i])
        sd[l + "post_attention_layernorm.bias"] = _f32(
            layers["ln2"]["bias"][i])
        sd[l + "attention.query_key_value.weight"] = _qkv_weight_to_hf(
            layers["attn"]["qkv"]["kernel"][i], H, D)
        sd[l + "attention.query_key_value.bias"] = _qkv_bias_to_hf(
            layers["attn"]["qkv"]["bias"][i], H, D)
        sd[l + "attention.dense.weight"] = _f32(
            layers["attn"]["out"]["kernel"][i]).T
        sd[l + "attention.dense.bias"] = _f32(layers["attn"]["out"]["bias"][i])
        sd[l + "mlp.dense_h_to_4h.weight"] = _f32(
            layers["mlp"]["up"]["kernel"][i]).T
        sd[l + "mlp.dense_h_to_4h.bias"] = _f32(layers["mlp"]["up"]["bias"][i])
        sd[l + "mlp.dense_4h_to_h.weight"] = _f32(
            layers["mlp"]["down"]["kernel"][i]).T
        sd[l + "mlp.dense_4h_to_h.bias"] = _f32(
            layers["mlp"]["down"]["bias"][i])
    sd[g + "final_layer_norm.weight"] = _f32(params["final_ln"]["scale"])
    sd[g + "final_layer_norm.bias"] = _f32(params["final_ln"]["bias"])
    if with_embed_in and "embed_in" in params:
        sd[g + "embed_in.weight"] = _f32(params["embed_in"]["weight"])
    if with_lm_head and "embed_out" in params:
        sd[prefix + "embed_out.weight"] = _f32(params["embed_out"]["kernel"]).T
    return sd


def embedder_state_dict(params, *, prefix: str = "") -> Dict[str, torch.Tensor]:
    sd = {prefix + "embeddings.weight": _f32(params["embeddings"]["weight"])}
    if "projection" in params:
        # ours [k, hidden, ph] -> torch Conv1d [ph, hidden, k]
        sd[prefix + "projection_layer.weight"] = _f32(
            params["projection"]["kernel"]).permute(2, 1, 0)
        sd[prefix + "projection_layer.bias"] = _f32(params["projection"]["bias"])
    return sd


def token_decoder_state_dict(params, cfg: TokenDecoderConfig, *,
                             prefix: str = "") -> Dict[str, torch.Tensor]:
    sd = neox_state_dict(params, cfg.neox, prefix=prefix)
    if "expansion" in params:
        # ours [ph, h*ratio] -> torch Conv1d(k=1) [h*ratio, ph, 1]
        sd[prefix + "expansion_layer.weight"] = _f32(
            params["expansion"]["kernel"]).T[:, :, None]
        sd[prefix + "expansion_layer.bias"] = _f32(params["expansion"]["bias"])
    return sd


def _neox_hf_config(cfg: NeoXConfig) -> dict:
    return {
        "model_type": "gpt_neox",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rotary_pct": cfg.rotary_pct,
        "rotary_emb_base": cfg.rope_theta,
        "layer_norm_eps": cfg.layer_norm_eps,
        "use_parallel_residual": cfg.use_parallel_residual,
        "hidden_act": "gelu",
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": cfg.eos_token_id,
    }


def _write_component(out_dir: str, sd: Dict[str, torch.Tensor], config: dict):
    os.makedirs(out_dir, exist_ok=True)
    # the writer makes each (transposed) tensor contiguous as it writes it
    safetensors_io.save_file(sd, os.path.join(out_dir, "model.safetensors"),
                             metadata={"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


def export_block_transformer(params, cfg: BlockTransformerConfig,
                             out_dir: str) -> str:
    """Write the reference per-component HF layout under ``out_dir``."""
    _write_component(
        os.path.join(out_dir, "embedder"),
        embedder_state_dict(params["embedder"]),
        {"model_type": "lookup_embedder",
         "vocab_size": cfg.embedder.vocab_size,
         "hidden_size": cfg.embedder.hidden_size,
         "n_embedding_tokens": cfg.embedder.n_embedding_tokens,
         "projection_method": cfg.embedder.projection_method,
         "projection_hidden_size": cfg.embedder.projection_hidden_size,
         "block_length": cfg.block_length})
    _write_component(
        os.path.join(out_dir, "block_decoder"),
        neox_state_dict(params["block_decoder"], cfg.block_decoder,
                        with_embed_in=False, with_lm_head=False),
        _neox_hf_config(cfg.block_decoder))
    _write_component(
        os.path.join(out_dir, "token_decoder"),
        token_decoder_state_dict(params["token_decoder"], cfg.token_decoder),
        {**_neox_hf_config(cfg.token_decoder.neox),
         "decoding_strategy": cfg.token_decoder.decoding_strategy,
         "expansion_ratio": cfg.token_decoder.expansion_ratio})
    with open(os.path.join(out_dir, "block_transformer_config.json"), "w") as f:
        f.write(cfg.to_json())
    return out_dir
