"""Import reference (PyTorch/HF) checkpoints into the port's parameter trees
(port of ``block_transformer_tpu/utils/torch_import.py``).

Handles the reference's two on-disk layouts (SURVEY.md §5.4):

- per-component HF ``save_pretrained`` dirs ``{embedder,block_decoder,
  token_decoder}/model.safetensors`` (pretrain_block_transformer.py:145-155),
- HF ``Trainer`` combined checkpoints ``checkpoint-<step>/model.safetensors``
  with ``embedder.`` / ``block_decoder.`` / ``token_decoder.`` name prefixes.

Layout conversions (torch stores Linear weights ``[out, in]``; the tree
stores ``[in, out]``; HF's fused QKV interleaves per head as ``(head, q|k|v,
dim)`` while the tree uses ``(q|k|v, head, dim)`` — see models/neox.py).
Every value goes through float32 and is cast once to ``dtype``, as in the
JAX package; the files are read by the port's own reader
(``utils/safetensors_io.py``). A state dict may hold tensors or numpy
arrays. Leaves are contiguous tensors on ``device``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import torch

from block_transformer_tpu_torch.config import (BlockTransformerConfig,
                                                NeoXConfig,
                                                TokenDecoderConfig)
from block_transformer_tpu_torch.utils import safetensors_io


def _f32(x) -> torch.Tensor:
    """A float32 CPU tensor of a state-dict value."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float()
    return safetensors_io.cpu_tensor(x).float()


def _leaf(x: torch.Tensor, dtype, device) -> torch.Tensor:
    return x.to(dtype).contiguous().to(device)


def _convert_qkv_weight(w, num_heads: int, head_dim: int) -> torch.Tensor:
    """HF [3h, h] with row order (head, qkv, dim) -> ours [h, 3h] with column
    order (qkv, head, dim)."""
    h = num_heads * head_dim
    w = _f32(w).reshape(num_heads, 3, head_dim, h)
    return w.permute(3, 1, 0, 2).reshape(h, 3 * h)


def _convert_qkv_bias(b, num_heads: int, head_dim: int) -> torch.Tensor:
    b = _f32(b).reshape(num_heads, 3, head_dim)
    return b.permute(1, 0, 2).reshape(3 * num_heads * head_dim)


def _stack(tree, dtype, device):
    """Lists of per-layer tensors -> stacked ``[L, ...]`` leaves."""
    if isinstance(tree, dict):
        return {k: _stack(v, dtype, device) for k, v in tree.items()}
    return _leaf(torch.stack(tree), dtype, device)


def _stack_layers(layers, dtype, device):
    """A list of per-layer trees -> one tree of stacked leaves."""
    def gather(nodes):
        if isinstance(nodes[0], dict):
            return {k: gather([n[k] for n in nodes]) for k in nodes[0]}
        return nodes
    return _stack(gather(layers), dtype, device)


def neox_params_from_state_dict(sd: Mapping[str, object], cfg: NeoXConfig,
                                *, prefix: str = "", with_embed_in=True,
                                with_lm_head=True, dtype=torch.float32,
                                device="cuda"):
    """Convert a GPTNeoXForCausalLM-style state dict to the stacked tree."""
    H, D = cfg.num_heads, cfg.head_dim
    g = prefix + "gpt_neox."

    def get(name):
        return _f32(sd[name])

    layers = []
    for i in range(cfg.num_layers):
        l = f"{g}layers.{i}."
        layers.append({
            "ln1": {"scale": get(l + "input_layernorm.weight"),
                    "bias": get(l + "input_layernorm.bias")},
            "ln2": {"scale": get(l + "post_attention_layernorm.weight"),
                    "bias": get(l + "post_attention_layernorm.bias")},
            "attn": {
                "qkv": {"kernel": _convert_qkv_weight(
                            sd[l + "attention.query_key_value.weight"], H, D),
                        "bias": _convert_qkv_bias(
                            sd[l + "attention.query_key_value.bias"], H, D)},
                "out": {"kernel": get(l + "attention.dense.weight").T,
                        "bias": get(l + "attention.dense.bias")}},
            "mlp": {"up": {"kernel": get(l + "mlp.dense_h_to_4h.weight").T,
                           "bias": get(l + "mlp.dense_h_to_4h.bias")},
                    "down": {"kernel": get(l + "mlp.dense_4h_to_h.weight").T,
                             "bias": get(l + "mlp.dense_4h_to_h.bias")}},
        })
    params = {
        "layers": _stack_layers(layers, dtype, device),
        "final_ln": {"scale": _leaf(get(g + "final_layer_norm.weight"),
                                    dtype, device),
                     "bias": _leaf(get(g + "final_layer_norm.bias"), dtype,
                                   device)},
    }
    if with_embed_in:
        params["embed_in"] = {
            "weight": _leaf(get(g + "embed_in.weight"), dtype, device)}
    if with_lm_head:
        params["embed_out"] = {
            "kernel": _leaf(get(prefix + "embed_out.weight").T, dtype,
                            device)}
    return params


def embedder_params_from_state_dict(sd: Mapping[str, object], *,
                                    prefix: str = "", dtype=torch.float32,
                                    device="cuda"):
    params = {"embeddings": {
        "weight": _leaf(_f32(sd[prefix + "embeddings.weight"]), dtype,
                        device)}}
    conv_key = prefix + "projection_layer.weight"
    if conv_key in sd:
        w = _f32(sd[conv_key])            # [ph, hidden, k]
        params["projection"] = {
            "kernel": _leaf(w.permute(2, 1, 0), dtype, device),
            "bias": _leaf(_f32(sd[prefix + "projection_layer.bias"]), dtype,
                          device)}
    return params


def token_decoder_params_from_state_dict(sd, cfg: TokenDecoderConfig, *,
                                         prefix: str = "",
                                         dtype=torch.float32, device="cuda"):
    params = neox_params_from_state_dict(sd, cfg.neox, prefix=prefix,
                                         with_embed_in=True, with_lm_head=True,
                                         dtype=dtype, device=device)
    exp_key = prefix + "expansion_layer.weight"
    if exp_key in sd:
        w = _f32(sd[exp_key])             # [h*ratio, ph, 1] (Conv1d k=1)
        params["expansion"] = {
            "kernel": _leaf(w[:, :, 0].T, dtype, device),
            "bias": _leaf(_f32(sd[prefix + "expansion_layer.bias"]), dtype,
                          device)}
    return params


def roberta_params_from_state_dict(sd: Mapping[str, object], num_layers: int,
                                   *, prefix: str = "", dtype=torch.float32,
                                   device="cuda"):
    """HF RobertaModel state dict -> models/roberta.py tree."""
    def get(name):
        return _f32(sd[prefix + name])

    def dense(name):
        return {"kernel": get(name + ".weight").T, "bias": get(name + ".bias")}

    def ln(name):
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias")}

    layers = []
    for i in range(num_layers):
        l = f"encoder.layer.{i}."
        layers.append({
            "attn": {"q": dense(l + "attention.self.query"),
                     "k": dense(l + "attention.self.key"),
                     "v": dense(l + "attention.self.value"),
                     "out": dense(l + "attention.output.dense")},
            "attn_ln": ln(l + "attention.output.LayerNorm"),
            "mlp": {"up": dense(l + "intermediate.dense"),
                    "down": dense(l + "output.dense")},
            "mlp_ln": ln(l + "output.LayerNorm"),
        })
    one = lambda x: _leaf(x, dtype, device)              # noqa: E731
    return {
        "word_embeddings": {"weight": one(get(
            "embeddings.word_embeddings.weight"))},
        "position_embeddings": {"weight": one(get(
            "embeddings.position_embeddings.weight"))},
        "token_type_embeddings": {"weight": one(get(
            "embeddings.token_type_embeddings.weight"))},
        "embed_ln": {"scale": one(get("embeddings.LayerNorm.weight")),
                     "bias": one(get("embeddings.LayerNorm.bias"))},
        "layers": _stack_layers(layers, dtype, device),
    }


def t5_stack_params_from_state_dict(sd: Mapping[str, object],
                                    num_layers: int, *, is_decoder: bool,
                                    prefix: str = "", dtype=torch.float32,
                                    device="cuda"):
    """HF T5Stack state dict (e.g. ``encoder.`` / ``decoder.`` sub-tree of a
    T5Model) -> models/t5.py tree. T5 linears have no bias; kernels
    transpose to [in, out]."""
    def get(name):
        return _f32(sd[prefix + name])

    def dense(name):
        return {"kernel": get(name + ".weight").T}

    def attn(b):
        return {w: dense(f"{b}.{w}") for w in ("q", "k", "v", "o")}

    layers = []
    for i in range(num_layers):
        b = f"block.{i}."
        p = {"self_attn": attn(b + "layer.0.SelfAttention"),
             "self_ln": {"scale": get(b + "layer.0.layer_norm.weight")}}
        if is_decoder:
            p["cross_attn"] = attn(b + "layer.1.EncDecAttention")
            p["cross_ln"] = {"scale": get(b + "layer.1.layer_norm.weight")}
            ff = b + "layer.2."
        else:
            ff = b + "layer.1."
        p["mlp"] = {"wi": dense(ff + "DenseReluDense.wi"),
                    "wo": dense(ff + "DenseReluDense.wo")}
        p["mlp_ln"] = {"scale": get(ff + "layer_norm.weight")}
        layers.append(p)
    one = lambda x: _leaf(x, dtype, device)              # noqa: E731
    params = {
        "layers": _stack_layers(layers, dtype, device),
        "rel_bias": {"weight": one(get(
            "block.0.layer.0.SelfAttention.relative_attention_bias.weight"))},
        "final_ln": {"scale": one(get("final_layer_norm.weight"))},
    }
    emb_key = prefix + "embed_tokens.weight"
    if emb_key in sd:
        params["embed"] = {"weight": one(_f32(sd[emb_key]))}
    elif "shared.weight" in sd:
        params["embed"] = {"weight": one(_f32(sd["shared.weight"]))}
    return params


def block_transformer_params_from_state_dict(sd, cfg: BlockTransformerConfig,
                                             dtype=torch.float32,
                                             device="cuda"):
    """Combined Trainer-checkpoint state dict (prefixed component names)."""
    return {
        "embedder": embedder_params_from_state_dict(
            sd, prefix="embedder.", dtype=dtype, device=device),
        "block_decoder": neox_params_from_state_dict(
            sd, cfg.block_decoder, prefix="block_decoder.",
            with_embed_in=False, with_lm_head=False, dtype=dtype,
            device=device),
        "token_decoder": token_decoder_params_from_state_dict(
            sd, cfg.token_decoder, prefix="token_decoder.", dtype=dtype,
            device=device),
    }


def _load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Load all *.safetensors under a dir into one state dict of CPU
    tensors."""
    sd: Dict[str, torch.Tensor] = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".safetensors"):
            sd.update(safetensors_io.load_file(os.path.join(path, fn)))
    if not sd:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return sd


def load_checkpoint(path: str, cfg: BlockTransformerConfig,
                    dtype=torch.bfloat16, device="cuda"):
    """Load either checkpoint layout from ``path``.

    Per-component layout: path contains embedder/ block_decoder/
    token_decoder/ subdirs. Combined layout: path contains model.safetensors
    with prefixed keys.
    """
    if os.path.isdir(os.path.join(path, "embedder")):
        return {
            "embedder": embedder_params_from_state_dict(
                _load_safetensors_dir(os.path.join(path, "embedder")),
                dtype=dtype, device=device),
            "block_decoder": neox_params_from_state_dict(
                _load_safetensors_dir(os.path.join(path, "block_decoder")),
                cfg.block_decoder, with_embed_in=False, with_lm_head=False,
                dtype=dtype, device=device),
            "token_decoder": token_decoder_params_from_state_dict(
                _load_safetensors_dir(os.path.join(path, "token_decoder")),
                cfg.token_decoder, dtype=dtype, device=device),
        }
    sd = _load_safetensors_dir(path)
    return block_transformer_params_from_state_dict(sd, cfg, dtype=dtype,
                                                    device=device)


def gpt_neo_params_from_state_dict(sd, num_layers: int, *, prefix: str = "",
                                   dtype=torch.float32, device="cuda"):
    """HF GPTNeoForCausalLM/GPTNeoModel state dict -> models/gpt_neo.py tree."""
    g = prefix + ("transformer." if any(k.startswith(prefix + "transformer.")
                                        for k in sd) else "")

    def get(name):
        return _f32(sd[g + name])

    def dense(name, bias=True):
        p = {"kernel": get(name + ".weight").T}
        if bias:
            p["bias"] = get(name + ".bias")
        return p

    def ln(name):
        return {"scale": get(name + ".weight"), "bias": get(name + ".bias")}

    layers = []
    for i in range(num_layers):
        b = f"h.{i}."
        layers.append({
            "ln1": ln(b + "ln_1"),
            "ln2": ln(b + "ln_2"),
            "attn": {
                "q": dense(b + "attn.attention.q_proj", bias=False),
                "k": dense(b + "attn.attention.k_proj", bias=False),
                "v": dense(b + "attn.attention.v_proj", bias=False),
                "out": dense(b + "attn.attention.out_proj"),
            },
            "mlp": {"up": dense(b + "mlp.c_fc"),
                    "down": dense(b + "mlp.c_proj")},
        })
    one = lambda x: _leaf(x, dtype, device)              # noqa: E731
    return {
        "layers": _stack_layers(layers, dtype, device),
        "final_ln": {"scale": one(get("ln_f.weight")),
                     "bias": one(get("ln_f.bias"))},
        "wte": {"weight": one(get("wte.weight"))},
        "wpe": {"weight": one(get("wpe.weight"))},
    }
