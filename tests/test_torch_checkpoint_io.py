"""The port's safetensors reader and writer (``utils/safetensors_io.py``)
and its HF-layout import and export (``utils/torch_import.py``,
``utils/torch_export.py``) against the ``safetensors`` package and the JAX
package's ``torch_import`` / ``torch_export``, on the CPU.

Every comparison is exact: the files hold the same bytes either way, and
both importers take each value through float32 and cast it once.
"""

import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from block_transformer_tpu import config as jax_config
from block_transformer_tpu.models import block_transformer as jax_bt
from block_transformer_tpu.utils import torch_export as jax_export
from block_transformer_tpu.utils import torch_import as jax_import
from block_transformer_tpu_torch import bridge
from block_transformer_tpu_torch import config as torch_config
from block_transformer_tpu_torch.models import block_transformer as bt
from block_transformer_tpu_torch.utils import safetensors_io
from block_transformer_tpu_torch.utils import torch_export
from block_transformer_tpu_torch.utils import torch_import

st_numpy = pytest.importorskip("safetensors.numpy")

DTYPES = ["float32", "float16", "bfloat16", "int64", "int32", "int8",
          "uint8"]


def _array(dtype: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return np.asarray(rng.integers(info.min, info.max, shape,
                                       endpoint=True, dtype=dtype))
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    return np.asarray(rng.standard_normal(shape) * 3).astype(dt)


def _bits(x) -> np.ndarray:
    """The raw bytes of an array or tensor, shape kept (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.reshape(-1).view(torch.uint8).numpy() if x.numel() else \
            np.zeros((0,), np.uint8)
        return x
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tensors(dtype: str):
    return {"a": _array(dtype, (3, 5), 0), "b.c": _array(dtype, (7,), 1),
            "scalar": _array(dtype, (), 2), "empty": _array(dtype, (0, 4), 3)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_writer_is_read_back_by_safetensors(tmp_path, dtype):
    arrays = _tensors(dtype)
    path = str(tmp_path / "x.safetensors")
    safetensors_io.save_file(
        {k: _tensor(v) for k, v in arrays.items()},
        path, metadata={"format": "pt"})
    back = st_numpy.load_file(path)
    assert sorted(back) == sorted(arrays)
    for k, v in arrays.items():
        assert back[k].dtype.name == v.dtype.name and back[k].shape == v.shape
        np.testing.assert_array_equal(_bits(back[k]), _bits(v))


@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_reads_safetensors_output(tmp_path, dtype):
    arrays = _tensors(dtype)
    path = str(tmp_path / "x.safetensors")
    st_numpy.save_file(arrays, path)
    got = safetensors_io.load_file(path)
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert tuple(got[k].shape) == v.shape
        assert got[k].dtype == _tensor(v).dtype
        np.testing.assert_array_equal(_bits(got[k]), _bits(v))


def test_writer_takes_numpy_bf16_and_reader_refuses_a_short_file(tmp_path):
    a = _array("bfloat16", (4, 4), 5)
    path = str(tmp_path / "x.safetensors")
    safetensors_io.save_file({"w": a}, path)
    np.testing.assert_array_equal(_bits(safetensors_io.load_file(path)["w"]),
                                  _bits(a))
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) - 2)
    with pytest.raises(ValueError):
        safetensors_io.load_file(path)


def _cfgs():
    kw = dict(vocab_size=96)
    return (jax_config.make_block_config("t", 64, 2, **kw),
            torch_config.make_block_config("t", 64, 2, **kw))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _assert_trees_equal(port_tree, jax_tree, dtype):
    got = dict(_leaves(port_tree))
    want = dict(_leaves(jax.device_get(jax_tree)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == dtype and g.is_contiguous(), path
        np.testing.assert_array_equal(bridge.tensor_to_numpy(g),
                                      np.asarray(w), err_msg=str(path))


@pytest.fixture(scope="module")
def jax_tree():
    cfg, _ = _cfgs()
    return jax.device_get(jax_bt.init_block_transformer_params(
        jax.random.PRNGKey(4), cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_imports_jax_export_as_jax_does(tmp_path, jax_tree, dtype):
    cfg, tcfg = _cfgs()
    out = jax_export.export_block_transformer(jax_tree, cfg, str(tmp_path))
    want = jax_import.load_checkpoint(out, cfg, dtype=getattr(jnp, dtype))
    got = torch_import.load_checkpoint(out, tcfg,
                                       dtype=getattr(torch, dtype),
                                       device="cpu")
    _assert_trees_equal(got, want, getattr(torch, dtype))


def test_jax_imports_port_export(tmp_path, jax_tree):
    cfg, tcfg = _cfgs()
    params = bridge.params_from_numpy(jax_tree, "cpu")
    out = torch_export.export_block_transformer(params, tcfg, str(tmp_path))
    for comp in ("embedder", "block_decoder", "token_decoder"):
        assert os.path.isfile(os.path.join(out, comp, "config.json"))
    back = jax_import.load_checkpoint(out, cfg, dtype=jnp.float32)
    _assert_trees_equal(params, back, torch.float32)
    with open(os.path.join(out, "block_transformer_config.json")) as f:
        assert torch_config.BlockTransformerConfig.from_json(f.read()) == tcfg


def test_port_export_reimports_bit_for_bit_in_bf16(tmp_path):
    _, tcfg = _cfgs()
    params = bt.init_block_transformer_params(3, tcfg, dtype=torch.bfloat16,
                                              device="cpu")
    out = torch_export.export_block_transformer(params, tcfg, str(tmp_path))
    back = torch_import.load_checkpoint(out, tcfg, dtype=torch.bfloat16,
                                        device="cpu")
    for (pa, a), (pb, b) in zip(_leaves(params), _leaves(back)):
        assert pa == pb and torch.equal(a, b), pa


def test_export_state_dicts_equal_jax(jax_tree):
    cfg, tcfg = _cfgs()
    params = bridge.params_from_numpy(jax_tree, "cpu")
    pairs = [
        (torch_export.embedder_state_dict(params["embedder"]),
         jax_export.embedder_state_dict(jax_tree["embedder"])),
        (torch_export.neox_state_dict(params["block_decoder"],
                                      tcfg.block_decoder,
                                      with_embed_in=False,
                                      with_lm_head=False),
         jax_export.neox_state_dict(jax_tree["block_decoder"],
                                    cfg.block_decoder, with_embed_in=False,
                                    with_lm_head=False)),
        (torch_export.token_decoder_state_dict(params["token_decoder"],
                                               tcfg.token_decoder),
         jax_export.token_decoder_state_dict(jax_tree["token_decoder"],
                                             cfg.token_decoder)),
    ]
    for got, want in pairs:
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert torch_export._neox_hf_config(tcfg.block_decoder) == \
        jax_export._neox_hf_config(cfg.block_decoder)


def test_per_component_and_combined_layouts_agree(tmp_path, jax_tree):
    cfg, tcfg = _cfgs()
    params = bridge.params_from_numpy(jax_tree, "cpu")
    per = torch_export.export_block_transformer(params, tcfg,
                                                str(tmp_path / "per"))
    combined = {}
    for comp in ("embedder", "block_decoder", "token_decoder"):
        sd = safetensors_io.load_file(os.path.join(per, comp,
                                                   "model.safetensors"))
        combined.update({f"{comp}.{k}": v for k, v in sd.items()})
    step = tmp_path / "checkpoint-7"
    step.mkdir()
    safetensors_io.save_file(combined, str(step / "model.safetensors"))
    a = torch_import.load_checkpoint(per, tcfg, dtype=torch.float32,
                                     device="cpu")
    b = torch_import.load_checkpoint(str(step), tcfg, dtype=torch.float32,
                                     device="cpu")
    want = jax_import.load_checkpoint(str(step), cfg, dtype=jnp.float32)
    _assert_trees_equal(a, want, torch.float32)
    _assert_trees_equal(b, want, torch.float32)


@functools.cache
def _hf_state_dicts():
    """Tiny HF modules' state dicts (transformers' own key names) for the
    family converters."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    rob = transformers.RobertaModel(transformers.RobertaConfig(
        vocab_size=120, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256,
        max_position_embeddings=64, type_vocab_size=1, pad_token_id=1),
        add_pooling_layer=False)
    t5 = transformers.T5Model(transformers.T5Config(
        vocab_size=96, d_model=64, d_kv=16, d_ff=256, num_layers=2,
        num_heads=4, relative_attention_num_buckets=32,
        feed_forward_proj="relu"))
    neo = transformers.GPTNeoForCausalLM(transformers.GPTNeoConfig(
        vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=256, max_position_embeddings=64, window_size=4,
        attention_types=[[["global", "local"], 1]]))
    return {k: {n: t.detach() for n, t in m.state_dict().items()}
            for k, m in (("roberta", rob), ("t5", t5), ("gpt_neo", neo))}


@pytest.mark.parametrize("family", ["roberta", "t5 encoder", "t5 decoder",
                                    "gpt_neo"])
def test_family_converters_equal_jax(family):
    sd = _hf_state_dicts()[family.split()[0]]
    if family == "roberta":
        got = torch_import.roberta_params_from_state_dict(sd, 2,
                                                          device="cpu")
        want = jax_import.roberta_params_from_state_dict(sd, 2)
    elif family == "gpt_neo":
        got = torch_import.gpt_neo_params_from_state_dict(sd, 2,
                                                          device="cpu")
        want = jax_import.gpt_neo_params_from_state_dict(sd, 2)
    else:
        dec = family == "t5 decoder"
        prefix = "decoder." if dec else "encoder."
        got = torch_import.t5_stack_params_from_state_dict(
            sd, 2, is_decoder=dec, prefix=prefix, device="cpu")
        want = jax_import.t5_stack_params_from_state_dict(
            sd, 2, is_decoder=dec, prefix=prefix)
    _assert_trees_equal(got, want, torch.float32)


def test_neox_converter_in_bf16_equals_jax(tmp_path):
    """A vanilla GPT-NeoX tree written in the HF layout as bf16 tensors:
    read and converted to bf16, it equals JAX's converter."""
    vcfg = jax_config.NeoXConfig(vocab_size=96, hidden_size=64,
                                 num_layers=2, num_heads=4,
                                 intermediate_size=256,
                                 max_position_embeddings=64)
    tvcfg = torch_config.NeoXConfig(**vars(vcfg))
    from block_transformer_tpu.models import vanilla as jax_vanilla
    vp = jax.device_get(jax_vanilla.init_vanilla_params(
        jax.random.PRNGKey(2), vcfg))
    sd = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16)
          for k, v in jax_export.neox_state_dict(vp, vcfg).items()}
    d = str(tmp_path / "tiny_vanilla")
    torch_export._write_component(d, sd, jax_export._neox_hf_config(vcfg))
    got = torch_import.neox_params_from_state_dict(
        torch_import._load_safetensors_dir(d), tvcfg, dtype=torch.bfloat16,
        device="cpu")
    want = jax_import.neox_params_from_state_dict(
        {k: v.float().numpy() for k, v in sd.items()}, vcfg,
        dtype=jnp.bfloat16)
    _assert_trees_equal(got, want, torch.bfloat16)


def test_export_entry_point_on_the_cpu(tmp_path):
    """``export_checkpoint.py --cpu`` writes the latest port checkpoint's
    parameters, which JAX's importer reads back leaf for leaf."""
    from block_transformer_tpu_torch import export_checkpoint
    from block_transformer_tpu_torch.train import train_step as ts
    from block_transformer_tpu_torch.utils import checkpoint as ckpt
    tcfg = torch_config.get_config("block_main_b4_5", vocab_size=96)
    cfg = jax_config.get_config("block_main_b4_5", vocab_size=96)
    run = str(tmp_path / "run")
    for step in (3, 5):
        params = bt.init_block_transformer_params(step, tcfg, device="cpu")
        ckpt.save_checkpoint(run, step, ts.TrainState(params, None, step))
    out = export_checkpoint.main(["--run_dir", run, "--out",
                                  str(tmp_path / "hf"), "--vocab_size", "96",
                                  "--cpu"])
    back = jax_import.load_checkpoint(out, cfg, dtype=jnp.float32)
    _assert_trees_equal(params, back, torch.float32)
