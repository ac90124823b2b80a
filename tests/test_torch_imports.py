"""The port imports neither JAX nor the JAX package, nor ``safetensors``.

Every ``.py`` file of ``block_transformer_tpu_torch/`` and ``chip_smoke.py``
is parsed with ``ast`` (nothing is imported), and each ``import`` and
``from ... import`` statement anywhere in it, at any depth, is checked: no
``jax`` or ``jaxlib`` module, no ``block_transformer_tpu`` module other
than the port's own package, nothing of the JAX package's ``scripts/``
or of its benchmark ``bench.py`` (the port keeps its own copies), and no
``safetensors`` module (the card has
no such package: the port reads and writes the format itself).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted([*(ROOT / "block_transformer_tpu_torch").rglob("*.py"),
                ROOT / "chip_smoke.py"])
PORT = "block_transformer_tpu_torch"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "safetensors", "scripts", "bench") or (
        top.startswith("block_transformer_tpu") and top != PORT)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_the_walk_finds_the_port():
    names = {f.relative_to(ROOT).as_posix() for f in FILES}
    assert "chip_smoke.py" in names
    assert f"{PORT}/inference/engine.py" in names
    assert f"{PORT}/kernels/paged_attention.py" in names
    assert f"{PORT}/models/vanilla.py" in names


def test_the_check_catches_what_it_forbids():
    tree = ast.parse("import os\nif x:\n    import jax.numpy as jnp\n"
                     "def f():\n    from block_transformer_tpu.ops import q\n"
                     "from block_transformer_tpu_torch import bridge\n"
                     "from scripts.build_real_task_fixtures import x\n"
                     "from block_transformer_tpu_torch.scripts import y\n"
                     "import bench as B\nimport benchmarks\n")
    bad = [m for _, m in _imports(tree) if _forbidden(m)]
    assert sorted(bad) == ["bench", "block_transformer_tpu.ops", "jax.numpy",
                           "scripts.build_real_task_fixtures"]


def test_the_check_catches_safetensors():
    tree = ast.parse("def f():\n    from safetensors.numpy import load_file\n"
                     "import safetensors_io_like\n")
    assert [m for _, m in _imports(tree) if _forbidden(m)] == [
        "safetensors.numpy"]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line} imports {m}" for line, m in _imports(tree)
           if _forbidden(m)]
    assert not bad, bad


def test_the_walk_finds_the_training_and_gptq_modules():
    names = {f.relative_to(ROOT).as_posix() for f in FILES}
    for module in ("train/optimizer.py", "train/train_step.py",
                   "data/packing.py", "ops/gptq.py"):
        assert f"{PORT}/{module}" in names


@pytest.mark.parametrize("module", [
    "config_yaml.py", "data/native.py", "data/block_split.py",
    "data/mmap_dataset.py", "data/tokenizer.py",
    "data/retokenized_corpus.py", "data/streaming.py", "data/dispatch.py",
    "utils/checkpoint.py", "train/trainer.py", "train/vanilla_trainer.py",
    "train/uptrain.py", "pretrain_block_transformer.py",
    "pretrain_vanilla_transformer.py"])
def test_the_walk_finds_the_training_loop_modules(module):
    names = {f.relative_to(ROOT).as_posix() for f in FILES}
    assert f"{PORT}/{module}" in names


@pytest.mark.parametrize("module", [
    "eval/harness.py", "eval/samplers.py", "eval/filters.py",
    "eval/caching.py", "eval/tasks.py", "eval/byte_tasks.py",
    "eval/adapters.py", "eval/longctx.py", "train/eval_callback.py",
    "utils/safetensors_io.py", "utils/torch_import.py",
    "utils/torch_export.py", "utils/hbm.py", "utils/roofline.py",
    "utils/profiling.py", "utils/run_id.py", "eval_zero_shot_task.py",
    "eval_longctx.py", "export_checkpoint.py"])
def test_the_walk_finds_the_eval_and_utils_modules(module):
    names = {f.relative_to(ROOT).as_posix() for f in FILES}
    assert f"{PORT}/{module}" in names


@pytest.mark.parametrize("module", [
    "scripts/__init__.py", "scripts/build_byte_corpus.py",
    "scripts/quality_run.py", "scripts/decode_gate.py",
    "scripts/gate_seed_summary.py", "scripts/gptq_gate.py",
    "scripts/qat_finetune.py", "scripts/qat_ppl_gate.py",
    "scripts/kv_quality_cpu.py", "scripts/longctx_quality_cpu.py",
    "scripts/real_task_eval.py"])
def test_the_walk_finds_the_quality_scripts(module):
    names = {f.relative_to(ROOT).as_posix() for f in FILES}
    assert f"{PORT}/{module}" in names


@pytest.mark.parametrize("module", [
    "scripts/inference_demo.py", "scripts/measure_generation_time.py",
    "scripts/train_mfu.py", "scripts/train_ckpt.py",
    "scripts/longctx_85m.py", "scripts/kv_scheme_probe.py",
    "scripts/bench_packer.py", "scripts/retokenize_corpus.py",
    "scripts/build_longctx_assets.py", "scripts/build_real_task_fixtures.py",
    "scripts/build_pg_corpus.py"])
def test_the_walk_finds_the_entry_scripts(module):
    names = {f.relative_to(ROOT).as_posix() for f in FILES}
    assert f"{PORT}/{module}" in names


@pytest.mark.parametrize("module", [
    "scripts/w8a8_probe.py", "scripts/w8a8_probe2.py",
    "scripts/w8a8_probe3.py", "scripts/int4kv_probe.py",
    "scripts/w8a8_decode_gate.py", "scripts/kernel_microbench.py",
    "scripts/prefill_profile.py", "scripts/mixed48_stage_probe.py",
    "scripts/paged_admit_probe.py", "scripts/engine_cpu_ratio.py"])
def test_the_walk_finds_the_speed_probes(module):
    names = {f.relative_to(ROOT).as_posix() for f in FILES}
    assert f"{PORT}/{module}" in names
