"""The port's YAML reader and config loaders (``config_yaml.py``) against
PyYAML and the JAX package's loaders, on the CPU.

- ``safe_load`` equals ``yaml.safe_load`` on every ``configs/*.yaml`` (26
  files) and on scalars that YAML 1.1 resolves in ways easy to get wrong
  (``6e-4`` is a string, ``2.0e-4`` a float, ``yes`` a bool, ``017``
  octal); constructs outside the subset raise ``YAMLSubsetError``.
- ``load_block_config_yaml``, ``load_vanilla_config_yaml`` and
  ``load_trainer_kwargs_yaml`` give JAX's dataclasses and kwargs, field for
  field, on every block and vanilla YAML.
All comparisons are exact.
"""

import dataclasses
from pathlib import Path

import pytest
import yaml

from block_transformer_tpu import config_yaml as jax_yaml
from block_transformer_tpu_torch import config_yaml

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
VANILLA = [p for p in CONFIGS if p.name.startswith("vanilla_")]
BLOCK = [p for p in CONFIGS if p not in VANILLA]


def _id(p):
    return p.stem


def test_the_configs_are_all_there():
    assert len(CONFIGS) == 26 and len(VANILLA) == 4


@pytest.mark.parametrize("path", CONFIGS, ids=_id)
def test_safe_load_equals_pyyaml(path):
    text = path.read_text()
    assert config_yaml.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 6e-4", "a: 2.0e-4", "a: 1.0e+3", "a: 1.0e3", "a: .5", "a: -.5e+3",
    "a: 1_000", "a: 0x1f", "a: 017", "a: 0b101", "a: +.inf", "a: -1",
    "a: yes", "a: Off", "a: ~", "a:", "a: null", "a: -x",
    "a: 'x # y'", 'a: "q\\tr"', "a: 'it''s'", "x: a#b",
    "a: {b: {c: 1}, d: , 'e': \"f\"}", "a: {}",
    "a:\n  b:\n    c: 2  # note\n  d: x y\n# top\ne: on\n",
    "", "# only a comment\n",
])
def test_safe_load_resolves_as_pyyaml(text):
    assert config_yaml.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: [1, 2]", "a:\n  - 1\n  - 2", "- 1", "a: &x 1", "a: *x",
    "a: !!str 1", "a: |\n  text", "a: >\n  text", "---\na: 1", "a: 1:30",
    "a: {b: [1]}", "a: {b: 1", "a: 'x", "k: v: w", "a: 1\n  b: 2",
    "a:\n\tb: 1",
])
def test_safe_load_raises_outside_the_subset(text):
    with pytest.raises(config_yaml.YAMLSubsetError):
        config_yaml.safe_load(text)


@pytest.mark.parametrize("path", BLOCK, ids=_id)
def test_block_config_equals_jax(path):
    got = config_yaml.load_block_config_yaml(str(path))
    want = jax_yaml.load_block_config_yaml(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_expanded_emb == want.n_expanded_emb


@pytest.mark.parametrize("path", VANILLA, ids=_id)
def test_vanilla_config_equals_jax(path):
    got = config_yaml.load_vanilla_config_yaml(str(path))
    want = jax_yaml.load_vanilla_config_yaml(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("path", CONFIGS, ids=_id)
def test_trainer_kwargs_equal_jax(path):
    got = config_yaml.load_trainer_kwargs_yaml(str(path))
    assert got == jax_yaml.load_trainer_kwargs_yaml(str(path))
    assert all(type(got[k]) is float for k in
               ("learning_rate", "adam_beta1", "adam_beta2", "weight_decay"))


def test_vanilla_loader_rejects_another_model(tmp_path):
    p = tmp_path / "v.yaml"
    p.write_text("model: llama\nmodel_config: {hidden_size: 64, "
                 "num_hidden_layers: 1}\n")
    with pytest.raises(ValueError):
        config_yaml.load_vanilla_config_yaml(str(p))
