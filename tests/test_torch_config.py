"""Port parity: the port's YAML reader against PyYAML and the JAX package's
``load_config``. Every file under ``config/`` must load to the same
``ExperimentConfig`` field values, of the same Python types; YAML outside
the supported subset must raise a ``ValueError`` naming the line."""

import dataclasses
from pathlib import Path

import pytest
import yaml

from conan_fgw_tpu.train import config as jconfig
from conan_fgw_tpu_torch.train import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "config").rglob("*.yaml"))


def test_fields_match_the_jax_config():
    assert [f.name for f in dataclasses.fields(tconfig.ExperimentConfig)] == [
        f.name for f in dataclasses.fields(jconfig.ExperimentConfig)]
    assert tconfig.EXPERIMENTS == {k: tconfig.ExperimentSpec(**dataclasses.asdict(v))
                                   for k, v in jconfig.EXPERIMENTS.items()}


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(p.relative_to(ROOT)))
def test_repo_config_loads_as_in_jax(path):
    text = path.read_text()
    assert tconfig.parse_yaml(text, str(path)) == yaml.safe_load(text)
    got = dataclasses.asdict(tconfig.load_config(str(path)))
    want = dataclasses.asdict(jconfig.load_config(str(path)))
    assert got == want
    for key in want:
        assert type(got[key]) is type(want[key]), key


@pytest.mark.parametrize("line", [
    "a: 1", "a: -2", "a: +3", "a: 0", "a: 1.5", "a: 0.0001", "a: -1.5e-3", "a: 1.", "a: .5",
    "a: true", "a: False", "a: yes", "a: off", "a: ~", "a: null", "a:", "a: 'x y'",
    "a: 'it''s'", 'a: "q"', "a: plain text", "a: x#y", "a: 1 # comment",
    "a: conan_fgw.src.experiments.SOTAExperiment", "a: ['sol250']", "a: [1, 'b', c]", "a: []",
    "a: {min_delta: 0.0001, patience: 50}", "# only a comment",
])
def test_scalars_resolve_as_pyyaml(line):
    assert tconfig.parse_yaml(line) == (yaml.safe_load(line) or {})


@pytest.mark.parametrize("text", [
    "a:\n  b: 1",  # block mapping
    "a:\n- 1",  # block sequence
    "- x",
    "a: 1e-4",  # a string in YAML 1.1
    "a: 0x10",
    "a: 007",  # octal in YAML 1.1
    "a: 1_000",
    "a: .inf",
    "a: 2020-01-01",  # a timestamp
    "a: [1, [2]]",
    "a: {b: {c: 1}}",
    "a: [1, 2",
    "a: &anchor 1",
    "a: !!str 1",
    "---\na: 1",
    "a: 1\na: 2",  # repeated key
    "a: {b 1}",
    "a: 'open",
    "a:b",
    "a: x: y",
    "a: \"esc\\n\"",
])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError, match=r"cfg\.yaml:\d"):
        tconfig.parse_yaml(text, "cfg.yaml")


def test_load_config_names_the_file(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("dataset_name: ['sol250']\nearly_stopping:\n  patience: 5\n")
    with pytest.raises(ValueError, match="bad.yaml:3"):
        tconfig.load_config(str(p))
