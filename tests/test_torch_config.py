"""Port parity: the run configuration (hypad_tpu_torch.utils.config) against
the JAX package's, and the port's flat-YAML reader against PyYAML's
``yaml.safe_load``, on the CPU."""

import math
from pathlib import Path

import pytest
import yaml

from hypad_tpu.utils import config as jcfg
from hypad_tpu_torch.utils import config as tcfg

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs")
                 .glob("*.yaml"))

# scalar and list cases, each read by both readers; PyYAML's YAML 1.1 rules
# make 5e-4 and 1.0e3 strings (a float needs a dot and a signed exponent)
YAML_CASES = [
    "lr: 5e-4", "lr: 1.0e-3", "lr: 0.0005", "lr: 1.0e3", "lr: 1.5E+3",
    "lr: 1_0.5", "lr: .5", "lr: 5.", "lr: -.5", "lr: -.inf", "lr: +.INF",
    "n: 010", "n: 08", "n: 0x1F", "n: 0b101", "n: 0o17", "n: 1_000",
    "n: +1", "n: -0", "n: 00", "n: 1e3",
    "a: True", "a: true", "a: False", "a: yes", "a: Off", "a: on",
    "a: null", "a: Null", "a: ~", "a:", "a: # only a comment",
    "s: 'MSL'", "s: \"C-2\"", "s: 'it''s'", "s: 'a # b'", "s: \"x # y\"",
    "s: x#y", "s: hello world  # trailing", "s: 'q'   # c",
    "s: ./data", "s: /srv/corpus/data   # a path",
    "a: 1\na: 2",
    "l:\n  - 'a'\n  - b  # c\n  - 3\nn: 1",
    "l:   # comment on the key\n- x\n- 'y'\n",
    "l:\n  -\n  - ~\n",
    "", "# nothing but a comment\n\n",
    "a: 1\r\nb: 'two'\r\n",
]

REFUSED = [
    "a:\n  b: 1", "a: {b: 1}", "a: [1, 2]", "a: &anchor 1", "a: *anchor",
    "a: !!str 1", "a: |\n  text", "a: >\n  text", "a: 1:30", "a: 2001-12-14",
    "'a': 1", "a: b: c", "- 1", "a: 1\n- 2", "a:\n  - 1\n    - 2",
    "---\na: 1", "a: \"x\\n\"", "a: 'x' y", "a:\n  - b: 1", "yes: 1",
    "a: 1\n  continued", "\ta: 1",
]


def _same(got, want):
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_flat_yaml_reads_every_shipped_config_as_pyyaml(path):
    text = path.read_text()
    assert tcfg.parse_flat_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_matches_jax_on_every_shipped_config(path):
    assert vars(tcfg.load_config(str(path))) == vars(
        jcfg.load_config(str(path)))


@pytest.mark.parametrize("text", YAML_CASES)
def test_flat_yaml_scalars_and_lists_match_pyyaml(text):
    got, want = tcfg.parse_flat_yaml(text), yaml.safe_load(text)
    if want is None:
        assert got is None
        return
    assert list(got) == list(want)
    for key in want:
        if isinstance(want[key], list):
            assert len(got[key]) == len(want[key])
            assert all(_same(g, w) for g, w in zip(got[key], want[key]))
        else:
            assert _same(got[key], want[key]), (got[key], want[key])


def test_flat_yaml_keeps_pyyaml_number_quirks():
    assert tcfg.parse_flat_yaml("lr: 5e-4") == {"lr": "5e-4"}
    assert tcfg.parse_flat_yaml("lr: 1.0e-3") == {"lr": 0.001}


@pytest.mark.parametrize("text", REFUSED)
def test_flat_yaml_raises_on_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        tcfg.parse_flat_yaml(text)


def test_constants_match_jax():
    assert tcfg.DEFAULTS == jcfg.DEFAULTS
    assert tcfg.VALID_COMBINATIONS == jcfg.VALID_COMBINATIONS
    assert tcfg.VALID_REC_ERRORS == jcfg.VALID_REC_ERRORS
    assert tcfg.EUCLIDEAN_COMBINATIONS == jcfg.EUCLIDEAN_COMBINATIONS


@pytest.mark.parametrize("override", [
    {"artifact_dtype": "bf16"}, {"fused_critics": "yes"},
    {"artifact_set": "tiny"}, {"combination": "max"},
    {"hyperbolic": False, "combination": "uncertainty"},
    {"rec_error": "l2"}, {"batch_size": 0}, {"epochs": -1},
])
def test_validate_raises_jax_messages(override):
    with pytest.raises(ValueError) as want:
        jcfg.load_config(dict(override))
    with pytest.raises(ValueError) as got:
        tcfg.load_config(dict(override))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("override", [
    {}, {"hyperbolic": False}, {"signal": "multivariate"},
    {"lr": "5e-4", "epochs": 2, "output_root": "/tmp/x"},
    {"dataset": "A1", "signal": "real_1"},
])
def test_run_dir_matches_jax(override):
    assert tcfg.run_dir(tcfg.load_config(dict(override))) == jcfg.run_dir(
        jcfg.load_config(dict(override)))


def test_lr_spelling_reaches_the_run_dir_as_in_jax(tmp_path):
    """``lr: 5e-4`` is a string under both readers, so the run directory
    holds ``5e-4``; ``lr: 0.0005`` gives ``0.0005``."""
    for text, part in (("lr: 5e-4\n", "_5e-4"), ("lr: 0.0005\n", "_0.0005")):
        path = tmp_path / "cfg.yaml"
        path.write_text(text)
        got = tcfg.run_dir(tcfg.load_config(str(path)))
        assert got == jcfg.run_dir(jcfg.load_config(str(path)))
        assert f"models_hyper_MSL_40{part}" in got
