"""The port's config reader (a YAML subset, without yaml) against
PyYAML and the JAX package's ``load_config``."""

import datetime
import math
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parents[1]

# override values as users pass them, and the corners of PyYAML's resolver
OVERRIDE_VALUES = [
    "[640, 640]", "{0: red, 1: blue}", "1e-4", "1.0e-4", "0.000125", "3.0e+2", "1.", ".5", "+5",
    "True", "yes", "off", "False", "null", "~", "", "5", "-3", "017", "08", "0x1F", "0b101",
    "1_000", "1:30", "-1:30.5", ".inf", "-.inf", ".nan", "2024-01-31", "abc", "a b", "a#b", "a #b",
    "'q''s'", '"d\\tq\\u00e9"', "[a, [b, c], {d: e}]", "{a: [1, 2], b: {c: null}}",
    "/data/x/y.pth", "pretrained/dfine_${model_name}_${train.pretrained_dataset}.pth",
    "a: b", "- x", "[]", "{}", "[1, 2,]", "m", "@x", "*x", "!t x", "%x",
]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", ["config.yaml", "config_.yaml"])
def test_reader_matches_pyyaml_on_the_repo_configs(name):
    from dfine_tpu_torch.config import dump_yaml, load_yaml

    text = (REPO / name).read_text()
    tree = load_yaml(text)
    assert tree == yaml.safe_load(text)
    out = dump_yaml(tree)
    assert load_yaml(out) == tree and yaml.safe_load(out) == tree


def test_override_values_match_pyyaml():
    """``_parse_value`` is ``yaml.safe_load`` with the raw text where PyYAML
    raises (the JAX package's ``_parse_value``), value and type alike."""
    from dfine_tpu_torch.config import _parse_value

    for v in OVERRIDE_VALUES:
        try:
            ref = yaml.safe_load(v)
        except yaml.YAMLError:
            ref = v
        assert _same(_parse_value(v), ref), (v, ref, _parse_value(v))


def test_writer_round_trip():
    from dfine_tpu_torch.config import dump_yaml, load_yaml

    tree = {
        "a": [1.5e-07, 1e16, float("inf"), None, True, "x: y", "1e-4", "2024-01-01", "", " s",
              "#c", "q'\"", "yes", "017", datetime.date(2020, 1, 2), -0.0, 3],
        "b": {0: "zero", "k k": {}, "l": [], "m": [{"x": 1}, [1, [2]]], "n": {"deep": {"x": "y"}}},
        3: "ünï\ncode",
        "interp": "${train.lrs.${model_name}.base_lr}",
    }
    out = dump_yaml(tree)
    assert yaml.safe_load(out) == tree
    assert load_yaml(out) == tree


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &x 1", 2), ("a: *x", 1), ("a: !!str 1", 1), ("a: 1\nb: |\n  x", 2),
    ("a: >\n  x", 1), ("a: b\n  c", 2), ("\ta: 1", 1), ("---\na: 1", 1), ("a: [1, 2", 1),
    ("a: 2001-12-14t21:59:43.10-05:00", 1),
])
def test_outside_the_subset_raises_with_its_line(text, line):
    from dfine_tpu_torch.config import YAMLSubsetError, load_yaml

    with pytest.raises(YAMLSubsetError, match=f"line {line}"):
        load_yaml(text)


class _FrozenNow(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


def test_load_config_matches_jax(monkeypatch, tmp_path):
    """Both packages' ``load_config`` on the repo's config with the same
    overrides (nested interpolation, flow values, null) at a frozen now;
    ``save_config``'s file reads back to the same tree on both sides."""
    import dfine_tpu.config as jcfg

    import dfine_tpu_torch.config as pcfg

    for mod in (jcfg, pcfg):
        monkeypatch.setattr(mod.datetime, "datetime", _FrozenNow)
    overrides = ["model_name=l", "task=segment", "train.img_size=[320, 416]",
                 "train.label_to_name={0: red, 1: blue}", "train.epochs=3",
                 "train.pretrained_model_path=", "exp_name=run_${now:%H%M}",
                 "train.base_lr=1.5e-4", "train.new.nested.key=7", "train.use_wandb=False"]
    ours = pcfg.load_config(REPO / "config.yaml", overrides)
    ref = jcfg.load_config(REPO / "config.yaml", overrides)
    assert ours.to_dict() == ref.to_dict()
    assert ours.train.base_lr == 1.5e-4 and ours.train.backbone_lr == 0.00000625
    assert ours.exp == "run_0304_2026-01-02" and ours.train.pretrained_model_path is None
    assert isinstance(ours.train.dp, pcfg.ConfigNode) and ours.train.dp.enabled is False
    pcfg.save_config(ours, tmp_path / "c.yaml")
    assert pcfg.load_config(tmp_path / "c.yaml").to_dict() == ours.to_dict()
    assert jcfg.load_config(tmp_path / "c.yaml").to_dict() == ours.to_dict()
    assert pcfg.cli_config([str(tmp_path / "c.yaml"), "train.epochs=9"]).train.epochs == 9


def test_latest_experiment_dir(tmp_path):
    from dfine_tpu_torch.config import get_latest_experiment_dir

    for name in ("exp_2024-01-01", "exp_2024-03-01", "other_2025-01-01"):
        (tmp_path / name).mkdir()
    assert get_latest_experiment_dir(tmp_path, "exp").name == "exp_2024-03-01"
    with pytest.raises(FileNotFoundError):
        get_latest_experiment_dir(tmp_path, "none")
