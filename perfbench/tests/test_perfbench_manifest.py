"""BENCHMARK.json against the benchmark's contract, and every name it
gives found as a file."""

import json
import re

import pytest

from perfbench import manifest
from perfbench.manifest import ROOT

MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert all(TEXT.match(w) for w in MAN["command"]) and len(MAN["command"]) <= 32
    assert MAN["paths"] == ["perfbench"]
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_texts():
    entries = MAN["configs"] + MAN["workloads"] + MAN["end_to_end"] + MAN["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", []):
            # the end-to-end metric it moves is reported by each of its cells
            assert manifest.reports(e2e[m["moves"]], cell), (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough_and_every_config_is_used():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for w in MAN["workloads"]:
        cell = manifest.cell(w["name"])
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell["per_layer"], w["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    c = manifest.cell(cell)
    assert (ROOT / "perfbench" / "kinds" / f"{c['mix']['kind']}.py").exists()
    assert set(c["limits"]) >= {"unmatched_share", "box_gap_median_px", "score_gap_median"} or \
        set(c["limits"]) >= {"loss_gap", "grad_gap_median", "grad_gap_q90", "change_gap_median", "ema_gap_median"}
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_config_files_hold_the_program_registry():
    from dfine_tpu_torch.configs import model_config

    for c in MAN["configs"]:
        cfg = manifest.load_json(ROOT / c["file"])
        assert c["file"].startswith("perfbench/")
        reg = model_config(cfg["program_size"])
        for section in ("backbone", "encoder", "decoder"):
            assert cfg[section] == json.loads(json.dumps(reg[section])), (c["name"], section)
