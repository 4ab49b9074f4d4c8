"""What a run reads by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix, its limits, the code of the mix's kind
and one reader a metric. Nothing here names a cell, a mix or a metric: a
later cell or metric is files and entries, found by the names the manifest
gives them."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Dict[str, Any]:
    """Everything one run of cell ``name`` needs: the manifest's entry, its
    configuration, its traffic mix and its limits (``perfbench/limits/<cell>.json``),
    and the metrics it reports with ``--trace 0`` and with ``--trace 1``."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    out = dict(entry)
    out["config_spec"] = load_json(root / conf["file"])
    out["mix"] = load_json(root / "perfbench" / "traffic" / f"{entry['traffic']}.json")
    out["limits"] = load_json(root / "perfbench" / "limits" / f"{name}.json")
    out["end_to_end"] = [m for m in man["end_to_end"] if reports(m, name)]
    out["per_layer"] = [m for m in man["per_layer"] if reports(m, name, man["end_to_end"])]
    return out


def reports(metric: Dict[str, Any], cell_name: str, end_to_end: List[Dict] = ()) -> bool:
    """Whether ``cell_name`` reports ``metric``: the metric's own
    ``workloads`` where it has them, else every cell that reports the
    end-to-end metric it ``moves`` (every cell, for an end-to-end metric)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in end_to_end if m["name"] == metric["moves"])
        return reports(moved, cell_name)
    return True


def kind(name: str):
    """The module that drives a traffic kind: ``perfbench/kinds/<name>.py``."""
    return importlib.import_module(f"perfbench.kinds.{name}")


def reader(metric: str) -> Callable[[Dict[str, Any]], Any]:
    """``read(record)`` of ``perfbench/metrics/<metric>.py`` (metric names
    hold dots, so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
