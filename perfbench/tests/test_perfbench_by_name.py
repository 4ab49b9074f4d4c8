"""A cell, a traffic mix, a configuration and a metric are added by
adding files and entries, which the harness finds by their names."""

import json

from perfbench import manifest
from perfbench.tests import tiny


def test_added_cell_found_by_name(tmp_path):
    root = tiny.copy_checkout(tmp_path)
    man = json.loads((root / "BENCHMARK.json").read_text())
    mix = dict(tiny.SERVE_MIX, keep_per_frame=3)
    (root / "perfbench" / "traffic" / "cam720_sparse.json").write_text(json.dumps(mix))
    (root / "perfbench" / "limits" / "m_seg_serve_sparse.json").write_text(
        json.dumps(dict(tiny.SERVE_LIMITS)))
    man["workloads"].append({"name": "m_seg_serve_sparse", "config": "dfine_m_seg_640",
                             "traffic": "cam720_sparse", "chips": 1, "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "l_det_serve_cam" in m.get("workloads", []):
            m["workloads"].append("m_seg_serve_sparse")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.cell("m_seg_serve_sparse", root)
    assert cell["mix"]["keep_per_frame"] == 3
    assert cell["config_spec"]["name"] == "dfine_m_seg_640"
    assert {m["name"] for m in cell["end_to_end"]} == {"serve_p50_ms", "serve_p95_ms", "setup_s"}
    assert "serve.mfu" in {m["name"] for m in cell["per_layer"]}


def test_added_config_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    cell = manifest.cell("tiny_train", root)
    assert cell["config_spec"]["program_size"] == "n" and cell["mix"]["batch"] == 2


def test_metric_reader_found_by_name():
    rec = {"kind": "serve_stream", "latency_s": [0.010 * i for i in range(1, 22)], "setup_s": 4.0}
    assert abs(manifest.reader("serve_p95_ms")(rec) - 200.0) < 1e-9
    assert manifest.reader("setup_s")(rec) == 4.0
    assert manifest.reader("train_img_per_s")(rec) is None
