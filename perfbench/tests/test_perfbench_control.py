"""The control, the reference in fp8 put in the program's place, comes out
not correct at a tiny size under the tiny cells' limits; and the program in float32
agrees with the reference on the CPU (the frozen copy follows the port)."""

from perfbench import judge, manifest
from perfbench.tests import tiny

SEED = 2147483655


def _cells(tmp_path):
    root = tiny.make_root(tmp_path)
    return manifest.cell("tiny_serve", root), manifest.cell("tiny_train", root)


def test_serving_control_fails_and_program_agrees(tmp_path):
    cell, _ = _cells(tmp_path)
    ((seed, res),) = manifest.kind(cell["mix"]["kind"]).calibrate(cell, [SEED], 1.0, (), "cpu")
    assert seed == SEED
    assert not judge.verdict(_numbers(res["control"]), cell["limits"])[0], res["control"]
    p = res["program"]
    assert p["unmatched_share"] == 0 and p["box_gap_median_px"] < 1e-2, p
    assert p["score_gap_median"] < 1e-4, p


def test_training_control_fails_and_program_agrees(tmp_path):
    _, cell = _cells(tmp_path)
    ((_, res),) = manifest.kind(cell["mix"]["kind"]).calibrate(cell, [SEED], 0.0, (), "cpu")
    assert not judge.verdict(_numbers(res["control"]), cell["limits"])[0], res["control"]
    p = res["program"]
    assert p["loss_gap"] < 1e-4 and p["grad_gap_q90"] < 1e-3 and p["change_gap_median"] < 1e-3, p


def _numbers(res):
    return {k: v for k, v in res.items() if k not in ("kept_mean", "nonempty_masks", "losses")}
