"""Without a CUDA card a run fails and prints no result; the check for
JAX in ``sys.modules`` compares whole top-level names."""

import subprocess
import sys

import pytest
import torch

from perfbench import run
from perfbench.manifest import ROOT


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "l_det_serve_cam",
                           "--seed", "2147483649", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "dfine_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dfine_tpu.models", object())
    assert run.forbidden_modules() == ["dfine_tpu"]
