"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the reference and the counts import nothing of the program."""

import ast
import json
import subprocess
import sys

from perfbench.manifest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dfine_tpu"}
PB = ROOT / "perfbench"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_and_counts_import_nothing_of_the_program():
    for sub in ("reference", "counts"):
        for path in (PB / sub).rglob("*.py"):
            assert "dfine_tpu_torch" not in _imports(path), path


def test_a_run_loads_none_of_them(tmp_path):
    """A whole run on the CPU in a fresh process, then its sys.modules."""
    code = (
        "import sys, json; from pathlib import Path\n"
        "from perfbench.tests import tiny\nfrom perfbench import run\n"
        f"root = tiny.make_root(Path({str(tmp_path)!r}))\n"
        "run.run(['--workload', 'tiny_serve', '--seed', '4', '--seconds', '1', '--trace', '0'],"
        " device='cpu', root=root)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert "dfine_tpu_torch" in loaded and not loaded & FORBIDDEN
