"""The weight bridge (JAX variables -> port) and the port's import rule."""

import ast
import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_helpers import jax_template_shapes, port_model_from, random_variables

REPO = Path(__file__).resolve().parents[1]
UPCONV = "params/decoder/pixel_decoder/upconv/kernel"


@pytest.fixture(scope="module")
def variables():
    _, shapes = jax_template_shapes("n", 3, True)
    return random_variables(shapes, seed=11)


def test_bridge_is_strict(variables):
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.utils.checkpoint import load_jax_variables

    extra = copy.deepcopy(variables)
    extra["params"]["decoder"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_variables(build_model("n", 3, True, device="cpu"), extra)

    missing = copy.deepcopy(variables)
    del missing["params"]["decoder"]["enc_score_head"]["bias"]
    with pytest.raises(KeyError, match="enc_score_head"):
        load_jax_variables(build_model("n", 3, True, device="cpu"), missing)

    wrong = copy.deepcopy(variables)
    wrong["params"]["decoder"]["enc_score_head"]["kernel"] = np.zeros((5, 5), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(build_model("n", 3, True, device="cpu"), wrong)

    # a port model built for other classes cannot take these weights
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(build_model("n", 4, True, device="cpu"), variables)


def test_bridge_round_trip_through_reference_importer(variables):
    """JAX -> port -> dfine_tpu.utils.checkpoint.load_torch_checkpoint gives
    back every leaf exactly, except the pixel decoder's ConvTranspose.
    There the JAX importer maps torch [in, out, kh, kw] with a plain
    transpose(2, 3, 1, 0): it swaps in and out and drops the spatial flip
    that flax's unflipped ConvTranspose needs. So the leaf comes back as
    K[::-1, ::-1] with in and out swapped, not K: the importer is not the
    inverse of the bridge for this key (it loads only because in == out)."""
    from flax import traverse_util

    from dfine_tpu.utils.checkpoint import load_torch_checkpoint

    port = port_model_from(variables, "n", 3, True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = load_torch_checkpoint(sd, variables, verbose=False, strict=True)
    flat_in = traverse_util.flatten_dict(variables, sep="/")
    flat_back = traverse_util.flatten_dict(back, sep="/")
    assert set(flat_in) == set(flat_back)
    for k, v in flat_in.items():
        if k != UPCONV:
            np.testing.assert_array_equal(np.asarray(flat_back[k]), v, err_msg=k)
    k_in, k_back = flat_in[UPCONV], np.asarray(flat_back[UPCONV])
    np.testing.assert_array_equal(k_back, k_in[::-1, ::-1].transpose(0, 1, 3, 2))
    assert np.abs(k_back - k_in).max() > 0


def test_upconv_mapping_matches_flax_conv_transpose():
    """torch conv_transpose2d with the bridge's weight equals flax
    nn.ConvTranspose (2x2, stride 2, VALID) on the same input."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from dfine_tpu_torch.utils.checkpoint import jax_to_port

    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 3, 4, 5)).astype(np.float32)  # NHWC, 5 channels
    k = rng.normal(size=(2, 2, 5, 6)).astype(np.float32)
    layer = nn.ConvTranspose(6, (2, 2), strides=(2, 2), padding="VALID", use_bias=False)
    ref = np.asarray(layer.apply({"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x)))
    w = torch.from_numpy(np.ascontiguousarray(jax_to_port(k, "conv", conv_transpose=True)))
    ours = torch.nn.functional.conv_transpose2d(torch.from_numpy(x.transpose(0, 3, 1, 2)), w,
                                                stride=2)
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), ref, atol=1e-5)


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cv2", "yaml", "dfine_tpu")
# imported lazily, inside the one function that uses each, never by an import
LAZY = ("PIL", "matplotlib", "gradio")
# every command-line entry point of the port (python -m dfine_tpu_torch.<name>)
ENTRY_POINTS = tuple(f"dfine_tpu_torch.{m}" for m in (
    "apps.train", "apps.export", "apps.infer", "apps.bench", "apps.check_errors", "apps.quant",
    "apps.test_batching", "apps.demo", "etl.split", "etl.coco_yolo", "etl.mask_tools",
    "etl.preprocess"))
# data parallelism and the flat optimizer: torch and the standard library only
PARALLEL = ("dfine_tpu_torch.parallel", "dfine_tpu_torch.parallel.dp",
            "dfine_tpu_torch.train.flat_optim")
# the kernels' wrappers and _build.py (the deformable-attention forward and
# backward, the scatters, the solver) and the deform core: the same rule
KERNELS = ("dfine_tpu_torch.ops.deform_attn", "dfine_tpu_torch.ops.kernels",
           "dfine_tpu_torch.ops.kernels._build", "dfine_tpu_torch.ops.kernels.deform_attn",
           "dfine_tpu_torch.ops.kernels.scatter_rows", "dfine_tpu_torch.ops.kernels.hungarian")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port (every entry point of
    ENTRY_POINTS and the modules of PARALLEL and KERNELS included) loads
    nothing of FORBIDDEN and nothing of LAZY."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dfine_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dfine_tpu_torch.__path__, "
        "'dfine_tpu_torch.')]\n"
        f"missing = set({ENTRY_POINTS + PARALLEL + KERNELS!r}) - set(names)\n"
        "assert not missing, missing\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + LAZY!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_name_no_forbidden_import():
    files = sorted((REPO / "dfine_tpu_torch").rglob("*.py"))
    assert {".".join(f.relative_to(REPO).with_suffix("").parts) for f in files} >= \
        set(ENTRY_POINTS)
    files += [REPO / name for name in ("chip_smoke.py", "chip_hungarian_ab.py",
                                       "chip_deform_bwd_ab.py")]
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert not {f: b for f, b in bad.items() if b}
    stdlib = set(sys.stdlib_module_names)
    for name in PARALLEL + KERNELS:
        path = REPO / Path(*name.split(".")).with_suffix(".py")
        if not path.exists():
            path = path.with_suffix("") / "__init__.py"
        assert set(_imported_roots(path)) <= stdlib | {"torch", "__future__"}, name
