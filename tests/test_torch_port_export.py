"""The port's compiled serving and export on the CPU, n det+seg at 320 px,
fp32: ``AOTModel`` (one fixed-shape program per bucket, the batch padded by
repeating the last image) against ``TorchModel``; ``export_model``'s
``.pt2`` round trip (``torch.export.save`` -> ``load``, in this process and
in a fresh one), the dynamic batch, the npz in JAX's layout and the
custom op the program calls (tests/test_export.py:11 on the JAX side)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_helpers import (align_by_box, jax_template_shapes, port_model_from,
                                     random_variables)

IMG = 320
REPO = Path(__file__).resolve().parents[1]
_CACHE = {}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Re-drawn n det+seg weights as the JAX npz, and ``export_model``'s
    artifacts of them (the serving fold, fp32, on the CPU)."""
    from dfine_tpu.utils.checkpoint import save_params_npz

    from dfine_tpu_torch.export import export_model

    if not _CACHE:
        _, shapes = jax_template_shapes("n", 3, True, IMG)
        variables = random_variables(shapes, seed=41)
        tmp = tmp_path_factory.mktemp("weights")
        save_params_npz(tmp / "n.npz", variables)
        arts = export_model("n", str(tmp / "n.npz"), 3, tmp / "out", input_size=(IMG, IMG),
                            half=False, enable_mask_head=True, device="cpu")
        _CACHE.update(variables=variables, path=str(tmp / "n.npz"), arts=arts)
    yield _CACHE
    _CACHE.clear()


def _frames(n, hw=(240, 300)):
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _same(a, b, hw, masks=True):
    """Two served answers: the same detections (aligned by box: near-tied
    scores may come in another order), scores atol 1e-5, boxes atol 1e-3 px,
    masks equal but for pixels on a binarization edge (<= 1e-4 of them)."""
    assert len(a["scores"]) == len(b["scores"]) > 0
    scale = np.asarray([hw[1], hw[0], hw[1], hw[0]], np.float32)
    match, keep = align_by_box(b["boxes"] / scale, a["boxes"] / scale)
    assert keep.all()
    np.testing.assert_array_equal(a["labels"][match], b["labels"])
    np.testing.assert_allclose(a["scores"][match], b["scores"], atol=1e-5)
    np.testing.assert_allclose(a["boxes"][match], b["boxes"], atol=1e-3)
    assert a["masks"].shape == b["masks"].shape
    if masks:
        assert (a["masks"][match] != b["masks"]).mean() <= 1e-4


def test_aot_model_pads_the_batch_and_keeps_buckets(weights):
    """max_batch_size 3 serving 1 and 2 frames: the answers of the eager
    model on the same frames (scores atol 1e-5: another batch size may take
    other CPU kernels). In rect mode the canonical buckets are programs
    after load, and a frame in one makes no new program."""
    from dfine_tpu_torch import AOTModel, TorchModel
    from dfine_tpu_torch.infer.base import default_rect_buckets
    from dfine_tpu_torch.ops.preprocess import rect_bucket

    kw = dict(conf_thresh=0.3, half=False, enable_mask_head=True, device="cpu")
    eager = TorchModel("n", weights["path"], 3, IMG, IMG, **kw)
    aot = AOTModel("n", weights["path"], 3, IMG, IMG, max_batch_size=3, **kw)
    frames = _frames(2)
    assert list(aot._programs) == [(3, 3, IMG, IMG)]
    for batch in (frames[:1], frames):
        for a, b in zip(aot(batch), eager(batch)):
            _same(a, b, frames[0].shape[:2])
    rect = AOTModel("n", weights["path"], 3, IMG, IMG, max_batch_size=2, rect=True, **kw)
    buckets = {(2, 3, h, w) for h, w in default_rect_buckets((IMG, IMG))}
    assert buckets <= set(rect._programs)
    n = len(rect._programs)
    h, w = default_rect_buckets((IMG, IMG))[1]
    assert rect_bucket(2 * h, 2 * w, (IMG, IMG)) == (h, w)
    rect(_frames(1, (2 * h, 2 * w)))
    assert len(rect._programs) == n


def _decode_np(out):
    return {k: v.detach().float().numpy() for k, v in out.items()}


def test_export_round_trip_and_dynamic_batch(weights):
    """``export_model``: the ``.pt2`` loads and answers as ``TorchModel``'s
    model (the serving fold) on the same input through ``ServingProgram``,
    bit for bit on the CPU; the program calls the custom op;
    ``ExportedModel`` serves the artifact as ``ExportedModel`` without one
    (exported in process), bit for bit, and as ``TorchModel`` (but for the
    masks: the program returns all 300 in f32, where ``TorchModel`` ships
    the top 100 in bf16, as in JAX); the npz holds the JAX variables it
    came from; a dynamic-batch export runs at batch 1 and 3."""
    from flax import traverse_util

    from dfine_tpu_torch import ExportedModel, TorchModel
    from dfine_tpu_torch.export import ServingProgram, make_exported

    arts = weights["arts"]
    assert set(arts) == {"aot", "exported", "npz"} and all(p.exists() for p in arts.values())
    assert "input: (1, 3, 320, 320)" in arts["aot"].read_text()
    with np.load(arts["npz"]) as z:
        flat = traverse_util.flatten_dict(weights["variables"], sep="/")
        assert set(z.files) == set(flat)
        for k in z.files:
            np.testing.assert_array_equal(z[k], flat[k], err_msg=k)

    program = torch.export.load(arts["exported"])
    assert any("dfine_tpu_torch.ms_deform_attn_fwd" in str(n.target)
               for n in program.graph.nodes if n.op == "call_function")
    kw = dict(conf_thresh=0.3, half=False, enable_mask_head=True, device="cpu")
    fused = TorchModel("n", weights["path"], 3, IMG, IMG, **kw)
    x = torch.from_numpy(np.random.default_rng(1).uniform(size=(1, 3, IMG, IMG)).astype(np.float32))
    with torch.no_grad():
        ref = _decode_np(ServingProgram(fused.model)(x))
        ours = _decode_np(program.module()(x))
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    served = ExportedModel("n", None, 3, IMG, IMG, artifact_path=str(arts["exported"]), **kw)
    in_process = ExportedModel("n", weights["path"], 3, IMG, IMG, **kw)
    frame = _frames(1)[0]
    from_file, exported_here = served(frame)[0], in_process(frame)[0]
    for k in from_file:
        np.testing.assert_array_equal(from_file[k], exported_here[k], err_msg=k)
    _same(from_file, fused(frame)[0], frame.shape[:2], masks=False)

    dyn = make_exported(fused.model, (IMG, IMG), dynamic_batch=True).module()
    for b in (1, 3):
        xb = x.expand(b, -1, -1, -1).contiguous()
        with torch.no_grad():
            out, ref_b = _decode_np(dyn(xb)), _decode_np(ServingProgram(fused.model)(xb))
        assert out["boxes"].shape == (b, 300, 4)
        for k in ref_b:
            np.testing.assert_allclose(out[k], ref_b[k], atol=1e-5, err_msg=k)


def test_exported_program_loads_in_a_fresh_process(weights):
    """A process that imports ``dfine_tpu_torch`` (which registers the
    custom op the program calls) loads the ``.pt2`` and runs it."""
    run = ("import sys, torch\n"
           "import dfine_tpu_torch\n"
           "p = torch.export.load(sys.argv[1]).module()\n"
           "out = p(torch.zeros(1, 3, 320, 320))\n"
           "print(tuple(out['boxes'].shape), bool(torch.isfinite(out['scores']).all()))\n")
    proc = subprocess.run([sys.executable, "-c", run, str(weights["arts"]["exported"])],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "(1, 300, 4) True"


def test_custom_op_matches_plain_on_the_cpu():
    """``dfine_tpu_torch::ms_deform_attn_fwd`` on CPU tensors is the plain
    version, bit for bit; its fake gives the shape and type."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd_plain

    rng = np.random.default_rng(0)
    shapes, pts = ((6, 8), (3, 4)), (2, 3)
    value = torch.from_numpy(rng.normal(size=(2, 60, 4, 16)).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (2, 5, 4, 5, 2)).astype(np.float32))
    att = torch.from_numpy(rng.uniform(size=(2, 5, 4, 5)).astype(np.float32))
    flat = [6, 8, 3, 4]
    out = torch.ops.dfine_tpu_torch.ms_deform_attn_fwd(value, flat, loc, att, list(pts))
    assert torch.equal(out, ms_deform_attn_fwd_plain(value, shapes, loc, att, pts))
    with FakeTensorMode() as mode:
        fake = torch.ops.dfine_tpu_torch.ms_deform_attn_fwd(
            mode.from_tensor(value), flat, mode.from_tensor(loc), mode.from_tensor(att), list(pts))
    assert tuple(fake.shape) == (2, 5, 64) and fake.dtype == torch.float32


def test_npz_round_trip_through_the_bridge(weights):
    """``port_variables`` inverts the weight bridge: the port's view of the
    JAX variables is those variables, leaf for leaf."""
    from flax import traverse_util

    from dfine_tpu_torch.utils.checkpoint import port_variables

    port = port_model_from(weights["variables"], "n", 3, True)
    flat = traverse_util.flatten_dict(weights["variables"], sep="/")
    back = port_variables(port)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
