"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. They skip where there is no card (a CUDA kernel has no CPU mode); run
them on a GPU machine with ``python -m pytest tests/test_torch_port_cuda.py``.
The CPU tests hold the plain versions against JAX."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_port_deform_cases import DEFORM_CASES, TILING_CASES, deform_case, tiling_case
from test_torch_port_hungarian_cases import (CASES, SIZE_CASES, assert_optimal, cap_rows,
                                             hungarian_case, integer_case, no_pending_case,
                                             size_case)
from test_torch_port_scatter_cases import CASE_WIDTHS, EDGE_CASES, scatter_case

pytestmark = pytest.mark.cuda

M_SHAPES, M_POINTS = ((80, 80), (40, 40), (20, 20)), (3, 6, 3)  # m@640
N_SHAPES, N_POINTS = ((40, 40), (20, 20)), (6, 6)  # n@640


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, q, h, d, shapes, pts, value_dtype, seed=0, lo=-0.15, hi=1.15):
    rng = np.random.default_rng(seed)
    s = sum(hh * ww for hh, ww in shapes)
    p = sum(pts)
    value = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(lo, hi, (b, q, h, p, 2)).astype(np.float32))
    att = torch.from_numpy(rng.normal(size=(b, q, h, p)).astype(np.float32)).softmax(-1)
    return value.to(dev, value_dtype), loc.to(dev), att.to(dev)


@pytest.mark.parametrize("d,shapes,pts", [(32, M_SHAPES, M_POINTS), (16, N_SHAPES, N_POINTS),
                                          (64, M_SHAPES, M_POINTS)])
@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,q", [(1, 300), (8, 500)])  # serving; the train step (200 CDN + 300)
def test_deform_fwd_kernel_matches_plain(cuda, d, shapes, pts, value_dtype, b, q):
    """Same inputs (the plain version reads the bf16 value as f32 too);
    max abs error <= 1e-5 (summation order)."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain

    value, loc, att = _inputs(cuda, b, q, 8, d, shapes, pts, value_dtype)
    before = ms_deform_attn_fwd.launches
    out = ms_deform_attn_fwd(value, shapes, loc, att, pts)
    torch.cuda.synchronize()
    assert ms_deform_attn_fwd.launches == before + 1
    ref = ms_deform_attn_fwd_plain(value, shapes, loc, att, pts)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max().item() <= 1e-5


# rect serving at m@640: the levels of the 16:9 (1080x1920 -> 384x640), 9:16
# and 4:3 (1200x1600 -> 480x640) canvases
RECT_SHAPES = (((48, 80), (24, 40), (12, 20)), ((80, 48), (40, 24), (20, 12)),
               ((60, 80), (30, 40), (15, 20)))


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", RECT_SHAPES, ids=lambda s: "x".join(map(str, s[0])))
def test_deform_fwd_kernel_on_rect_levels(cuda, shapes, value_dtype):
    """Non-square levels, rows and columns of different lengths (B = 1, 300
    queries, points (3, 6, 3)): max abs error <= 1e-5."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain

    value, loc, att = _inputs(cuda, 1, 300, 8, 32, shapes, M_POINTS, value_dtype, seed=5)
    out = ms_deform_attn_fwd(value, shapes, loc, att, M_POINTS)
    ref = ms_deform_attn_fwd_plain(value, shapes, loc, att, M_POINTS)
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DEFORM_CASES)
def test_deform_fwd_kernel_on_cases(cuda, case, value_dtype):
    """The inputs of the CPU parity test's cases (pixel edges and centres,
    one level, head dim 16 with points (6, 6)): max abs error <= 1e-5."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain

    value, shapes, loc, att, pts = deform_case(case)
    value = torch.from_numpy(value).to(cuda, value_dtype)
    loc, att = torch.from_numpy(loc).to(cuda), torch.from_numpy(att).to(cuda)
    out = ms_deform_attn_fwd(value, shapes, loc, att, pts)
    ref = ms_deform_attn_fwd_plain(value, shapes, loc, att, pts)
    assert (out - ref).abs().max().item() <= 1e-5


def test_deform_fwd_kernel_out_of_range_is_exact_zero(cuda):
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd

    value, loc, att = _inputs(cuda, 1, 300, 8, 32, M_SHAPES, M_POINTS, torch.bfloat16)
    far = torch.tensor([-0.6, 1.7, -1e9, 1e9], device=cuda)
    loc = far[torch.randint(0, 4, loc.shape, device=cuda)]
    out = ms_deform_attn_fwd(value, M_SHAPES, loc, att, M_POINTS)
    assert torch.count_nonzero(out).item() == 0


@pytest.mark.parametrize("d", CASE_WIDTHS)
def test_scatter_kernel_matches_plain(cuda, d):
    """At the train step's shapes (m@640, B = 8, 500 queries): atol 1e-4,
    rtol 1e-5 (shared-memory atomics reorder the f32 sums); all-dropped
    gives exact zeros; one call is the kernel alone (no fill of the
    output)."""
    from dfine_tpu_torch.ops.kernels.scatter_rows import rows_scatter_add, rows_scatter_add_plain

    g = torch.Generator(device=cuda).manual_seed(0)
    for n, hw in ((6000, 6400), (12000, 1600), (6000, 400)):
        idx = torch.randint(-1, hw, (64, n), device=cuda, generator=g, dtype=torch.int32)
        contrib = torch.randn((64, n, d), device=cuda, generator=g)
        out = rows_scatter_add(idx, contrib, hw)
        torch.testing.assert_close(out, rows_scatter_add_plain(idx, contrib, hw),
                                   atol=1e-4, rtol=1e-5)
        dropped = rows_scatter_add(torch.full_like(idx, -1), contrib, hw)
        assert torch.count_nonzero(dropped).item() == 0
    assert _kernels_of(lambda: rows_scatter_add(idx, contrib, hw)) == 1


def _kernels_of(fn):
    """The number of device activities (kernels, fills, copies) of one call.
    A profiler window in which CUPTI recorded no device activity at all (it
    can drop a whole window when windows follow each other closely; three in
    a row were seen on an H100) is taken again after a pause, up to six
    windows."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        if attempt:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
        if n:
            return n
    return 0


def _tile_case(dev, case, d):
    if case.startswith("rows_"):  # tiles of 128 rows: fewer rows, one more, a ragged last
        hw = int(case[5:])
        rng = np.random.default_rng(hw)
        idx, contrib = rng.integers(-1, hw + 1, (5, 3000)), rng.normal(size=(5, 3000, d))
    else:
        idx, contrib, hw = scatter_case(case, d)
    return (torch.from_numpy(idx.astype(np.int32)).to(dev),
            torch.from_numpy(contrib.astype(np.float32)).to(dev), hw)


@pytest.mark.parametrize("d", CASE_WIDTHS)
@pytest.mark.parametrize("case", [*EDGE_CASES, "rows_1", "rows_100", "rows_129", "rows_1000"])
@pytest.mark.parametrize("name", ["rows_scatter_add", "rows_scatter_add_mxu",
                                  "rows_scatter_add_tiled"])
def test_tile_scatter_kernels_on_edge_cases(cuda, name, case, d):
    """The edge cases of the CPU tests and destination counts around the
    kernels' 128-row tiles: ``rows_scatter_add`` within atol 1e-4, rtol 1e-5
    of its plain version; ``rows_scatter_add_mxu`` within atol 1e-5, rtol
    1e-6 of its bf16 plain version (test_pallas_scatter.py:27-48), and atol
    1e-3, rtol 1e-4 where a destination sums hundreds of entries
    (``clustered``, ``dense_duplicates``, ``rows_1``): f32 sums of hundreds
    of terms, taken in another order; ``rows_scatter_add_tiled`` bit-equal
    to its plain version on the CPU (the same sums in the same order) and to
    its own second run."""
    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    idx, contrib, hw = _tile_case(cuda, case, d)
    fn = getattr(sr, name)
    out = fn(idx, contrib, hw)
    torch.cuda.synchronize()
    assert out.shape == (idx.shape[0], hw, d)
    if name == "rows_scatter_add":
        torch.testing.assert_close(out, sr.rows_scatter_add_plain(idx, contrib, hw),
                                   atol=1e-4, rtol=1e-5)
    elif name == "rows_scatter_add_mxu":
        many = case in ("clustered", "dense_duplicates", "rows_1")
        torch.testing.assert_close(out, sr.rows_scatter_add_bf16_plain(idx, contrib, hw),
                                   atol=1e-3 if many else 1e-5, rtol=1e-4 if many else 1e-6)
    else:
        assert torch.equal(out.cpu(), sr.rows_scatter_add_bf16_plain(idx.cpu(), contrib.cpu(), hw))
        assert torch.equal(out, fn(idx, contrib, hw))


@pytest.mark.parametrize("d", [8, 48])
@pytest.mark.parametrize("name", ["rows_scatter_add", "rows_scatter_add_mxu",
                                  "rows_scatter_add_tiled"])
def test_tile_scatter_kernels_reject_other_widths(cuda, name, d):
    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    idx = torch.zeros((2, 10), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="not supported"):
        getattr(sr, name)(idx, torch.ones((2, 10, d), device=cuda), 4)


def test_core_backward_matches_autograd_of_plain(cuda):
    """MSDeformAttnCore.backward (closed form + scatter kernel) against
    autograd of the plain core; tolerance of test_pallas_scatter.py:69-78."""
    from dfine_tpu_torch.ops.deform_attn import ms_deform_attn, ms_deform_attn_core
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd
    from dfine_tpu_torch.ops.kernels.scatter_rows import rows_scatter_add

    value, loc, att = _inputs(cuda, 2, 300, 8, 32, M_SHAPES, M_POINTS, torch.float32)
    g_out = torch.randn((2, 300, 256), device=cuda)
    grads = []
    before = rows_scatter_add.launches, ms_deform_attn_bwd.launches
    for fn in (ms_deform_attn, ms_deform_attn_core):
        v, l, a = (t.clone().requires_grad_() for t in (value, loc, att))
        (fn(v, M_SHAPES, l, a, M_POINTS) * g_out).sum().backward()
        grads.append((v.grad, l.grad, a.grad))
    # one backward kernel a call, one scatter per level
    assert (rows_scatter_add.launches, ms_deform_attn_bwd.launches) == \
        (before[0] + len(M_SHAPES), before[1] + 1)
    for name, ours, ref in zip(("value", "loc", "att"), *grads):
        scale = ref.abs().max().item() + 1e-9
        assert (ours - ref).abs().max().item() <= 2e-4 * scale, name


@pytest.mark.parametrize("name", ["rows_scatter_add_mxu", "rows_scatter_add_tiled"])
def test_bf16_scatter_kernels_match_plain(cuda, name):
    """At the train step's shapes (m@640, B = 8, 500 queries): against the
    bf16-rounded plain version at atol 1e-5, rtol 1e-6
    (test_pallas_scatter.py:48, :165); all-dropped gives exact zeros; every
    entry in one row agrees at atol 1e-3, rtol 1e-4 (a sum of 6000-12000
    terms in another f32 order); one call is the kernel alone (no fill of
    the output)."""
    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    fn = getattr(sr, name)
    g = torch.Generator(device=cuda).manual_seed(0)
    for n, hw in ((6000, 6400), (12000, 1600), (6000, 400)):
        idx = torch.randint(-1, hw, (64, n), device=cuda, generator=g, dtype=torch.int32)
        contrib = torch.randn((64, n, 32), device=cuda, generator=g).bfloat16()
        before = fn.launches
        out = fn(idx, contrib, hw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        torch.testing.assert_close(out, sr.rows_scatter_add_bf16_plain(idx, contrib, hw),
                                   atol=1e-5, rtol=1e-6)
        assert torch.count_nonzero(fn(torch.full_like(idx, -1), contrib, hw)).item() == 0
        one = torch.full_like(idx, hw // 2)
        torch.testing.assert_close(fn(one, contrib, hw),
                                   sr.rows_scatter_add_bf16_plain(one, contrib, hw),
                                   atol=1e-3, rtol=1e-4)
    # an f32 payload is rounded once to bf16 by the wrapper
    c32 = torch.randn((64, 6000, 32), device=cuda, generator=g)
    idx = torch.randint(-1, 400, (64, 6000), device=cuda, generator=g, dtype=torch.int32)
    torch.testing.assert_close(fn(idx, c32, 400), sr.rows_scatter_add_bf16_plain(idx, c32, 400),
                               atol=1e-5, rtol=1e-6)
    c16 = c32.bfloat16()
    assert _kernels_of(lambda: fn(idx, c16, 400)) == 1


def test_mxu_scatter_non_finite_stays_in_its_warps_rows(cuda):
    """One inf payload element: its destination stays non-finite, and only
    its column of the 16 rows that one warp owns (rows [32, 48) of the first
    tile for destination 37) may turn NaN (0 x inf in the one-hot product);
    every other element matches the bf16 plain version at atol 1e-5, rtol
    1e-6."""
    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    g = torch.Generator(device=cuda).manual_seed(2)
    hw, dst, col = 400, 37, 5
    idx = torch.randint(-1, hw, (4, 3000), device=cuda, generator=g, dtype=torch.int32)
    contrib = torch.randn((4, 3000, 32), device=cuda, generator=g).bfloat16()
    idx[1, 100] = dst
    contrib[1, 100, col] = float("inf")
    out = sr.rows_scatter_add_mxu(idx, contrib, hw)
    assert not torch.isfinite(out[1, dst, col]).item()
    spread = torch.zeros_like(out, dtype=torch.bool)
    spread[1, 32:48, col] = True
    assert torch.isfinite(out[~spread]).all().item()
    torch.testing.assert_close(out[~spread],
                               sr.rows_scatter_add_bf16_plain(idx, contrib, hw)[~spread],
                               atol=1e-5, rtol=1e-6)


def test_tiled_scatter_is_bit_equal_over_runs(cuda):
    """No atomics: repeated runs give bit-equal output, equal to the plain
    version on the CPU (each sum taken in increasing n), at the train step's
    shapes, also when every entry falls in one row or thousands share each
    of four rows; one call is the kernel alone (no sort, no gather)."""
    from dfine_tpu_torch.ops.kernels.scatter_rows import (rows_scatter_add_bf16_plain,
                                                          rows_scatter_add_tiled)

    g = torch.Generator(device=cuda).manual_seed(1)
    for n, hw in ((6000, 6400), (12000, 1600), (6000, 400)):
        idx = torch.randint(-1, hw, (64, n), device=cuda, generator=g, dtype=torch.int32)
        contrib = torch.randn((64, n, 32), device=cuda, generator=g).bfloat16()
        for case in (idx, torch.full_like(idx, hw // 2), torch.randint_like(idx, 0, 4)):
            first = rows_scatter_add_tiled(case, contrib, hw)
            assert all(torch.equal(first, rows_scatter_add_tiled(case, contrib, hw))
                       for _ in range(2))
            assert torch.equal(first.cpu(),
                               rows_scatter_add_bf16_plain(case.cpu(), contrib.cpu(), hw))
    assert _kernels_of(lambda: rows_scatter_add_tiled(idx, contrib, hw)) == 1


@pytest.mark.parametrize("impl", ["mxu", "tiled"])
def test_core_backward_through_bf16_scatters(cuda, impl):
    """MSDeformAttnCore with set_deform_bwd(impl) against autograd of the
    plain core: location and attention gradients within 2e-4 of the largest
    (f32, as for the default), value gradients within rtol 5e-2, atol 2e-2
    (test_pallas_scatter.py:139-141; the payload is rounded to bf16); the
    chosen kernel launches once per level."""
    from dfine_tpu_torch.ops import deform_attn as tda
    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    value, loc, att = _inputs(cuda, 2, 300, 8, 32, M_SHAPES, M_POINTS, torch.float32)
    g_out = torch.randn((2, 300, 256), device=cuda)
    kernel = getattr(sr, f"rows_scatter_add_{impl}")
    grads = []
    tda.set_deform_bwd(impl)
    try:
        before = kernel.launches
        for fn in (tda.ms_deform_attn, tda.ms_deform_attn_core):
            v, l, a = (t.clone().requires_grad_() for t in (value, loc, att))
            (fn(v, M_SHAPES, l, a, M_POINTS) * g_out).sum().backward()
            grads.append((v.grad, l.grad, a.grad))
        assert kernel.launches == before + len(M_SHAPES)
    finally:
        tda.set_deform_bwd("pallas")
    (gv, gl, ga), (rv, rl, ra) = grads
    torch.testing.assert_close(gv, rv, rtol=5e-2, atol=2e-2)
    for ours, ref in ((gl, rl), (ga, ra)):
        assert (ours - ref).abs().max().item() <= 2e-4 * ref.abs().max().item()


# the widened decoder layer of m at layer_scale 2: d = 512 over 8 heads
WIDE_D = 64


def test_deform_fwd_kernel_head_dim_64_out_of_range_is_exact_zero(cuda):
    """Head dim 64: locations far outside the map give exact zeros in both
    32-channel slices of every head."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd

    value, loc, att = _inputs(cuda, 2, 300, 8, WIDE_D, M_SHAPES, M_POINTS, torch.bfloat16)
    far = torch.tensor([-0.6, 1.7, -1e9, 1e9], device=cuda)
    loc = far[torch.randint(0, 4, loc.shape, device=cuda)]
    out = ms_deform_attn_fwd(value, M_SHAPES, loc, att, M_POINTS)
    assert out.shape == (2, 300, 8 * WIDE_D) and torch.count_nonzero(out).item() == 0


@pytest.mark.parametrize("name", ["rows_scatter_add", "rows_scatter_add_mxu",
                                  "rows_scatter_add_tiled"])
def test_wide_scatter_kernels_at_train_shape(cuda, name):
    """D = 64 at the train step's shapes (m@640, B = 8, 500 queries), one
    launch a call: ``rows_scatter_add`` within atol 1e-4, rtol 1e-5 of its
    plain version, ``_mxu`` within atol 1e-5, rtol 1e-6 of the bf16 plain
    version, ``_tiled`` bit-equal to the bf16 plain version on the CPU and
    to its own second run; every entry on one row agrees at atol 1e-3, rtol
    1e-4 (a sum of thousands of terms in another f32 order), bit for bit
    for ``_tiled``."""
    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    fn = getattr(sr, name)
    plain = sr.rows_scatter_add_plain if name == "rows_scatter_add" else \
        sr.rows_scatter_add_bf16_plain
    g = torch.Generator(device=cuda).manual_seed(3)
    for n, hw in ((6000, 6400), (12000, 1600), (6000, 400)):
        idx = torch.randint(-1, hw, (64, n), device=cuda, generator=g, dtype=torch.int32)
        contrib = torch.randn((64, n, WIDE_D), device=cuda, generator=g)
        before = fn.launches
        out = fn(idx, contrib, hw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1 and out.shape == (64, hw, WIDE_D)
        one = torch.full_like(idx, hw // 2)
        if name == "rows_scatter_add_tiled":
            assert torch.equal(out.cpu(), plain(idx.cpu(), contrib.cpu(), hw))
            assert torch.equal(out, fn(idx, contrib, hw))
            assert torch.equal(fn(one, contrib, hw).cpu(), plain(one.cpu(), contrib.cpu(), hw))
            continue
        tol = dict(atol=1e-4, rtol=1e-5) if name == "rows_scatter_add" else \
            dict(atol=1e-5, rtol=1e-6)
        torch.testing.assert_close(out, plain(idx, contrib, hw), **tol)
        torch.testing.assert_close(fn(one, contrib, hw), plain(one, contrib, hw),
                                   atol=1e-3, rtol=1e-4)
    assert torch.count_nonzero(fn(torch.full_like(idx, -1), contrib, hw)).item() == 0


@pytest.mark.parametrize("impl", ["pallas", "mxu", "tiled"])
def test_core_backward_head_dim_64(cuda, impl):
    """MSDeformAttnCore at head dim 64 with each value-gradient scatter
    against autograd of the plain core: location and attention gradients
    within 2e-4 of the largest; value gradients within 2e-4 of the largest
    for the f32 payload, and within rtol 5e-2, atol 2e-2 for the bf16 ones
    (test_pallas_scatter.py:139-141); the chosen kernel launches once per
    level at D = 64."""
    from dfine_tpu_torch.ops import deform_attn as tda

    value, loc, att = _inputs(cuda, 2, 300, 8, WIDE_D, M_SHAPES, M_POINTS, torch.float32)
    g_out = torch.randn((2, 300, 8 * WIDE_D), device=cuda)
    kernel = tda._SCATTERS[impl]
    grads = []
    tda.set_deform_bwd(impl)
    try:
        before = kernel.launches
        for fn in (tda.ms_deform_attn, tda.ms_deform_attn_core):
            v, l, a = (t.clone().requires_grad_() for t in (value, loc, att))
            (fn(v, M_SHAPES, l, a, M_POINTS) * g_out).sum().backward()
            grads.append((v.grad, l.grad, a.grad))
        assert kernel.launches == before + len(M_SHAPES)
    finally:
        tda.set_deform_bwd("pallas")
    (gv, gl, ga), (rv, rl, ra) = grads
    if impl == "pallas":
        assert (gv - rv).abs().max().item() <= 2e-4 * rv.abs().max().item()
    else:
        torch.testing.assert_close(gv, rv, rtol=5e-2, atol=2e-2)
    for ours, ref in ((gl, rl), (ga, ra)):
        assert (ours - ref).abs().max().item() <= 2e-4 * ref.abs().max().item()


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_custom_op_launches_the_kernel(cuda, value_dtype):
    """``dfine_tpu_torch::ms_deform_attn_fwd`` on CUDA tensors launches the
    kernel (one count a call) and matches the plain version within 1e-5."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain

    value, loc, att = _inputs(cuda, 1, 300, 8, 32, M_SHAPES, M_POINTS, value_dtype)
    flat = [n for hw in M_SHAPES for n in hw]
    before = ms_deform_attn_fwd.launches
    out = torch.ops.dfine_tpu_torch.ms_deform_attn_fwd(value, flat, loc, att, list(M_POINTS))
    torch.cuda.synchronize()
    assert ms_deform_attn_fwd.launches == before + 1
    ref = ms_deform_attn_fwd_plain(value, M_SHAPES, loc, att, M_POINTS)
    assert (out - ref).abs().max().item() <= 1e-5


def test_custom_op_in_a_cuda_graph(cuda):
    """The op captured in a CUDA graph (after a warm-up on a side stream)
    and replayed on new inputs copied into the static ones: bit-equal to an
    eager call on those inputs."""
    value, loc, att = _inputs(cuda, 1, 300, 8, 32, M_SHAPES, M_POINTS, torch.bfloat16, seed=1)
    flat, pts = [n for hw in M_SHAPES for n in hw], list(M_POINTS)
    op = torch.ops.dfine_tpu_torch.ms_deform_attn_fwd
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(value, flat, loc, att, pts)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = op(value, flat, loc, att, pts)
    v2, l2, a2 = _inputs(cuda, 1, 300, 8, 32, M_SHAPES, M_POINTS, torch.bfloat16, seed=2)
    value.copy_(v2)
    loc.copy_(l2)
    att.copy_(a2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, op(v2, flat, l2, a2, pts))


@pytest.mark.parametrize("m", [1, 17, 300])
def test_int_mm_is_the_exact_integer_product(cuda, m):
    """The int8 serving product on the card (``torch._int_mm`` behind
    ``infer.int8._int_product``, short inputs padded to 17 rows) equals the
    exact integer product, at K = 1024 (the largest sum: 1024 * 127^2)."""
    from dfine_tpu_torch.infer.int8 import _int_product

    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, 1024), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (256, 1024), generator=g, dtype=torch.int8)
    out = _int_product(a.to(cuda), b.to(cuda))
    assert out.dtype == torch.int32
    assert torch.equal(out.cpu().long(), a.long() @ b.long().T)


_DP_RANK = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch

from dfine_tpu_torch.models.dfine import build_model
from dfine_tpu_torch.models.layers import set_bn_axis
from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from dfine_tpu_torch.parallel import dp as par
from dfine_tpu_torch.train.criterion import CriterionConfig
from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
from dfine_tpu_torch.train.train_step import TrainState, make_train_step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
backend = par.init_multihost(f"localhost:{{port}}", 2, rank, device="cuda:0")
model = build_model("n", 5, False, device="cuda", cfg_overrides={overrides!r})
state = TrainState.create(model, build_optimizer(model, OptimConfig()))
step = par.make_dp_train_step(make_train_step(CriterionConfig(num_classes=5, losses={losses!r}),
                                              compute_dtype=torch.float32, axis_name="dp"))
batch = torch.load(f"{{out}}/batch.pt")
set_bn_axis("dp")
reset_launch_counts()
_, m = step(state, par.shard_batch({{"images": batch["images"].cuda(),
                                     "targets": {{k: v.cuda() for k, v in batch["targets"].items()}}}}))
torch.cuda.synchronize()
torch.save({{"backend": backend, "counts": launch_counts(),
             "metrics": {{k: float(v) for k, v in m.items()}},
             "model": {{k: v.cpu() for k, v in state.model.state_dict().items()}}}},
           f"{{out}}/rank{{rank}}.pt")
par.shutdown()
"""


def test_dp_step_two_ranks_sharing_the_card(cuda, tmp_path):
    """Two ranks on cuda:0 (gloo: the backend choice sees one device UUID
    twice), n detect at 320 px, fp32, SyncBN, 2 x 2 rows, against the
    single-process step on the 4 rows (SyncBN's formula over the whole
    batch): loss rtol 1e-5, grad norm rtol 1e-4, every parameter element
    within 2 lr + 2e-6 and at most 0.5 % beyond rtol 1e-4 / atol 1e-5
    (tests/test_torch_port_dp.py's rules); both ranks bit-equal; each rank
    launched the sampling kernel 3 times, the backward kernel 3 times, the
    scatter 6 times and the Hungarian solver once."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.models.layers import set_bn_axis
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    overrides, losses = (("decoder.num_denoising", 0),), ("vfl", "boxes")
    rng = np.random.default_rng(4)
    valid = np.asarray([[1, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 1]], bool)
    batch = {"images": torch.from_numpy(rng.uniform(size=(4, 3, 320, 320)).astype(np.float32)),
             "targets": {"labels": torch.from_numpy(rng.integers(0, 5, (4, 4))),
                         "boxes": torch.from_numpy(rng.uniform(0.25, 0.6, (4, 4, 4))
                                                   .astype(np.float32)),
                         "valid": torch.from_numpy(valid)}}
    torch.save(batch, tmp_path / "batch.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = _DP_RANK.format(repo=str(Path(__file__).resolve().parents[1]), overrides=overrides,
                           losses=losses)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-3000:] for _, err in outs]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    model = build_model("n", 5, False, device=cuda, cfg_overrides=overrides)
    state = TrainState.create(model, build_optimizer(model, OptimConfig()))
    step = make_train_step(CriterionConfig(num_classes=5, losses=losses),
                           compute_dtype=torch.float32)
    set_bn_axis("dp")
    try:
        _, m = step(state, {"images": batch["images"].to(cuda),
                            "targets": {k: v.to(cuda) for k, v in batch["targets"].items()}})
    finally:
        set_bn_axis(None)
    ref = {k: v.cpu() for k, v in state.model.state_dict().items()}
    for r in ranks:
        assert r["backend"] == "gloo"
        assert r["counts"] == {"ms_deform_attn_fwd": 3, "ms_deform_attn_bwd": 3,
                               "rows_scatter_add": 6, "rows_scatter_add_mxu": 0,
                               "rows_scatter_add_tiled": 0, "hungarian_lap": 1}
        np.testing.assert_allclose(r["metrics"]["loss"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], float(m["grad_norm"]), rtol=1e-4)
        far, n_el = 0, 0
        for k, v in r["model"].items():
            if k.endswith("num_batches_tracked"):
                assert torch.equal(v, ref[k]), k
            elif k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5)
            else:
                assert (v - ref[k]).abs().max() <= 2 * 2e-5 + 2e-6, k
                far += int((~torch.isclose(v, ref[k], rtol=1e-4, atol=1e-5)).sum())
                n_el += v.numel()
        assert far <= 0.005 * n_el, (far, n_el)
    for k, v in ranks[0]["model"].items():
        assert torch.equal(v, ranks[1]["model"][k]), k


# ----------------------------------------------------- the Hungarian solver --


def _lap_inputs(dev, cost, valid):
    return torch.from_numpy(cost).to(dev), torch.from_numpy(valid).to(dev)


def _kernel_equals_plain(dev, cost, valid):
    """One launch: the kernel's col4row equal to the plain version's on the
    CPU element for element, the same path steps in every problem (and the
    same assignment without a step tensor), scipy's optimum within rtol
    1e-6. Returns the plain version's steps."""
    from dfine_tpu_torch.ops.hungarian import hungarian
    from dfine_tpu_torch.ops.kernels import hungarian_lap

    steps = torch.full(cost.shape[:2], -1, dtype=torch.int32, device=dev)
    before = hungarian_lap.launches
    got = hungarian_lap(*_lap_inputs(dev, cost, valid), steps=steps)
    torch.cuda.synchronize()
    assert hungarian_lap.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == cost.shape[:3]
    ref_steps = torch.empty(cost.shape[:2], dtype=torch.int32)
    ref = hungarian(torch.from_numpy(cost), torch.from_numpy(valid), steps=ref_steps)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(steps.cpu(), ref_steps)
    assert torch.equal(hungarian_lap(*_lap_inputs(dev, cost, valid)).cpu(), ref)
    assert_optimal(cost, valid, got.cpu().numpy())
    return ref_steps


@pytest.mark.parametrize("case", CASES)
def test_hungarian_kernel_matches_plain(cuda, case):
    """Continuous costs (pad rows, an image without a valid row, square,
    G = 1, Q of 40, 300 and 500): the kernel against the plain version,
    assignment and path steps (``_kernel_equals_plain``)."""
    _kernel_equals_plain(cuda, *hungarian_case(case))


@pytest.mark.parametrize("case", list(SIZE_CASES))
def test_hungarian_kernel_at_its_boundaries(cuda, case):
    """Q at each boundary of the columns a lane owns (32, 320 | 321, 512,
    1024), square G = Q = 128 and 320, and problems whose valid rows do not
    fit the shared memory (read from global memory; ``cap_rows``), beside
    ones that do in the same launch: the kernel against the plain version,
    assignment and path steps; each case takes path steps."""
    cost, valid = size_case(case)
    rows, cap = valid.sum(-1), cap_rows(*cost.shape[-2:])
    if case.startswith("unstaged"):
        assert rows.max() > cap and ((rows > 0) & (rows <= cap)).any()
    steps = _kernel_equals_plain(cuda, cost, valid)
    assert int(steps.sum()) > 0


def test_hungarian_kernel_without_pending_rows(cuda):
    """Every row's argmin distinct: no path step, the argmins returned."""
    cost, valid = no_pending_case()
    steps = _kernel_equals_plain(cuda, cost, valid)
    assert int(steps.abs().sum()) == 0


@pytest.mark.parametrize("g,q", [(12, 40), (40, 40), (100, 300)])
def test_hungarian_kernel_ties_reach_the_optimum(cuda, g, q):
    """Integer costs tie everywhere: the kernel's assignment has scipy's
    optimum and the plain version's total exactly (the assignments
    themselves are expected equal too, as the arithmetic is)."""
    from dfine_tpu_torch.ops.hungarian import hungarian
    from dfine_tpu_torch.ops.kernels import hungarian_lap

    cost, valid = integer_case(g, q)
    got = hungarian_lap(*_lap_inputs(cuda, cost, valid)).cpu().numpy()
    assert_optimal(cost, valid, got, rtol=0)
    ref = hungarian(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    rows = np.arange(g)
    for si in range(cost.shape[0]):
        for bi in range(cost.shape[1]):
            assert cost[si, bi, rows, got[si, bi]].sum() == cost[si, bi, rows, ref[si, bi]].sum()


def test_hungarian_kernel_refuses_what_it_does_not_take(cuda):
    """G > Q and a Q above ``MAX_Q`` raise ValueError, each naming it."""
    from dfine_tpu_torch.ops.kernels import MAX_Q, hungarian_lap

    with pytest.raises(ValueError, match="G <= Q"):
        hungarian_lap(torch.zeros(2, 5, 4, device=cuda))
    with pytest.raises(ValueError, match="Q = "):
        hungarian_lap(torch.zeros(2, 5, MAX_Q + 1, device=cuda))


def test_hungarian_kernel_in_a_cuda_graph(cuda):
    """The solver captured in a CUDA graph (after a warm-up that builds the
    kernel) and replayed on new costs copied into the static ones: equal to
    an eager call on those costs."""
    from dfine_tpu_torch.ops.kernels import hungarian_lap

    cost, valid = _lap_inputs(cuda, *hungarian_case("train_m"))
    hungarian_lap(cost, valid)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = hungarian_lap(cost, valid)
    new = torch.from_numpy(np.random.default_rng(5).normal(size=cost.shape).astype(np.float32))
    cost.copy_(torch.where(valid[None, :, :, None], new.to(cuda), 0.0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, hungarian_lap(cost, valid))


# ------------------------------------- the deformable-attention backward --

BWD_GRAD_REL = 2e-4  # chip_smoke.GRAD_REL_TOL: g.v summed over d in another order


def _g_out(dev, b, q, d, seed=0):
    rng = np.random.default_rng(seed + 100)
    return torch.from_numpy(rng.normal(size=(b, q, 8 * d)).astype(np.float32)).to(dev)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _bwd_against_plain(value, shapes, loc, att, g_out, pts, payload, need_value=True):
    """One launch of the backward kernel against its plain version on the
    same tensors: idx equal, contrib bit-equal (each level's block
    contiguous, in the payload's type), grad_att and grad_loc within
    BWD_GRAD_REL of their largest value. Returns the kernel's tuple."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd, ms_deform_attn_bwd_plain

    before = ms_deform_attn_bwd.launches
    ours = ms_deform_attn_bwd(value, shapes, loc, att, g_out, pts, payload, need_value)
    torch.cuda.synchronize()
    assert ms_deform_attn_bwd.launches == before + 1
    ref = ms_deform_attn_bwd_plain(value, shapes, loc, att, g_out, pts, payload, need_value)
    for name, got, want in zip(("grad_att", "grad_loc"), ours[:2], ref[:2]):
        assert got.shape == want.shape and got.dtype == torch.float32, name
        assert (got - want).abs().max().item() <= BWD_GRAD_REL * want.abs().max().item(), name
    if not need_value:
        assert ours[2] is None and ours[3] is None
        return ours
    assert len(ours[2]) == len(ours[3]) == len(shapes)
    for level, (i, c, ri, rc) in enumerate(zip(ours[2], ours[3], ref[2], ref[3])):
        assert i.is_contiguous() and c.is_contiguous() and c.dtype == payload, level
        assert i.shape == ri.shape and c.shape == rc.shape, level
        assert torch.equal(i, ri), f"idx of level {level}"
        assert torch.equal(_bits(c), _bits(rc)), f"contrib of level {level}"
    return ours


PAYLOADS = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,shapes,pts", [(32, M_SHAPES, M_POINTS), (16, N_SHAPES, N_POINTS),
                                          (64, M_SHAPES, M_POINTS)])
def test_deform_bwd_kernel_matches_plain(cuda, d, shapes, pts, value_dtype, payload):
    """m@640 (and n@640 at D = 16), B = 2, 300 queries, locations in
    [-0.15, 1.15]: idx equal, contrib bit-equal, gradients within 2e-4 of
    the largest (the plain version reads the bf16 value as f32 too)."""
    value, loc, att = _inputs(cuda, 2, 300, 8, d, shapes, pts, value_dtype)
    _bwd_against_plain(value, shapes, loc, att, _g_out(cuda, 2, 300, d), pts, payload)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DEFORM_CASES)
def test_deform_bwd_kernel_on_cases(cuda, case, value_dtype, payload):
    """The CPU parity test's cases (pixel edges and centres, one level, head
    dim 16, head dim 64, four levels, off the map): the same rules."""
    value, shapes, loc, att, pts = deform_case(case)
    value = torch.from_numpy(value).to(cuda, value_dtype)
    loc, att = torch.from_numpy(loc).to(cuda), torch.from_numpy(att).to(cuda)
    g_out = _g_out(cuda, value.shape[0], loc.shape[1], value.shape[3])
    _bwd_against_plain(value, shapes, loc, att, g_out, pts, payload)


def _tiling_inputs(dev, case, d, value_dtype, seed=0):
    value, shapes, loc, att, pts = tiling_case(case, d, seed)
    b, q, heads = loc.shape[:3]
    g_out = np.random.default_rng(seed + 100).normal(size=(b, q, heads * d)).astype(np.float32)
    return (torch.from_numpy(value).to(dev, value_dtype), shapes, torch.from_numpy(loc).to(dev),
            torch.from_numpy(att).to(dev), torch.from_numpy(g_out).to(dev), pts)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("case", TILING_CASES)
def test_deform_bwd_kernel_on_tiling_cases(cuda, case, d, value_dtype, payload):
    """The edges of the kernel's work tiling (a warp a run of consecutive
    (query, point) slots of one level, batch and head): 1, 7, 301 and 500
    queries (the last run of a level cut short), B * H = 1, a level with
    one point, 16 points over 4 levels; each at head dims 16, 32 and 64:
    idx equal, contrib bit-equal, gradients within 2e-4 of the largest."""
    value, shapes, loc, att, g_out, pts = _tiling_inputs(cuda, case, d, value_dtype)
    _bwd_against_plain(value, shapes, loc, att, g_out, pts, payload)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("case", ["q7", "q301", "one_row"])
def test_deform_bwd_kernel_tiling_graph_replays(cuda, case, d):
    """A call on a ragged tiling case captured in a CUDA graph and replayed
    on new inputs copied into the static ones: every output bit-equal to
    the eager call's on those inputs, in both payloads."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd

    for payload in PAYLOADS:
        value, shapes, loc, att, g_out, pts = _tiling_inputs(cuda, case, d, torch.bfloat16)
        ms_deform_attn_bwd(value, shapes, loc, att, g_out, pts, payload)  # built before capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = ms_deform_attn_bwd(value, shapes, loc, att, g_out, pts, payload)
        new = _tiling_inputs(cuda, case, d, torch.bfloat16, seed=1)
        for static, fresh in zip((value, loc, att, g_out), (new[0], new[2], new[3], new[4])):
            static.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        eager = ms_deform_attn_bwd(new[0], shapes, new[2], new[3], new[4], pts, payload)
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
        assert all(torch.equal(a, b) for a, b in zip(out[2], eager[2]))
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(out[3], eager[3]))


@pytest.mark.parametrize("d", [16, 32, 64])
def test_deform_bwd_kernel_off_the_map(cuda, d):
    """Every location off the map (-0.6, 1.7, +-1e9 on each axis): every idx
    -1, both gradients exactly 0, contrib bit-equal to the plain version's
    (zeros); and the location past every edge by one pixel's half on one
    level (corners just outside): the plain version's idx, bit for bit."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd

    value, loc, att = _inputs(cuda, 2, 300, 8, d, M_SHAPES, M_POINTS, torch.bfloat16)
    far = torch.tensor([-0.6, 1.7, -1e9, 1e9], device=cuda)
    loc = far[torch.randint(0, 4, loc.shape, device=cuda)]
    g_out = _g_out(cuda, 2, 300, d)
    ga, gl, idx, _ = _bwd_against_plain(value, M_SHAPES, loc, att, g_out, M_POINTS,
                                        torch.float32)
    assert all((i == -1).all().item() for i in idx)
    assert torch.count_nonzero(ga).item() == 0 and torch.count_nonzero(gl).item() == 0
    edges = torch.tensor([-0.5 / 80, 1 + 0.5 / 80, 0.0, 1.0], device=cuda)
    loc = edges[torch.randint(0, 4, loc.shape, device=cuda)]
    _bwd_against_plain(value, M_SHAPES, loc, att, g_out, M_POINTS, torch.bfloat16)
    assert ms_deform_attn_bwd(value, M_SHAPES, loc, att, g_out, M_POINTS)[2][0].min().item() == -1


@pytest.mark.parametrize("d", [32, 64])
def test_deform_bwd_kernel_without_the_value_gradient(cuda, d):
    """need_value False: no idx or contrib, and both gradients bit-equal to
    those of the call that writes them."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd

    value, loc, att = _inputs(cuda, 2, 300, 8, d, M_SHAPES, M_POINTS, torch.bfloat16, seed=3)
    g_out = _g_out(cuda, 2, 300, d, seed=3)
    ga, gl, _, _ = _bwd_against_plain(value, M_SHAPES, loc, att, g_out, M_POINTS,
                                      torch.float32, need_value=False)
    full = ms_deform_attn_bwd(value, M_SHAPES, loc, att, g_out, M_POINTS)
    assert torch.equal(ga, full[0]) and torch.equal(gl, full[1])


def test_deform_bwd_kernel_refuses_what_it_does_not_take(cuda):
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd

    value, loc, att = _inputs(cuda, 1, 10, 8, 32, M_SHAPES, M_POINTS, torch.float32)
    g_out = _g_out(cuda, 1, 10, 32)
    with pytest.raises(ValueError, match="head dim"):
        ms_deform_attn_bwd(value[..., :8].contiguous(), M_SHAPES, loc, att, g_out[..., :64],
                           M_POINTS)
    with pytest.raises(ValueError, match="contiguous"):
        ms_deform_attn_bwd(value, M_SHAPES, loc, att, _g_out(cuda, 1, 10, 64)[..., ::2],
                           M_POINTS)
    with pytest.raises(TypeError, match="f32"):
        ms_deform_attn_bwd(value, M_SHAPES, loc, att, g_out.bfloat16(), M_POINTS)
    with pytest.raises(TypeError, match="payload"):
        ms_deform_attn_bwd(value, M_SHAPES, loc, att, g_out, M_POINTS, torch.float16)
    pts = (3, 6, 8)  # 17 points
    v, l, a = _inputs(cuda, 1, 10, 8, 32, M_SHAPES, pts, torch.float32)
    with pytest.raises(ValueError, match="at most 16 points"):
        ms_deform_attn_bwd(v, M_SHAPES, l, a, g_out, pts)
    shifted = torch.empty(value.numel() + 1, device=cuda)[1:].view(value.shape)  # 4 bytes off
    shifted.copy_(value)
    with pytest.raises(ValueError, match="16-byte"):
        ms_deform_attn_bwd(shifted, M_SHAPES, loc, att, g_out, M_POINTS)


def test_deform_bwd_kernel_is_one_graph_node_and_replays(cuda):
    """One call is the kernel alone: one node in a CUDA graph of the call
    (no fill before it); the call captured in a graph and replayed on new
    inputs copied into the static ones gives the eager call's outputs bit
    for bit (the kernel has no atomics)."""
    import sys
    from pathlib import Path

    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    value, loc, att = _inputs(cuda, 2, 300, 8, 32, M_SHAPES, M_POINTS, torch.bfloat16, seed=1)
    g_out = _g_out(cuda, 2, 300, 32, seed=1)
    for payload in PAYLOADS:
        nodes = chip_smoke.graph_nodes(
            lambda: ms_deform_attn_bwd(value, M_SHAPES, loc, att, g_out, M_POINTS, payload))
        assert len(nodes) == 1 and "ms_deform_attn_bwd" in nodes[0][1], nodes
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ms_deform_attn_bwd(value, M_SHAPES, loc, att, g_out, M_POINTS, torch.bfloat16)
    v2, l2, a2 = _inputs(cuda, 2, 300, 8, 32, M_SHAPES, M_POINTS, torch.bfloat16, seed=2)
    for static, new in ((value, v2), (loc, l2), (att, a2), (g_out, _g_out(cuda, 2, 300, 32, 2))):
        static.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    eager = ms_deform_attn_bwd(v2, M_SHAPES, l2, a2, g_out, M_POINTS, torch.bfloat16)
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
    assert all(torch.equal(a, b) for a, b in zip(out[2], eager[2]))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(out[3], eager[3]))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("impl", ["pallas", "mxu", "tiled"])
def test_core_backward_through_the_bwd_kernel(cuda, impl, d):
    """MSDeformAttnCore's whole backward (the backward kernel, then the
    chosen scatter a level) against autograd of the plain core, with a
    non-contiguous incoming gradient (the output used transposed):
    location and attention gradients within 2e-4 of the largest; value
    gradients within 2e-4 of the largest for the f32 payload and within
    rtol 5e-2, atol 2e-2 for the bf16 ones (test_pallas_scatter.py:139-141);
    one backward kernel and one scatter a level a call. Then the value
    frozen: one backward kernel, no scatter, and the other two gradients
    bit-equal to the first call's."""
    from dfine_tpu_torch.ops import deform_attn as tda
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd

    value, loc, att = _inputs(cuda, 2, 300, 8, d, M_SHAPES, M_POINTS, torch.float32, seed=4)
    g_t = _g_out(cuda, 2, 300, d, seed=4).transpose(0, 1)  # [Q, B, H*D]
    kernel = tda._SCATTERS[impl]
    grads = []
    tda.set_deform_bwd(impl)
    try:
        before = kernel.launches, ms_deform_attn_bwd.launches
        for fn in (tda.ms_deform_attn, tda.ms_deform_attn_core):
            v, l, a = (t.clone().requires_grad_() for t in (value, loc, att))
            (fn(v, M_SHAPES, l, a, M_POINTS).transpose(0, 1) * g_t).sum().backward()
            grads.append((v.grad, l.grad, a.grad))
        assert (kernel.launches, ms_deform_attn_bwd.launches) == \
            (before[0] + len(M_SHAPES), before[1] + 1)
        l, a = (t.clone().requires_grad_() for t in (loc, att))
        (tda.ms_deform_attn(value, M_SHAPES, l, a, M_POINTS).transpose(0, 1) * g_t).sum().backward()
        assert (kernel.launches, ms_deform_attn_bwd.launches) == \
            (before[0] + len(M_SHAPES), before[1] + 2)
    finally:
        tda.set_deform_bwd("pallas")
    (gv, gl, ga), (rv, rl, ra) = grads
    if impl == "pallas":
        assert (gv - rv).abs().max().item() <= 2e-4 * rv.abs().max().item()
    else:
        torch.testing.assert_close(gv, rv, rtol=5e-2, atol=2e-2)
    for ours, ref in ((gl, rl), (ga, ra)):
        assert (ours - ref).abs().max().item() <= 2e-4 * ref.abs().max().item()
    assert torch.equal(l.grad, gl) and torch.equal(a.grad, ga)


def test_core_backward_in_a_cuda_graph(cuda):
    """A forward and backward of MSDeformAttnCore (the tiled scatter:
    deterministic) captured in one CUDA graph after a warm-up on a side
    stream, replayed on new inputs: every gradient bit-equal to an eager
    pass on those inputs."""
    from dfine_tpu_torch.ops import deform_attn as tda

    def inputs(seed):
        value, loc, att = _inputs(cuda, 2, 300, 8, 32, M_SHAPES, M_POINTS, torch.bfloat16,
                                  seed=seed)
        return value, loc, att, _g_out(cuda, 2, 300, 32, seed)

    def grads(value, loc, att, g_out):
        v, l, a = (t.detach().requires_grad_() for t in (value, loc, att))
        out = tda.ms_deform_attn(v, M_SHAPES, l, a, M_POINTS)
        return torch.autograd.grad(out, (v, l, a), g_out)

    static = inputs(5)
    tda.set_deform_bwd("tiled")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            grads(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = grads(*static)
        new = inputs(6)
        for s_, n_ in zip(static, new):
            s_.copy_(n_)
        graph.replay()
        torch.cuda.synchronize()
        eager = grads(*new)
    finally:
        tda.set_deform_bwd("pallas")
    assert all(torch.equal(o, e) for o, e in zip(out, eager))


# --------------------------------------------- the train step's CUDA graph --
# n detect at 320 px (3 decoder layers, 2 levels, the CDN queries on), batch
# 2, 10 target slots. A replayed step is held against the eager step, with a
# second eager run as the control: each reading of the graph may differ from
# the eager run's by at most GRAPH_SLACK times what the two eager runs differ
# by (float atomics reorder sums between runs), plus a floor a reading, about
# four times the most two eager fp32 runs read apart on the card (loss 9e-6,
# grad norm 5.4e-4, first moment 1.7e-6, BatchNorm statistics 2e-6, the
# change of the parameters and the EMA 0.022: AdamW's first steps move an
# element by about lr whatever its gradient's size, so an element whose tiny
# gradient changes sign between runs moves 2 lr the other way). Every run
# starts each step from the first run's state before that step: the steps
# are chaotic (random weights put the matching on near-ties), so two runs
# that part by a rounding in one step's gradients can take another matching
# in a later one and read 3 % apart in loss.

GRAPH_SLACK = 4.0
GRAPH_FLOOR = {torch.float32: {"loss": 1e-4, "grad_norm": 2e-3, "exp_avg": 1e-5, "bn": 1e-5,
                               "params": 0.1, "ema": 0.1},
               torch.bfloat16: {"loss": 1e-3, "grad_norm": 2e-2, "exp_avg": 1e-4, "bn": 1e-4,
                                "params": 0.1, "ema": 0.1}}


def _graph_batch(dev, seed, g=10, b=2, hw=320):
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.05, 0.4, (b, g, 2))
    cxcy = rng.uniform(wh / 2, 1 - wh / 2)
    valid = np.arange(g)[None] < rng.integers(1, g + 1, b)[:, None]
    targets = {"labels": torch.from_numpy(rng.integers(0, 5, (b, g))),
               "boxes": torch.from_numpy(np.concatenate([cxcy, wh], -1).astype(np.float32)),
               "valid": torch.from_numpy(valid)}
    images = torch.from_numpy(rng.uniform(size=(b, 3, hw, hw)).astype(np.float32))
    return {"images": images.to(dev), "targets": {k: v.to(dev) for k, v in targets.items()}}


def _graph_state(base, dtype, optim=None, flat=False):
    import copy

    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    model = copy.deepcopy(base)
    # a short schedule: the learning rate changes at every step of the warm-up
    cfg = optim or OptimConfig(epochs=1, steps_per_epoch=8, pct_start=0.5)
    state = TrainState.create(model, build_optimizer(model, cfg, flat=flat))
    return state, make_train_step(CriterionConfig(num_classes=5), compute_dtype=dtype,
                                  ema_base=0.9)


def _flat_of(tensors):
    return torch.cat([t.detach().float().flatten() for t in tensors])


def _snapshot(state):
    """Copies of what a step reads and writes: the model's and the EMA's
    parameters and buffers, the optimizer's moments and the running mean of
    an unfinished accumulation."""
    opt = state.optimizer
    snap = {"model": [t.clone() for t in state.model.state_dict().values()],
            "ema": [t.clone() for t in state.ema.state_dict().values()]}
    if hasattr(opt, "adamw"):
        snap["moments"] = [{k: v.clone() for k, v in opt.adamw.state[p].items()}
                           if p in opt.adamw.state else None for p in opt.params]
        snap["mean"] = [opt._mean[p].clone() if p in opt._mean else None for p in opt.params]
    else:  # the flat optimizer
        snap["moments"] = (opt.m.clone(), opt.v.clone())
        snap["mean"] = None if opt.mean is None else opt.mean.clone()
    return snap


@torch.no_grad()
def _restore(state, snap):
    """Copy ``_snapshot``'s tensors into ``state``'s own, in place: a
    captured graph holds their addresses."""
    for t, v in zip(state.model.state_dict().values(), snap["model"]):
        t.copy_(v)
    for t, v in zip(state.ema.state_dict().values(), snap["ema"]):
        t.copy_(v)
    opt = state.optimizer
    if hasattr(opt, "adamw"):
        for p, moments, mean in zip(opt.params, snap["moments"], snap["mean"]):
            for k, v in (moments or {}).items():
                opt.adamw.state[p][k].copy_(v)
            if mean is not None:
                opt._mean[p].copy_(mean)
    else:
        opt.m.copy_(snap["moments"][0])
        opt.v.copy_(snap["moments"][1])
        if snap["mean"] is not None:
            opt.mean.copy_(snap["mean"])


def _starting_state(state, starts, i):
    """Before step ``i``: the first run records its state in ``starts``,
    every later run starts from the first run's."""
    if len(starts) <= i:
        starts.append(_snapshot(state))
    else:
        _restore(state, starts[i])


def _steps(fn, state, starts, n=3, seed=0, loaded_at=None):
    """``n`` steps of ``fn`` on batches 0.. with a CUDA generator seeded
    ``seed``, each from the first run's state before it (``starts``,
    ``_starting_state``); after each, the learning rates and the EMA are
    held to their formulas (fp32). ``loaded_at``: the step before which the
    optimizer loads its own state dict. Returns the readings."""
    from dfine_tpu_torch.train.optim import ema_momentum

    dev = state.model.decoder.enc_score_head.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    opt, out = state.optimizer, {"loss": [], "grad_norm": []}
    floats = [k for k, t in state.ema.state_dict().items() if t.is_floating_point()]
    for i in range(n):
        if i == loaded_at:
            opt.load_state_dict(opt.state_dict())
        _starting_state(state, starts, i)
        ema_before = {k: state.ema.state_dict()[k].clone() for k in floats}
        _, m = fn(state, _graph_batch(dev, 10 + i), gen)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        ema_sd = state.ema.state_dict()
        if opt.mini_step:  # a micro-step of an accumulation: no update, no EMA
            assert all(torch.equal(ema_sd[k], ema_before[k]) for k in floats)
            continue
        for group in opt.adamw.param_groups:
            want = torch.tensor(opt.schedules[group["group"]](opt.count - 1), dtype=torch.float32)
            assert float(group["lr"]) == float(want), (i, group["group"])
        mom = ema_momentum(opt.count, 0.9)
        model_sd = state.model.state_dict()
        for k in floats:
            want = ema_before[k] * mom + model_sd[k].float() * (1.0 - mom)
            torch.testing.assert_close(ema_sd[k], want, rtol=1e-5, atol=1e-6, msg=k)
        if "exp_avg" not in out:  # after the first update
            out["exp_avg"] = _flat_of(opt.adamw.state[p]["exp_avg"] for p in opt.params
                                      if p in opt.adamw.state)
    sd = state.model.state_dict()
    out["params"] = _flat_of(p for p in state.model.parameters())
    out["bn"] = _flat_of(v for k, v in sd.items() if k.endswith(("running_mean", "running_var")))
    out["ema"] = _flat_of(p for p in state.ema.parameters())
    return out


def _hold(graph, eager, control, dtype, init):
    """Each reading of ``graph`` against ``eager``: at most GRAPH_SLACK x the
    eager runs' own difference plus the floor (losses and norms relative;
    the parameters and the EMA by their change from ``init``)."""
    def gap(a, b, k):
        if k in ("params", "ema"):
            a, b = a - init, b - init
        if isinstance(a, list):
            return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    gaps = {k: (gap(graph[k], eager[k], k), gap(control[k], eager[k], k)) for k in eager}
    print("graph / control gaps:", gaps)
    for k, (ours, theirs) in gaps.items():
        assert ours <= GRAPH_SLACK * theirs + GRAPH_FLOOR[dtype][k], (k, gaps)


def _graph_base(dev):
    from dfine_tpu_torch.models.dfine import build_model

    torch.manual_seed(0)
    return build_model("n", 5, False, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_graph_matches_eager(cuda, dtype):
    """Three steps through ``step`` (one capture, three replays) against
    three through ``step.eager``, each from the same state, and a second
    eager run as the control: losses and grad norms at each step, AdamW's first
    moment after step 1, the parameters, BatchNorm statistics and EMA after
    step 3; on every run each step's learning rates are the schedule's and
    the EMA follows its formula. The graph holds the step's kernel
    launches (3 sampling, 3 backward, 6 scatters, 1 solver) and a replay
    launches none from Python."""
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dfine_tpu_torch.utils import profiling

    base = _graph_base(cuda)
    init = _flat_of(base.parameters())
    runs, starts = {}, []
    for name in ("eager", "control", "graph"):
        state, step = _graph_state(base, dtype)
        profiling.drain()
        with profiling.tracing(True):
            runs[name] = _steps(step if name == "graph" else step.eager, state, starts)
            reset_launch_counts()
            (step if name == "graph" else step.eager)(state, _graph_batch(cuda, 20),
                                                      torch.Generator(device=cuda))
            torch.cuda.synchronize()
            python_launches = launch_counts()
        counters = profiling.drain()["counters"]
        if name == "graph":
            assert counters.get("train.graph_captures") == 1
            assert counters.get("train.graph_replays") == 4
            assert "train.eager_steps" not in counters
            (g,) = step.graphs.values()
            assert g.replays == 4
            assert g.launches == {"ms_deform_attn_fwd": 3, "ms_deform_attn_bwd": 3,
                                  "rows_scatter_add": 6, "rows_scatter_add_mxu": 0,
                                  "rows_scatter_add_tiled": 0, "hungarian_lap": 1}
            assert not any(python_launches.values()), python_launches
        else:
            assert counters.get("train.eager_steps") == 4 and step.graphs == {}
    _hold(runs["graph"], runs["eager"], runs["control"], dtype, init)


def test_train_step_graph_captures_again_after_a_load(cuda):
    """The optimizer's ``load_state_dict`` (new AdamW state tensors) before
    step 3 drops the graph: that step captures again (2 captures, 3
    replays) and the three steps still equal the eager ones, which load the
    same way."""
    from dfine_tpu_torch.utils import profiling

    base = _graph_base(cuda)
    init = _flat_of(base.parameters())
    runs, starts = {}, []
    for name in ("eager", "control", "graph"):
        state, step = _graph_state(base, torch.float32)
        profiling.drain()
        with profiling.tracing(True):
            runs[name] = _steps(step if name == "graph" else step.eager, state, starts,
                                loaded_at=2)
        counters = profiling.drain()["counters"]
        if name == "graph":
            assert (counters.get("train.graph_captures"), counters.get("train.graph_replays"),
                    state.optimizer.version) == (2, 3, 1)
    _hold(runs["graph"], runs["eager"], runs["control"], torch.float32, init)


@pytest.mark.parametrize("kind", ["accumulation", "flat"])
def test_train_step_falls_back_to_eager(cuda, kind):
    """An optimizer that accumulates 2 micro-steps and the flat optimizer
    take the eager body: every call counts ``train.eager_steps``, nothing
    is captured, and the results equal ``step.eager``'s within what two
    eager runs differ by."""
    from dfine_tpu_torch.train.optim import OptimConfig
    from dfine_tpu_torch.utils import profiling

    base = _graph_base(cuda)
    init = _flat_of(base.parameters())
    optim = OptimConfig(epochs=1, steps_per_epoch=8, pct_start=0.5,
                        b_accum_steps=2 if kind == "accumulation" else 1)
    n = 4 if kind == "accumulation" else 3
    runs, starts = {}, []
    for name in ("eager", "control", "step"):
        state, step = _graph_state(base, torch.float32, optim=optim, flat=kind == "flat")
        profiling.drain()
        with profiling.tracing(True):
            if kind == "flat":  # the flat EMA is one lerp_: its own formula, not held here
                runs[name] = _flat_steps(step if name == "step" else step.eager, state, starts,
                                         n)
            else:
                runs[name] = _steps(step if name == "step" else step.eager, state, starts, n)
        counters = profiling.drain()["counters"]
        assert counters.get("train.eager_steps") == n and "train.graph_captures" not in counters
        assert step.graphs == {}
    _hold(runs["step"], runs["eager"], runs["control"], torch.float32, init)


def _flat_steps(fn, state, starts, n):
    dev = state.model.decoder.enc_score_head.weight.device
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"loss": [], "grad_norm": []}
    for i in range(n):
        _starting_state(state, starts, i)
        _, m = fn(state, _graph_batch(dev, 10 + i), gen)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = _flat_of(state.model.parameters())
    out["ema"] = _flat_of(state.ema.parameters())
    return out


def test_train_step_replay_does_not_sync(cuda):
    """After the capture, a replayed step (the CDN draw from a CUDA
    generator, the copies into the graph's inputs, the rates written, the
    replay, the metrics' copies) runs under sync debug mode "error"."""
    base = _graph_base(cuda)
    state, step = _graph_state(base, torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(0)
    step(state, _graph_batch(cuda, 1), gen)
    batch = _graph_batch(cuda, 2)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, m = step(state, batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert np.isfinite(float(m["loss"])) and len(step.graphs) == 1


def test_train_step_keeps_a_bounded_number_of_graphs(cuda):
    """The loader's multiscale traffic: batches at each of its image sizes
    (320 px moved by ``MULTISCALE_OFFSETS``) in a drawn order, twice over,
    each size captured on its first batch (a capture call replays its graph
    once, as its step) and replayed on its second, no step eager; then a
    batch of a further signature (more target slots) runs eagerly, and the
    base size still replays its own graph."""
    from dfine_tpu_torch.data.loader import MULTISCALE_OFFSETS
    from dfine_tpu_torch.train.train_step import MAX_GRAPHS
    from dfine_tpu_torch.utils import profiling

    state, step = _graph_state(_graph_base(cuda), torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(0)
    sizes = [320 + d for d in MULTISCALE_OFFSETS]
    order = [sizes[i] for i in np.random.default_rng(0).permutation(len(sizes))] * 2
    profiling.drain()
    with profiling.tracing(True):
        for i, hw in enumerate(order):
            _, m = step(state, _graph_batch(cuda, i, hw=hw), gen)
            assert np.isfinite(float(m["loss"])), hw
        counters = profiling.counters()
        assert (counters.get("train.graph_captures"), counters.get("train.graph_replays"),
                counters.get("train.eager_steps")) == (MAX_GRAPHS, 2 * MAX_GRAPHS, None)
        for batch in (_graph_batch(cuda, 99, g=12), _graph_batch(cuda, 100)):
            _, m = step(state, batch, gen)
            assert np.isfinite(float(m["loss"]))
    counters = profiling.drain()["counters"]
    assert (counters.get("train.graph_captures"), counters.get("train.graph_replays"),
            counters.get("train.eager_steps")) == (MAX_GRAPHS, 2 * MAX_GRAPHS + 1, 1)
    assert len(step.graphs) == MAX_GRAPHS and state.step == 2 * MAX_GRAPHS + 2


def test_served_graph_runs_no_batchnorm_and_refolds_on_load(cuda, tmp_path):
    """``AOTModel`` l detection bf16 at 640, built from drawn weights A
    (``test_torch_port_serve_fold.draw``; ``serve.folds`` counts 193 at the
    build and 193 at the load below): ten profiled replays of its graph
    run no ``bn_fw`` kernel (by kernel symbol, as ``chip_smoke._device_counts``
    counts them) and the six sampling launches a replay holds. After a strict
    ``load_state_dict`` of weights B following the capture, the replayed
    decode matches the unfused eager bf16 serving program holding B by the
    serving-modes rule (``chip_smoke.phase_serving_modes``): >= 98 % of the
    top-300 boxes matched 1:1 by box, within 1 px at 640. The unfused program
    holding A fails that rule, so the replay read the refolded weights. A
    ``FoldedConvBNReLU`` (cuDNN's conv-bias-ReLU call, rounded once) equals
    ReLU of its folded conv (conv and bias add, each rounded to bf16) within
    two bf16 steps."""
    import sys
    from pathlib import Path

    from dfine_tpu_torch import AOTModel
    from dfine_tpu_torch.infer.fuse import FoldedConvBNReLU
    from dfine_tpu_torch.infer.torch_model import decode
    from dfine_tpu_torch.models.dfine import set_compute_dtype
    from dfine_tpu_torch.utils import profiling

    from test_torch_port_serve_fold import FOLDS, draw

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    a, b = draw("l", False, 1, num_classes=80), draw("l", False, 2, num_classes=80)
    torch.save(a.state_dict(), tmp_path / "a.pth")
    profiling.drain()
    with profiling.tracing(True):
        served = AOTModel("l", str(tmp_path / "a.pth"), 80, 640, 640, half=True, device=cuda)
    assert profiling.drain()["counters"].get("serve.folds") == FOLDS["l"]
    x = torch.rand((1, 3, 640, 640), device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    with torch.inference_mode():
        counts = chip_smoke._device_counts(lambda: served._predict(x), 10)
    assert counts, "the profiler saw no device activity"
    assert not [k for k in counts if "bn_fw" in k], counts
    assert sum(n for k, n in counts.items() if "ms_deform_attn_fwd" in k) == 60, counts

    with profiling.tracing(True):
        served.model.load_state_dict(b.state_dict(), strict=True)
    assert profiling.drain()["counters"].get("serve.folds") == FOLDS["l"]
    with torch.inference_mode():
        ours = served._predict(x)["boxes"][0].float().cpu().numpy() * 640

        def unfused(model):
            model = set_compute_dtype(model, torch.bfloat16).to(cuda).eval()
            return decode(model, x, served.num_top_queries)["boxes"][0].float().cpu().numpy() * 640

        want, old = unfused(b), unfused(a)

    def rule(ref):
        match = chip_smoke.align_by_box(ref, ours)
        gap = np.abs(ours[match] - ref).max(-1)
        return float((gap <= 1.0).mean()), float(np.quantile(gap, 0.98))

    assert rule(want)[0] >= 0.98, rule(want)
    assert rule(old)[0] < 0.98, rule(old)

    block = next(m for m in served.model.modules() if isinstance(m, FoldedConvBNReLU))
    y = torch.randn((1, block.conv.in_channels, 40, 40), device=cuda, dtype=torch.bfloat16)
    y = y.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fused, plain = block(y), torch.relu(block.conv(y))
        plain = plain if block.lab is None else block.lab(plain)
    torch.testing.assert_close(fused.float(), plain.float(), rtol=2.0 ** -6, atol=2.0 ** -6)


# ------------------------------------------------------------ BatchNorm --

# the train step's own: the stem at 640 px, stride 8, the 20 x 20 tokens; an odd map
BN_SHAPES = ((8, 32, 320, 320), (8, 256, 80, 80), (8, 1024, 20, 20), (2, 16, 7, 9))
BN_ACTS = (None, "relu", "silu")


def _bn_leaves(dev, shape, dtype, seed=0):
    """x, dy, weight, bias, running mean and variance: x 2 N(0, 1) + 0.5, in
    ``dtype``, NCHW-contiguous."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    c = shape[1]
    return (x, dy, torch.randn(c, generator=g, device=dev) * 0.5 + 1,
            torch.randn(c, generator=g, device=dev) * 0.3,
            torch.randn(c, generator=g, device=dev), torch.rand(c, generator=g, device=dev) + 0.5)


def _bn_run(fn, x, dy, w, b, rm, rv, act):
    """One forward and backward of ``fn`` (``batch_norm_train`` or its plain
    version) on copies: y, the three gradients and the statistics."""
    rm, rv = rm.clone(), rv.clone()
    nbt = torch.zeros((), dtype=torch.int64, device=x.device)
    xi, wi, bi = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = fn(xi, wi, bi, rm, rv, nbt, 0.1, 1e-5, act)
    y.backward(dy)
    return {"y": y.detach(), "dx": xi.grad, "gw": wi.grad, "gb": bi.grad, "rm": rm, "rv": rv,
            "nbt": nbt}


def _off(ours, ref, dtype):
    """Elements of ``ours`` farther from ``ref`` than a rounding of
    ``dtype`` (relative) plus a floor a share of ``ref``'s largest value:
    where z lies near 0, its absolute rounding error is many of its ulps."""
    rel, floor = (2.0 ** -7, 2.0 ** -16) if dtype == torch.bfloat16 else (1e-5, 1e-6)
    ours, ref = ours.float(), ref.float()
    return (ours - ref).abs() > rel * ref.abs() + floor * ref.abs().max()


def _f64_grads(x, dy, w, b, act):
    """(dx, grad_weight, grad_bias) at f64 with nothing rounded, and the
    sums of |terms| of the two parameters' gradients."""
    from dfine_tpu_torch.ops.kernels.batch_norm import batch_norm_train_grads

    x64, dy64 = x.double(), dy.double()
    var, mean = torch.var_mean(x64, dim=(0, 2, 3), correction=0)
    invstd = 1 / torch.sqrt(var + 1e-5)
    grads = batch_norm_train_grads(x64, dy64, w.double(), b.double(), mean, invstd, act)
    xhat = (x64 - mean.view(1, -1, 1, 1)) * invstd.view(1, -1, 1, 1)
    return grads, ((dy64 * xhat).abs().sum((0, 2, 3)), dy64.abs().sum((0, 2, 3)))


@pytest.mark.parametrize("act", BN_ACTS, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", BN_SHAPES, ids=str)
def test_batch_norm_kernels_match_plain(cuda, shape, dtype, act):
    """The four kernels against the plain chain, forward and backward. z
    (the normalised x, no activation) within a rounding of the chain's
    everywhere and equal on 99 % of elements in bf16; y the activation of
    the kernels' z as PyTorch's op computes it (equal on 99.9 %, within a
    rounding elsewhere: a z one ulp apart moves SiLU by up to 1.1 ulp of z,
    more than one of y); dx, grad_weight and grad_bias no farther from their
    f64 values, in norm, than twice the chain's; the running statistics
    (flax's, biased variance) within f32 rounding; 4 launches; y and dx
    NCHW-contiguous."""
    from dfine_tpu_torch.ops.kernels.batch_norm import batch_norm_train, batch_norm_train_plain

    leaves = _bn_leaves(cuda, shape, dtype)
    launches = batch_norm_train.launches
    ours = _bn_run(batch_norm_train, *leaves, act)
    torch.cuda.synchronize()
    assert batch_norm_train.launches - launches == 4
    ref = _bn_run(batch_norm_train_plain, *leaves, act)
    x = leaves[0]
    assert ours["y"].dtype == dtype and ours["y"].is_contiguous() and ours["dx"].is_contiguous()
    z, z_ref = (_bn_run(fn, *leaves, None)["y"] for fn in (batch_norm_train,
                                                            batch_norm_train_plain))
    assert not _off(z, z_ref, dtype).any()
    if dtype == torch.bfloat16:
        assert (z == z_ref).float().mean() >= 0.99
    want = {None: z, "relu": F.relu(z), "silu": F.silu(z)}[act]
    assert (ours["y"] == want).float().mean() >= 0.999 and not _off(ours["y"], want, dtype).any()
    (dx64, gw64, gb64), (gw_terms, gb_terms) = _f64_grads(x, leaves[1], leaves[2], leaves[3],
                                                          act)
    for key, truth, floor in (("dx", dx64, dx64.norm()), ("gw", gw64, gw_terms.norm()),
                              ("gb", gb64, gb_terms.norm())):
        ours_err = (ours[key].double() - truth).norm()
        chain_err = (ref[key].double() - truth).norm()
        assert ours_err <= 2 * chain_err + 1e-6 * floor, (key, ours_err, chain_err)
    torch.testing.assert_close(ours["rm"], ref["rm"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ours["rv"], ref["rv"], rtol=1e-5, atol=1e-5)
    assert int(ours["nbt"]) == int(ref["nbt"]) == 1


def test_batch_norm_kernels_are_bit_equal_over_runs(cuda):
    """The reductions merge each channel's partials in a fixed order,
    whichever block finishes last: two runs give the same bits."""
    from dfine_tpu_torch.ops.kernels import batch_norm as bn

    leaves = _bn_leaves(cuda, (8, 256, 80, 80), torch.bfloat16, seed=1)
    runs = [_bn_run(bn.batch_norm_train, *leaves, "silu") for _ in range(2)]
    for key in runs[0]:
        assert torch.equal(runs[0][key], runs[1][key]), key
    assert not bn._tickets[torch.cuda.current_device()].any()


def test_batch_norm_kernels_in_a_cuda_graph(cuda):
    """A forward and backward captured in a CUDA graph (after a warm-up) and
    replayed three times equal three eager calls bit for bit, the running
    statistics included; the graph holds the 4 launches, and every ticket
    is 0 after the replays."""
    from dfine_tpu_torch.ops.kernels import batch_norm as bn

    x, dy, w, b, rm, rv = _bn_leaves(cuda, (8, 128, 40, 40), torch.bfloat16, seed=2)

    def call(stats):
        leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
        y = bn.batch_norm_train(*leaves, *stats, 0.1, 1e-5, "relu")
        return (y, *torch.autograd.grad(y, leaves, dy))

    def fresh():
        return rm.clone(), rv.clone(), torch.zeros((), dtype=torch.int64, device=cuda)

    eager_stats = fresh()
    eager = [call(eager_stats) for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(fresh())
    torch.cuda.current_stream().wait_stream(side)
    graph_stats, graph = fresh(), torch.cuda.CUDAGraph()
    launches = bn.batch_norm_train.launches
    with torch.cuda.graph(graph):
        out = call(graph_stats)
    assert bn.batch_norm_train.launches - launches == 4
    for i in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, e) for a, e in zip(out, eager[i])), i
    assert all(torch.equal(a, e) for a, e in zip(graph_stats, eager_stats))
    assert int(graph_stats[2]) == 3
    assert not bn._tickets[torch.cuda.current_device()].any()


def test_batch_norm_kernels_refuse_what_they_do_not_take(cuda):
    """fp16 activations, a layout other than NCHW-contiguous (channels-last,
    transposed, strided), and parameters of the wrong size raise."""
    from dfine_tpu_torch.ops.kernels.batch_norm import batch_norm_train

    x, _, w, b, rm, rv = _bn_leaves(cuda, (2, 16, 8, 8), torch.bfloat16)
    nbt = torch.zeros((), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="bf16 or f32"):
        batch_norm_train(x.half(), w, b, rm, rv, nbt, 0.1, 1e-5)
    for other in (x.contiguous(memory_format=torch.channels_last), x.transpose(2, 3),
                  x[:, :, :, ::2]):
        with pytest.raises(ValueError, match="NCHW-contiguous"):
            batch_norm_train(other, w, b, rm, rv, nbt, 0.1, 1e-5)
    with pytest.raises(ValueError, match="weight"):
        batch_norm_train(x, w[:8], b, rm, rv, nbt, 0.1, 1e-5)


def test_train_forward_takes_the_batch_norm_kernels(cuda):
    """A train-mode forward and backward of the n det+seg model on the card
    (bf16 autocast) takes the kernels at every BatchNorm: ``train.bn_kernel``
    once each, no ``train.bn_plain``, 4 launches each."""
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.models.layers import BatchNorm2d
    from dfine_tpu_torch.ops.kernels.batch_norm import batch_norm_train
    from dfine_tpu_torch.utils import profiling

    torch.manual_seed(0)
    model = build_model("n", 5, True, device=cuda).train()
    n_bn = sum(isinstance(m, BatchNorm2d) for m in model.modules())
    images = torch.rand(2, 3, 320, 320, device=cuda)
    launches = batch_norm_train.launches
    profiling.drain()
    with profiling.tracing(True):
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = model(images)
        sum(v.float().sum() for v in out.values() if torch.is_tensor(v) and v.requires_grad
            ).backward()
    torch.cuda.synchronize()
    counters = profiling.drain()["counters"]
    assert counters.get("train.bn_kernel") == n_bn and "train.bn_plain" not in counters
    assert batch_norm_train.launches - launches == 4 * n_bn
