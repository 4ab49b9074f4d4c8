"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. They skip where there is no card (a CUDA kernel has no CPU mode); run
them on a GPU machine with ``python -m pytest tests/test_torch_port_cuda.py``.
The CPU tests hold the plain versions against JAX."""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("d,shapes,pts", [(32, M_SHAPES, M_POINTS), (16, N_SHAPES, N_POINTS)])
@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_deform_fwd_kernel_matches_plain(cuda, d, shapes, pts, value_dtype):
    """Same inputs (the plain version reads the bf16 value as f32 too);
    max abs error <= 1e-5 (summation order)."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain

    value, loc, att = _inputs(cuda, 2, 300, 8, d, shapes, pts, value_dtype)
    before = ms_deform_attn_fwd.launches
    out = ms_deform_attn_fwd(value, shapes, loc, att, pts)
    torch.cuda.synchronize()
    assert ms_deform_attn_fwd.launches == before + 1
    ref = ms_deform_attn_fwd_plain(value, shapes, loc, att, pts)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max().item() <= 1e-5


def test_deform_fwd_kernel_out_of_range_is_exact_zero(cuda):
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd

    value, loc, att = _inputs(cuda, 1, 300, 8, 32, M_SHAPES, M_POINTS, torch.bfloat16)
    far = torch.tensor([-0.6, 1.7, -1e9, 1e9], device=cuda)
    loc = far[torch.randint(0, 4, loc.shape, device=cuda)]
    out = ms_deform_attn_fwd(value, M_SHAPES, loc, att, M_POINTS)
    assert torch.count_nonzero(out).item() == 0


def test_scatter_kernel_matches_plain(cuda):
    """atol 1e-4, rtol 1e-5 (atomics reorder the f32 sums); all-dropped
    gives exact zeros."""
    from dfine_tpu_torch.ops.kernels.scatter_rows import rows_scatter_add, rows_scatter_add_plain

    g = torch.Generator(device=cuda).manual_seed(0)
    for n, hw in ((3600, 6400), (7200, 1600), (3600, 400)):
        idx = torch.randint(-1, hw, (64, n), device=cuda, generator=g, dtype=torch.int32)
        contrib = torch.randn((64, n, 32), device=cuda, generator=g)
        out = rows_scatter_add(idx, contrib, hw)
        torch.testing.assert_close(out, rows_scatter_add_plain(idx, contrib, hw),
                                   atol=1e-4, rtol=1e-5)
        dropped = rows_scatter_add(torch.full_like(idx, -1), contrib, hw)
        assert torch.count_nonzero(dropped).item() == 0


def test_core_backward_matches_autograd_of_plain(cuda):
    """MSDeformAttnCore.backward (closed form + scatter kernel) against
    autograd of the plain core; tolerance of test_pallas_scatter.py:69-78."""
    from dfine_tpu_torch.ops.deform_attn import ms_deform_attn, ms_deform_attn_core
    from dfine_tpu_torch.ops.kernels.scatter_rows import rows_scatter_add

    value, loc, att = _inputs(cuda, 2, 300, 8, 32, M_SHAPES, M_POINTS, torch.float32)
    g_out = torch.randn((2, 300, 256), device=cuda)
    grads = []
    before = rows_scatter_add.launches
    for fn in (ms_deform_attn, ms_deform_attn_core):
        v, l, a = (t.clone().requires_grad_() for t in (value, loc, att))
        (fn(v, M_SHAPES, l, a, M_POINTS) * g_out).sum().backward()
        grads.append((v.grad, l.grad, a.grad))
    assert rows_scatter_add.launches == before + len(M_SHAPES)  # one per level
    for name, ours, ref in zip(("value", "loc", "att"), *grads):
        scale = ref.abs().max().item() + 1e-9
        assert (ours - ref).abs().max().item() <= 2e-4 * scale, name
