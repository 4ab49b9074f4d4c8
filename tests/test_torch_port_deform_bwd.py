"""The deformable-attention core's backward on the CPU.

``ms_deform_attn_bwd_plain`` (the closed form that the backward kernel
``csrc/ms_deform_attn_bwd.cu`` is held against on the card) with the plain
scatters, against ``jax.grad`` of the JAX package's
``ms_deform_attn_core_fused(scatter_impl=..., interpret=True)`` (its custom
VJP, ``dfine_tpu/ops/deform_attn.py:306-434``, with the Pallas scatters in
interpret mode), on the cases of ``test_torch_port_deform_cases`` (head dims
16, 32 and 64, pixel edges and centres, one level, four levels, every
location off the map), for each scatter: ``pallas`` (f32 payload),
``mxu`` and ``tiled`` (each contribution rounded once to bf16).

Tolerance: each gradient within 2e-4 of its largest |value|
(``test_torch_port_ops.py``'s core-gradient rule, test_pallas_scatter.py:
69-78): both sides sum in f32 in other orders (g.v over d, the corners, the
scatter's entries). With the bf16 payload the two sides round the same f32
products once to bf16, so they agree to the same rule.

Also: the plain backward element for element equal to the closed form as
``MSDeformAttnCore.backward`` ran it before it moved (kept below as
``_closed_form_before``), the autograd path bit-equal to the plain backward
with the plain scatters, and the value frozen (no value gradient, the other
two unchanged).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_port_helpers  # noqa: F401  (thread count)
from test_torch_port_deform_cases import (DEFORM_CASES, HEADS, TILING_CASES, TILING_DIMS,
                                         deform_case, tiling_case)

GRAD_REL = 2e-4
IMPLS = ("pallas", "mxu", "tiled")


def _case(name):
    """A case of test_torch_port_deform_cases and g_out [B, Q, 8 d]."""
    value, shapes, loc, att, pts = deform_case(name)
    b, q, d = value.shape[0], loc.shape[1], value.shape[3]
    g_out = np.random.default_rng(1).normal(size=(b, q, HEADS * d)).astype(np.float32)
    return value, shapes, loc, att, pts, g_out


def _jax_grads(value, shapes, loc, att, pts, g_out, impl):
    from dfine_tpu.ops.deform_attn import ms_deform_attn_core_fused

    def loss(v, l, a):
        out = ms_deform_attn_core_fused(v, shapes, l, a, pts, interpret=True, scatter_impl=impl)
        return (out * jnp.asarray(g_out)).sum()

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(att))]


def _payload(impl):
    return torch.float32 if impl == "pallas" else torch.bfloat16


def _plain_grads(value, shapes, loc, att, pts, g_out, impl):
    """The plain backward, then each level's plain scatter: (value, loc,
    att) gradients."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd_plain
    from dfine_tpu_torch.ops.kernels.scatter_rows import (rows_scatter_add_bf16_plain,
                                                          rows_scatter_add_plain)

    scatter = rows_scatter_add_plain if impl == "pallas" else rows_scatter_add_bf16_plain
    v = torch.from_numpy(value)
    ga, gl, idx, contrib = ms_deform_attn_bwd_plain(
        v, shapes, torch.from_numpy(loc), torch.from_numpy(att), torch.from_numpy(g_out), pts,
        _payload(impl))
    b, _, nhead, d = value.shape
    parts = [scatter(i, c, h * w).reshape(b, nhead, h * w, d).permute(0, 2, 1, 3)
             for (h, w), i, c in zip(shapes, idx, contrib)]
    return torch.cat(parts, 1), gl, ga


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", DEFORM_CASES)
def test_plain_backward_matches_jax(case, impl):
    """The plain backward and plain scatters against JAX's gradients
    (within 2e-4 of the largest); MSDeformAttnCore's autograd on the CPU
    gives the same gradients bit for bit."""
    from dfine_tpu_torch.ops import deform_attn as tda

    value, shapes, loc, att, pts, g_out = _case(case)
    ref = _jax_grads(value, shapes, loc, att, pts, g_out, impl)
    ours = _plain_grads(value, shapes, loc, att, pts, g_out, impl)
    for name, got, want in zip(("value", "loc", "att"), ours, ref):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_REL * (np.abs(want).max() + 1e-30), err_msg=name)
    tda.set_deform_bwd(impl)
    try:
        v, l, a = (torch.from_numpy(x).requires_grad_() for x in (value, loc, att))
        (tda.ms_deform_attn(v, shapes, l, a, pts) * torch.from_numpy(g_out)).sum().backward()
    finally:
        tda.set_deform_bwd("pallas")
    for name, got, want in zip(("value", "loc", "att"), (v.grad, l.grad, a.grad), ours):
        assert torch.equal(got, want), name


# every tiling case with the bf16 payload; the f32 one (JAX's f32 scatter
# compiles for ~13 s a shape on the CPU) at one case of each head dim
TILING_IMPLS = [(case, "mxu") for case in TILING_CASES] + [
    (case, "pallas") for case in ("q1", "q7", "q500")]


@pytest.mark.parametrize("case,impl", TILING_IMPLS)
def test_plain_backward_matches_jax_on_tiling_cases(case, impl):
    """The edges of the backward kernel's work tiling
    (``test_torch_port_deform_cases.TILING_CASES``: 1, 7, 301 and 500
    queries, B * H = 1, a level with one point, 16 points over 4 levels; head
    dims 16, 32 and 64): the plain backward and the plain scatter, bf16
    payload (``mxu``) and f32 (``pallas``), against JAX's gradients within
    2e-4 of the largest."""
    value, shapes, loc, att, pts = tiling_case(case)
    b, q, heads = loc.shape[:3]
    g_out = np.random.default_rng(2).normal(
        size=(b, q, heads * TILING_DIMS[case])).astype(np.float32)
    ref = _jax_grads(value, shapes, loc, att, pts, g_out, impl)
    ours = _plain_grads(value, shapes, loc, att, pts, g_out, impl)
    for name, got, want in zip(("value", "loc", "att"), ours, ref):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_REL * (np.abs(want).max() + 1e-30), err_msg=name)


def test_off_the_map_gives_no_entry_and_zero_gradients():
    """``off_the_map``: every idx -1, every contribution and both gradients
    exactly 0, and so the value gradient; JAX's gradients are 0 too."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd_plain

    value, shapes, loc, att, pts, g_out = _case("off_the_map")
    ga, gl, idx, contrib = ms_deform_attn_bwd_plain(
        torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(att),
        torch.from_numpy(g_out), pts)
    assert all((i == -1).all() for i in idx) and all(torch.count_nonzero(c) == 0 for c in contrib)
    assert torch.count_nonzero(ga) == 0 and torch.count_nonzero(gl) == 0
    assert torch.count_nonzero(_plain_grads(value, shapes, loc, att, pts, g_out, "pallas")[0]) == 0
    assert not any(np.count_nonzero(x) for x in _jax_grads(value, shapes, loc, att, pts, g_out,
                                                           "pallas"))


# The closed form as MSDeformAttnCore.backward ran it before it moved into
# ms_deform_attn_bwd_plain, kept as the reference of the move: the level's
# (idx, contrib) concatenated over the corners.
_CORNER_TABLE = (
    (0, 0, lambda fx, fy: (1 - fx) * (1 - fy), lambda fx, fy: -(1 - fy), lambda fx, fy: -(1 - fx)),
    (0, 1, lambda fx, fy: fx * (1 - fy), lambda fx, fy: (1 - fy), lambda fx, fy: -fx),
    (1, 0, lambda fx, fy: (1 - fx) * fy, lambda fx, fy: -fy, lambda fx, fy: (1 - fx)),
    (1, 1, lambda fx, fy: fx * fy, lambda fx, fy: fy, lambda fx, fy: fx),
)


def _closed_form_before(value, shapes, loc, att, g_out, pts, payload):
    b, q = loc.shape[:2]
    nhead, d = value.shape[2], value.shape[3]
    f32 = torch.float32
    g = g_out.reshape(b, q, nhead, d).to(f32)
    att32 = att.to(f32)
    grad_loc = torch.zeros(loc.shape, dtype=f32, device=loc.device)
    grad_att = torch.zeros(att.shape, dtype=f32, device=att.device)
    streams = []
    hw_start = p_start = 0
    for (h, w), p in zip(shapes, pts):
        hw = h * w
        v_t = value[:, hw_start : hw_start + hw].to(f32).permute(0, 2, 1, 3)
        l = loc[:, :, :, p_start : p_start + p].to(f32)
        a = att32[:, :, :, p_start : p_start + p]
        x = l[..., 0] * w - 0.5
        y = l[..., 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.long()
        y0i = y0.long()
        ga_l = torch.zeros_like(a)
        gfx = torch.zeros_like(a)
        gfy = torch.zeros_like(a)
        idx_parts, contrib_parts = [], []
        for dy, dx, w_fn, dwdx_fn, dwdy_fn in _CORNER_TABLE:
            xi = x0i + dx
            yi = y0i + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            idx_t = idx.permute(0, 2, 1, 3).reshape(b, nhead, q * p, 1)
            vc = torch.gather(v_t, 2, idx_t.expand(-1, -1, -1, d))
            vc = vc.reshape(b, nhead, q, p, d).permute(0, 2, 1, 3, 4)
            g_dot_v = torch.einsum("bqhd,bqhpd->bqhp", g, vc)
            m = valid.to(f32)
            wgt = w_fn(fx, fy) * m
            ga_l = ga_l + wgt * g_dot_v
            gfx = gfx + m * dwdx_fn(fx, fy) * g_dot_v
            gfy = gfy + m * dwdy_fn(fx, fy) * g_dot_v
            contrib = (a * wgt)[..., None] * g[:, :, :, None, :]
            idx_eff = torch.where(valid, idx, -1)
            idx_parts.append(idx_eff.permute(0, 2, 1, 3).reshape(b * nhead, q * p))
            contrib_parts.append(
                contrib.permute(0, 2, 1, 3, 4).reshape(b * nhead, q * p, d).to(payload))
        grad_att[:, :, :, p_start : p_start + p] = ga_l
        grad_loc[:, :, :, p_start : p_start + p, 0] = a * gfx * w
        grad_loc[:, :, :, p_start : p_start + p, 1] = a * gfy * h
        streams.append((torch.cat(idx_parts, 1).to(torch.int32).contiguous(),
                        torch.cat(contrib_parts, 1).contiguous()))
        hw_start += hw
        p_start += p
    return grad_att, grad_loc, streams


@pytest.mark.parametrize("payload", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DEFORM_CASES)
def test_plain_backward_is_the_closed_form_it_replaced(case, payload):
    """Element for element (bit for bit, the signs of zeros too): the
    gradients, each level's idx and contrib."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd_plain

    value, shapes, loc, att, pts, g_out = _case(case)
    args = [torch.from_numpy(x) for x in (value, loc, att, g_out)]
    ga, gl, idx, contrib = ms_deform_attn_bwd_plain(args[0], shapes, args[1], args[2], args[3],
                                                    pts, payload)
    ra, rl, streams = _closed_form_before(args[0], shapes, args[1], args[2], args[3], pts,
                                          payload)
    bits = torch.int16 if payload == torch.bfloat16 else torch.int32
    assert torch.equal(ga.view(torch.int32), ra.view(torch.int32))
    assert torch.equal(gl.view(torch.int32), rl.view(torch.int32))
    assert len(idx) == len(contrib) == len(streams) == len(shapes)
    for i, c, (ri, rc) in zip(idx, contrib, streams):
        assert i.dtype == torch.int32 and c.dtype == payload and c.is_contiguous()
        assert torch.equal(i, ri) and torch.equal(c.view(bits), rc.view(bits))


@pytest.mark.parametrize("impl", IMPLS)
def test_value_frozen(impl):
    """The value frozen (no value gradient wanted): the plain backward
    writes no idx and no contrib, and MSDeformAttnCore gives the location
    and attention gradients of the full backward bit for bit, with an
    incoming gradient that is not contiguous (the output used transposed),
    at four levels; both against JAX within 2e-4 of the largest."""
    from dfine_tpu_torch.ops import deform_attn as tda
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd_plain

    value, shapes, loc, att, pts, g_out = _case("four_levels")
    args = [torch.from_numpy(x) for x in (value, loc, att, g_out)]
    frozen = ms_deform_attn_bwd_plain(args[0], shapes, args[1], args[2], args[3], pts,
                                      _payload(impl), need_value=False)
    full = ms_deform_attn_bwd_plain(args[0], shapes, args[1], args[2], args[3], pts,
                                    _payload(impl))
    assert frozen[2] is None and frozen[3] is None
    assert torch.equal(frozen[0], full[0]) and torch.equal(frozen[1], full[1])
    g_t = args[3].transpose(0, 1).contiguous()  # [Q, B, H*D]: the gradient arrives transposed
    tda.set_deform_bwd(impl)
    try:
        l, a = (t.clone().requires_grad_() for t in args[1:3])
        out = tda.ms_deform_attn(args[0], shapes, l, a, pts).transpose(0, 1)
        (out * g_t).sum().backward()
    finally:
        tda.set_deform_bwd("pallas")
    assert torch.equal(l.grad, full[1]) and torch.equal(a.grad, full[0])
    ref = _jax_grads(value, shapes, loc, att, pts, g_out, impl)
    for name, got, want in (("loc", l.grad, ref[1]), ("att", a.grad, ref[2])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max(), err_msg=name)
