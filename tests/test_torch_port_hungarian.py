"""The port's exact Hungarian solver (``dfine_tpu_torch/ops/hungarian.py``,
the plain version the CPU takes and the CUDA kernel is held against) on the
CPU against the JAX package's on-device solver
(``dfine_tpu.ops.hungarian.hungarian``) and scipy's
``linear_sum_assignment`` as an independent witness of the optimum, on
numpy-seeded problems (``test_torch_port_hungarian_cases.py``): pad rows,
an image with no valid row, square G = Q, G = 1, Q of 40, 300 and 500,
integer costs with ties, and every [S, B, G, Q] stack that
``solve_matchings`` sees on the port's train paths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_hungarian_cases import CASES, assert_optimal, hungarian_case, integer_case


@pytest.mark.parametrize("case", CASES)
def test_hungarian_equals_jax(case):
    """Continuous costs: the plain solver's col4row equals JAX's element for
    element, and its optimum is scipy's within rtol 1e-6."""
    from dfine_tpu.ops.hungarian import hungarian as jax_hungarian

    from dfine_tpu_torch.ops.hungarian import hungarian

    cost, valid = hungarian_case(case)
    solve = jax.jit(jax_hungarian)
    if case == "square":
        # one problem a call: under vmap a lane whose pending rows are done
        # still runs the path search of the slowest lane, and with every row
        # of a square problem assigned no free column ends it (the JAX
        # solver does not return); the train step's problems are never square
        ref = np.stack([np.stack([np.asarray(solve(jnp.asarray(cost[si, bi]),
                                                   jnp.asarray(valid[bi])))
                                  for bi in range(cost.shape[1])])
                        for si in range(cost.shape[0])])
    else:
        ref = np.asarray(solve(jnp.asarray(cost), jnp.asarray(valid)))
    ours = hungarian(torch.from_numpy(cost), torch.from_numpy(valid))
    assert ours.dtype == torch.int32 and ours.shape == cost.shape[:3]
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert_optimal(cost, valid, ours.numpy())


@pytest.mark.parametrize("g,q", [(12, 40), (40, 40)])
def test_hungarian_on_integer_costs_reaches_the_optimum(g, q):
    """Integer costs in [0, 4) tie everywhere: the assignment has scipy's
    optimum (exactly: the totals are small integers) and JAX's total; every
    row valid (``row_valid=None``)."""
    from dfine_tpu.ops.hungarian import hungarian as jax_hungarian

    from dfine_tpu_torch.ops.hungarian import hungarian

    cost, valid = integer_case(g, q)
    solve = jax.jit(jax_hungarian)
    if g == q:  # one problem a call (see test_hungarian_equals_jax)
        ref = np.stack([np.stack([np.asarray(solve(jnp.asarray(cost[si, bi])))
                                  for bi in range(4)]) for si in range(3)])
    else:
        ref = np.asarray(solve(jnp.asarray(cost)))
    ours = hungarian(torch.from_numpy(cost)).numpy()
    assert_optimal(cost, valid, ours, rtol=0)
    rows = np.arange(g)
    for si in range(3):
        for bi in range(4):
            assert cost[si, bi, rows, ours[si, bi]].sum() == cost[si, bi, rows, ref[si, bi]].sum()


def test_cpu_wrapper_takes_the_plain_version():
    """``hungarian_lap`` on CPU tensors is the plain version (no launch
    counted), takes a [B, G] row_valid broadcast over the sets, and refuses
    G > Q on any device."""
    from dfine_tpu_torch.ops.hungarian import hungarian
    from dfine_tpu_torch.ops.kernels import hungarian_lap, launch_counts, reset_launch_counts

    cost, valid = hungarian_case("pads_q40")
    reset_launch_counts()
    got = hungarian_lap(torch.from_numpy(cost), torch.from_numpy(valid))
    assert launch_counts()["hungarian_lap"] == 0
    assert torch.equal(got, hungarian(torch.from_numpy(cost),
                                      torch.from_numpy(valid)[None].expand(3, -1, -1)))
    with pytest.raises(ValueError, match="G <= Q"):
        hungarian_lap(torch.zeros(2, 5, 4))


# the [S, B, G, Q] stacks solve_matchings sees: the criterion tests' random
# outputs (q = 24), n at 320 px (S = 5: final, 2 aux, pre, enc) at batch 2
# and 4 with 4 GT slots, m (S = 6) at batch 8 and l (S = 8) at batch 4 with
# 100 slots
STACKS = [(5, 2, 4, 24), (5, 2, 4, 300), (5, 4, 4, 300), (6, 8, 100, 300), (8, 4, 100, 300)]


@pytest.mark.parametrize("shape", STACKS, ids=lambda s: "x".join(map(str, s)))
def test_solve_matchings_equals_jax(shape):
    """``solve_matchings`` on the port's own matching costs of random
    outputs against the JAX package's on the same costs: match, go_q, go_t
    and go_valid equal element for element."""
    from dfine_tpu.matcher import solve_matchings as jax_solve

    from dfine_tpu_torch.matcher import MatcherConfig, matching_cost, solve_matchings

    s, b, g, q = shape
    rng = np.random.default_rng(q + 7 * g + b)
    n_valid = rng.integers(1, g + 1, (b, 1)) if g < 10 else rng.integers(5, 41, (b, 1))
    valid = np.arange(g)[None] < n_valid
    valid[-1] = False
    logits = rng.normal(size=(s, b, q, 5)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (s, b, q, 2)),
                            rng.uniform(0.05, 0.4, (s, b, q, 2))], -1).astype(np.float32)
    labels = rng.integers(0, 5, (b, g))
    tboxes = np.concatenate([rng.uniform(0.2, 0.8, (b, g, 2)),
                             rng.uniform(0.05, 0.4, (b, g, 2))], -1).astype(np.float32)
    t = torch.from_numpy
    costs = matching_cost(t(logits), t(boxes), t(labels)[None].expand(s, -1, -1), t(tboxes),
                          t(valid), MatcherConfig())
    ours = solve_matchings(costs, t(valid))
    ref = jax.jit(jax_solve)(jnp.asarray(costs.numpy()), jnp.asarray(valid))
    for name, a, r in zip(("match", "go_q", "go_t", "go_valid"), ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=name)


def test_plain_counts_no_step_without_pending_rows():
    """Every valid row's argmin its own column: the row reduction assigns
    every row, no path step is counted, and the assignment is the argmins."""
    from test_torch_port_hungarian_cases import no_pending_case

    from dfine_tpu_torch.ops.hungarian import hungarian

    cost, valid = no_pending_case()
    steps = torch.full(cost.shape[:2], -1, dtype=torch.int32)
    got = hungarian(torch.from_numpy(cost), torch.from_numpy(valid), steps=steps).numpy()
    assert (steps == 0).all()
    rows = np.arange(cost.shape[2])
    np.testing.assert_array_equal(got, np.broadcast_to(np.where(valid, rows, -1), got.shape))


def test_plain_counts_the_path_steps_of_a_hand_checked_case():
    """Problem 0: rows [1, 2, 3] and [1, 5, 6] both reduce to column 0; row 0
    keeps it and row 1 pends. Its path: step 1 from row 1 reaches column 0
    (reduced cost 0), held by row 0; step 2 from row 0 reaches the free
    column 1 (reduced cost 1): 2 steps, then row 0 takes column 1 and row 1
    column 0 (total 3, the optimum). Problem 1 has distinct argmins: 0 steps.
    A wrong step tensor is refused."""
    from dfine_tpu_torch.ops.hungarian import hungarian

    cost = torch.tensor([[[1.0, 2.0, 3.0], [1.0, 5.0, 6.0]],
                         [[1.0, 2.0, 3.0], [4.0, 0.0, 6.0]]])
    steps = torch.empty(2, dtype=torch.int32)
    got = hungarian(cost, steps=steps)
    assert got.tolist() == [[1, 0], [0, 1]]
    assert steps.tolist() == [2, 0]
    with pytest.raises(ValueError, match="int32"):
        hungarian(cost, steps=torch.empty(2, dtype=torch.int64))


def test_size_cases_reach_both_staging_paths():
    """``cap_rows`` mirrors the kernel's shared-memory rule (its constants
    read from ``csrc/hungarian_lap.cu``), and the CUDA tests' size cases
    reach both of the kernel's paths: every problem of the staged cases
    fits; ``square_g320`` (10 columns a lane) and each ``unstaged`` case
    (16 and 32) hold a problem that does not, the latter beside one that
    does in the same launch."""
    import re
    from pathlib import Path

    from test_torch_port_hungarian_cases import MAX_SMEM, SIZE_CASES, cap_rows, size_case

    src = (Path(__file__).resolve().parents[1] / "dfine_tpu_torch" / "csrc"
           / "hungarian_lap.cu").read_text()
    assert int(re.search(r"kMaxSmem = (\d+);", src).group(1)) == MAX_SMEM
    assert "((size_t)g * 28 + (size_t)q * 8 + 15) / 16 * 16" in src
    assert cap_rows(100, 300) == 100 and cap_rows(64, 1024) == 54
    unstaged = {}
    for case, (g, q, _) in SIZE_CASES.items():
        rows = size_case(case)[1].sum(-1)
        cap = cap_rows(g, q)
        unstaged[case] = bool(rows.max() > cap)
        if case.startswith("unstaged"):
            assert ((rows > 0) & (rows <= cap)).any(), case
    assert {c for c, u in unstaged.items() if u} == {
        "square_g320", "unstaged_q480", "unstaged_q600", "unstaged_q1024"}
