"""Exact min-cost assignment, the plain PyTorch version (port of
``dfine_tpu/ops/hungarian.py``).

The JAX package solves every (set, image) assignment of the train step on
the device, with a Jonker-Volgenant shortest-augmenting-path solver
(``_solve_one``, :48-145) vmapped over the problems. This is that solver
transcribed step for step and batched over problems [P, G, Q]:

* row reduction: ``u`` = each valid row's minimum, ``v = 0``; each column
  goes to the valid row with the smallest index whose argmin it is (ties of
  the argmin to the smaller column, as ``jnp.argmin``); the other valid
  rows are pending, in index order;
* one shortest augmenting path per pending row: the reduced costs
  ``((minval + cost[i]) - u[i]) - v`` in f32, in that order; done columns
  masked with ``1e30``; the argmin's ties to the smaller column;
* then the duals over the scanned sets, and the augmentation along
  ``pred``.

Each pass of the loop below takes one path step of every problem whose path
is open, and it loops while any problem has an open path or a pending row,
as ``vmap`` runs a ``while_loop`` until its last lane is done. Each
operation is the JAX solver's own f32 add or subtract in its order, so the
assignment is JAX's, element for element. ``csrc/hungarian_lap.cu`` is the
kernel (``ops/kernels/hungarian.py``); this is what it is held against and
what CPU tensors take.
"""

from __future__ import annotations

from typing import Optional

import torch

INF = 1e30  # the JAX solver's mask of done columns (an f32 1e30)


@torch.no_grad()
def lap_plain(cost: torch.Tensor, valid: torch.Tensor,
              steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cost [P, G, Q] f32 (G <= Q), valid [P, G] bool -> col4row [P, G]
    int32, the column of each row, -1 on rows that are not valid. ``steps``
    [P] (any integer type) gets each problem's path steps: the argmins its
    augmenting paths took, 0 where the row reduction assigned every row."""
    p, g, q = cost.shape
    dev = cost.device
    if steps is not None:
        steps.zero_()
    if p == 0 or g == 0:
        return torch.full((p, g), -1, dtype=torch.int32, device=dev)
    ar = torch.arange(p, device=dev)
    rows = torch.arange(g, device=dev)
    # ---- row reduction: u = row min, v = 0
    jmin = cost.argmin(2)  # [P, G], ties to the smaller column
    u = torch.where(valid, cost.gather(2, jmin[..., None])[..., 0], 0.0)
    # column j to the smallest valid row whose argmin it is (column q absorbs the rest)
    row4col = torch.full((p, q + 1), g, dtype=torch.long, device=dev)
    row4col.scatter_reduce_(1, torch.where(valid, jmin, q), rows.expand(p, g), "amin")
    row4col = row4col[:, :q]
    won = valid & (row4col.gather(1, jmin) == rows)
    col4row = torch.where(won, jmin, -1)
    row4col = torch.where(row4col < g, row4col, -1)
    v = torch.zeros((p, q), dtype=torch.float32, device=dev)
    # the pending rows, compacted to the front in index order
    pending = valid & (col4row < 0)
    n_pending = pending.sum(1)
    order = torch.argsort(torch.where(pending, rows, g + rows), dim=1)

    k = torch.zeros(p, dtype=torch.long, device=dev)
    active = k < n_pending  # a path is open
    cur = order[:, 0].clone()
    i = cur.clone()
    minval = torch.zeros(p, dtype=torch.float32, device=dev)
    shortest = torch.full((p, q), INF, dtype=torch.float32, device=dev)
    pred = torch.zeros((p, q), dtype=torch.long, device=dev)
    done = torch.zeros((p, q), dtype=torch.bool, device=dev)
    scanned = torch.zeros((p, g), dtype=torch.bool, device=dev)
    while bool(active.any()):
        # ---- one step of every open path, from row i
        if steps is not None:
            steps += active.to(steps.dtype)
        a = active[:, None]
        scanned[ar, i] |= active
        rc = ((minval[:, None] + cost[ar, i]) - u.gather(1, i[:, None])) - v
        upd = (rc < shortest) & ~done & a
        shortest = torch.where(upd, rc, shortest)
        pred = torch.where(upd, i[:, None], pred)
        masked = torch.where(done, INF, shortest)
        j = masked.argmin(1)  # ties to the smaller column
        minval = torch.where(active, masked.gather(1, j[:, None])[:, 0], minval)
        done[ar, j] |= active
        r4c = row4col.gather(1, j[:, None])[:, 0]
        sink = active & (r4c < 0)  # the path ends at a free column
        i = torch.where(active & (r4c >= 0), r4c, i)
        if not bool(sink.any()):
            continue
        # ---- duals over the scanned sets of the finished paths
        s = sink[:, None]
        mv = minval[:, None]
        short_at_assigned = shortest.gather(1, col4row.clamp(0, q - 1))
        delta = torch.where(rows == cur[:, None], mv,
                            torch.where(scanned, mv - short_at_assigned, 0.0))
        u = torch.where(s, u + delta, u)
        v = torch.where(s & done, v - (mv - shortest), v)
        # ---- augment along pred, one link of every finished path a pass
        col = torch.where(sink, j, 0)
        walking = sink
        while bool(walking.any()):
            r = pred[ar, col]
            row4col[ar, col] = torch.where(walking, r, row4col[ar, col])
            nxt = col4row[ar, r]
            col4row[ar, r] = torch.where(walking, col, nxt)
            walking = walking & (r != cur)
            col = torch.where(walking, nxt, 0)
        # ---- the next pending row of each finished problem
        k = k + sink.long()
        active = k < n_pending
        new = sink & active
        nb = new[:, None]
        cur = torch.where(new, order.gather(1, k.clamp_max(g - 1)[:, None])[:, 0], cur)
        i = torch.where(new, cur, i)
        minval = torch.where(new, 0.0, minval)
        shortest = torch.where(nb, INF, shortest)
        pred = torch.where(nb, 0, pred)
        done = done & ~nb
        scanned = scanned & ~nb
    return col4row.to(torch.int32)


def check_steps(steps: Optional[torch.Tensor], lead, device) -> None:
    """Raise unless ``steps`` is None or a contiguous int32 tensor of shape
    ``lead`` (the costs' leading shape) on ``device``."""
    if steps is not None and (steps.dtype != torch.int32 or tuple(steps.shape) != tuple(lead)
                              or not steps.is_contiguous() or steps.device != device):
        raise ValueError(f"steps must be a contiguous int32 tensor of shape {tuple(lead)} on "
                         f"{device}, got {steps.dtype} {tuple(steps.shape)} on {steps.device}")


def hungarian(cost: torch.Tensor, row_valid: Optional[torch.Tensor] = None,
              steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched exact min-cost assignment (``dfine_tpu.ops.hungarian.hungarian``):
    cost [..., G, Q] with G <= Q, row_valid [..., G] bool (rows marked False
    are skipped and get -1). Returns col4row [..., G] int32, the column of
    each row. ``steps`` (int32, the leading shape) gets each problem's path
    steps. The plain version, on the costs' device."""
    g, q = cost.shape[-2:]
    if g > q:
        raise ValueError(f"hungarian takes G <= Q (rows no more than columns), got G = {g}, "
                         f"Q = {q}")
    lead = tuple(cost.shape[:-2])
    check_steps(steps, lead, cost.device)
    flat = cost.detach().float().reshape(-1, g, q)
    if row_valid is None:
        valid = torch.ones(flat.shape[:2], dtype=torch.bool, device=cost.device)
    else:
        valid = row_valid.to(torch.bool).broadcast_to(*lead, g).reshape(-1, g)
    return lap_plain(flat, valid, None if steps is None else steps.view(-1)).reshape(*lead, g)
