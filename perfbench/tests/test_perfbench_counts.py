"""The yardstick's counts against hand counts at tiny shapes."""

import torch

from perfbench.counts import deform, flops, peaks


def _call(loc, heads=1, d=4, shapes=((2, 2),), points=(1,)):
    b, q = loc.shape[:2]
    s = sum(h * w for h, w in shapes)
    att = torch.full((b, q, heads, sum(points)), 1.0)
    return (shapes, points, (b, s, heads, d), loc, att)


def test_touched_rows_and_corners():
    # one point at a pixel centre of a 2x2 map: its 4 corners are (0,0),
    # (1,0), (0,1), (1,1) with x0 = floor(0.25 * 2 - 0.5) = 0: all valid
    loc = torch.tensor([0.25, 0.25]).view(1, 1, 1, 1, 2)
    assert deform.touched(loc, ((2, 2),), (1,), 4) == (4, 4)
    # at the map's corner only one of the 4 corners lies on the map
    loc = torch.tensor([0.0, 0.0]).view(1, 1, 1, 1, 2)
    assert deform.touched(loc, ((2, 2),), (1,), 4) == (1, 1)
    # off the map: nothing read
    loc = torch.tensor([2.0, 2.0]).view(1, 1, 1, 1, 2)
    assert deform.touched(loc, ((2, 2),), (1,), 4) == (0, 0)
    # two queries reading the same rows count them once
    loc = torch.tensor([0.25, 0.25]).view(1, 1, 1, 1, 2).expand(1, 2, 1, 1, 2)
    assert deform.touched(loc, ((2, 2),), (1,), 4) == (4, 8)


def test_forward_and_backward_counts():
    loc = torch.tensor([0.25, 0.25]).view(1, 1, 1, 1, 2)
    call = _call(loc)
    # 4 rows x 4 channels x 2 bytes, loc 2 x 4, att 1 x 4, out 4 x 4
    assert deform.forward_call(call) == (4 * 4 * 2 + 8 + 4 + 16, 4 * 2 * 4 + 1 * 2 * 4)
    # reads: rows 32, (loc + att) twice 24, g_out 16; writes: 4 entries x (4 + 16)
    assert deform.backward_call(call) == (32 + 24 + 16 + 4 * 20, 4 * 2 * 4 + 4 * 4)
    nbytes, ops = deform.forward_call(call)
    assert deform.least_seconds_of([call], deform.forward_call) == peaks.least_seconds(nbytes, ops)


def test_flop_counter_counts_two_a_multiply_add():
    lin = torch.nn.Linear(8, 5, bias=False)
    x = torch.ones(3, 8)
    assert flops.counted(lambda: lin(x)) == 2 * 3 * 8 * 5
    conv = torch.nn.Conv2d(2, 4, 3, padding=1, bias=False)
    assert flops.counted(lambda: conv(torch.ones(1, 2, 5, 5))) == 2 * 25 * 4 * 2 * 9
