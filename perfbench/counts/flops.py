"""Operations of a forward (serving) or a forward and backward (training)
of the reference at the cell's shapes, by ``torch.utils.flop_counter``
(2 a multiply-add over the matrix products, convolutions and attention;
the deformable sampling, the norms and the elementwise work are outside
it)."""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def counted(fn) -> int:
    """The operations ``fn()`` runs, as the counter counts them."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
