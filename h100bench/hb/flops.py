"""Model FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode`` over
a family's reference on the ``meta`` device: the same count whatever the
program uses to do the work, so that the whole step's share of the peak
still bounds a later PR's gain after a kernel is taken off the path.  What
a request or a train step runs is its family's (``request_flops``,
``train_step_flops``)."""

from torch.utils.flop_counter import FlopCounterMode


def count(fn) -> int:
    """The FLOPs of calling ``fn()``."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()
