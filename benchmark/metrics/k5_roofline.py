"""K5's share of its roofline: the least time of the backward blend's work
(``work.k5``: 17 operations per replayed pair, 37 more per contributing
one, counted on the reference's lists at each traced step's camera) over
K5's device time in the traced stretch."""

from benchmark import work

KERNELS = ("blend_backward_kernel",)


def read(trace):
    t = trace.kernel_s(KERNELS)
    counts = trace.work(trace.units)
    if t <= 0 or not counts:
        return None
    return 100.0 * sum(work.roofline_s(*work.k5(w)) for w in counts) / t
