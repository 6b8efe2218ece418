"""K2's share of its roofline: the least time of the forward blend's work
(``work.k2``, counted on the reference's lists at each traced unit's
camera) over K2's device time in the traced stretch."""

from benchmark import work

KERNELS = ("blend_forward_kernel",)


def read(trace):
    t = trace.kernel_s(KERNELS)
    counts = trace.work(trace.units)
    if t <= 0 or not counts:
        return None
    return 100.0 * sum(work.roofline_s(*work.k2(w)) for w in counts) / t
