"""Share of the wall time in which no kernel, copy or fill runs on the
device: the device's busy time per unit (the profiler's device intervals,
merged, over the traced stretch) against the wall time per unit of the
untraced stretch timed just before it.  The profiler's host cost slows the
traced stretch's wall, not the device's work."""


def read(trace):
    if not trace.ops or not trace.units or not trace.plain_units or trace.plain_s <= 0:
        return None
    busy = trace.busy_s() / len(trace.units)
    return 100.0 * (1.0 - busy / (trace.plain_s / len(trace.plain_units)))
