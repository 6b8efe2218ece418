"""Device operations (kernels, copies, fills) per training iteration in
the traced stretch: what the host loop and the step dispatch."""


def read(trace):
    if trace.kind != "train_resume" or not trace.ops or not trace.units:
        return None
    return len(trace.ops) / len(trace.units)
