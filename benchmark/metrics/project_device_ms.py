"""Device milliseconds per view of the operations launched inside the
benchmark's range around ``ops.rasterize.project``, the render core's
per-Gaussian stage: K8 where the program has it (activation, projection,
spans, SH and the blend table in one pass), else ``preprocess`` and SH.
The render reaches it through that module attribute."""

RANGE = ("gaussian_splatting_torch.ops.rasterize", "project")


def read(trace):
    calls = trace.range_calls(RANGE)
    if not calls or sum(calls) <= 0 or not trace.units:
        return None
    return 1000.0 * sum(calls) / len(trace.units)
