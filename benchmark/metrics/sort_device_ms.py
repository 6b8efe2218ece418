"""Device milliseconds per unit (a view or an iteration) of the operations
launched inside the benchmark's range around
``ops.instances.build_instances`` (the expansion K1, the stable radix sort
and the tile ranges); the render reaches it through that module attribute."""

RANGE = ("gaussian_splatting_torch.ops.instances", "build_instances")


def read(trace):
    calls = trace.range_calls(RANGE)
    if not calls or sum(calls) <= 0 or not trace.units:
        return None
    return 1000.0 * sum(calls) / len(trace.units)
