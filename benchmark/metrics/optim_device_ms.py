"""Device milliseconds per training iteration of the operations launched
inside the benchmark's range around ``train.step.apply_gradients`` (Adam,
the densification statistics and the overflow guard; it runs under
``no_grad``, so the range holds all of its work)."""

RANGE = ("gaussian_splatting_torch.train.step", "apply_gradients")


def read(trace):
    calls = trace.range_calls(RANGE)
    if not calls or sum(calls) <= 0:
        return None
    return 1000.0 * sum(calls) / len(calls)
