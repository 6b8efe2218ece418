"""The whole training step's share of the chip's peak: the least time the
card could take for the work of the untraced stretch's iterations
(``work.train_step_s``: preprocess and SH both ways, the sort, both
blends, the loss, Adam) over that stretch's wall time."""

from benchmark import work


def read(trace):
    counts = trace.work(trace.plain_units)
    if trace.kind != "train_resume" or not counts or trace.plain_s <= 0:
        return None
    s = trace.shapes
    least = sum(work.train_step_s(w, s["capacity"], s["pixels"]) for w in counts)
    return 100.0 * least / trace.plain_s
