"""A whole view's share of the chip's peak: the least time the card could
take for the work of the untraced stretch's views (``work.view_s``:
preprocess and SH, the sort, the forward blend) over that stretch's wall
time."""

from benchmark import work


def read(trace):
    counts = trace.work(trace.plain_units)
    if trace.kind != "view_orbit" or not counts or trace.plain_s <= 0:
        return None
    return 100.0 * sum(work.view_s(w, trace.shapes["capacity"]) for w in counts) / trace.plain_s
