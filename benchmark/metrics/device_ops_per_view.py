"""Device operations (kernels, copies, fills) per view in the traced
stretch: what one ``render_camera`` dispatches."""


def read(trace):
    if trace.kind != "view_orbit" or not trace.ops or not trace.units:
        return None
    return len(trace.ops) / len(trace.units)
