"""Kernels launched in the traced window a clip served in it."""


def read(run):
    trace, clips = getattr(run, "trace", None), getattr(run, "trace_items", 0)
    return trace.kernels / clips if trace is not None and clips else None
