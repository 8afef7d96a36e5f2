"""The whole serving step's share of the bf16 peak: the model FLOPs of
the clips served in the traced window (padded bucket rows not counted)
over the window, %."""

from bench_port.readings import mfu_pct


def read(run):
    return mfu_pct(run, getattr(run, "trace_items", 0) * run.flops_per_clip)
