"""The whole training step's share of the bf16 peak: three times the
forward FLOPs of the frames stepped in the traced window over the window, %."""

from bench_port.readings import mfu_pct


def read(run):
    return mfu_pct(run, getattr(run, "trace_frames", 0) * run.flops_per_frame)
