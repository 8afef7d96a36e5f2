"""K1's packed-YUV420 entry (ops.preprocess.fused_normalize_yuv): its
calls' least time over the device time under their ranges, %."""

from bench_port.readings import roofline_pct


def read(run):
    return roofline_pct(run, "bench::k1_yuv")
