"""The flash forward (ops.attention.flash_attention_fwd, K2): its calls'
least time over the device time under their ranges, %."""

from bench_port.readings import roofline_pct


def read(run):
    return roofline_pct(run, "bench::flash_fwd")
