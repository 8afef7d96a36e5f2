"""The flash backward (ops.attention.flash_attention_bwd, K4) under the
autograd node: its calls' least time over the device time under their
ranges, %."""

from bench_port.readings import roofline_pct


def read(run):
    return roofline_pct(run, "bench::flash_bwd")
