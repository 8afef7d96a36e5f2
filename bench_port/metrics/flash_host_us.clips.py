"""Median host time of a flash forward call in its wrapper, the launch
included (``ops.flash_fwd``), us."""

from bench_port.spans import median_ms


def read(run):
    ms = median_ms(run, "ops.flash_fwd")
    return None if ms is None else 1e3 * ms
