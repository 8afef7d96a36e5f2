"""Median host time of a batch's host-to-device copy (``serve.h2d``), ms."""

from bench_port.spans import median_ms


def read(run):
    return median_ms(run, "serve.h2d")
