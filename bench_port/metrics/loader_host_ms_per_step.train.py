"""Median host time a step of the loader's work on the training thread:
the batch's ``np.stack`` (``loader.stack``) and its pin and copy enqueue
(``loader.pin``), ms."""

import statistics

from bench_port.spans import paired_ms


def read(run):
    steps = paired_ms(run, "loader.stack", "loader.pin")
    return None if steps is None else statistics.median(steps)
