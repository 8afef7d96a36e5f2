"""Median host time of a batcher step's pad and ``np.stack`` of its clips
(``batch.stack``), ms."""

from bench_port.spans import median_ms


def read(run):
    return median_ms(run, "batch.stack")
