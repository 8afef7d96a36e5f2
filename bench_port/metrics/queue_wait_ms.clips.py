"""Median wait of a request in the micro-batcher's queue, from its enqueue
to the take of its group (the program's ``batch.queue_wait`` spans), ms."""

from bench_port.spans import median_ms


def read(run):
    return median_ms(run, "batch.queue_wait")
