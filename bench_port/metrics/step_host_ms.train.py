"""Median host time a step of the trainer's augment and normalise
(``train.prep``) and its train step (``train.step``: forward, backward and
update enqueued, the launches included), ms."""

import statistics

from bench_port.spans import paired_ms


def read(run):
    steps = paired_ms(run, "train.prep", "train.step")
    return None if steps is None else statistics.median(steps)
