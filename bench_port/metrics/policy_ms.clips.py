"""Median host time of a request's verdict policy once its probabilities
are back: threshold, calibration, agent, the result dict (``serve.policy``),
ms."""

from bench_port.spans import median_ms


def read(run):
    return median_ms(run, "serve.policy")
