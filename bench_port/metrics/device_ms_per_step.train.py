"""Device busy time a step in the traced window, ms (a batcher step when
serving, an optimizer step when training)."""

from bench_port.readings import device_ms_per_step


def read(run):
    return device_ms_per_step(run)
