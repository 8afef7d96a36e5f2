"""Share of the batcher thread's time spent running groups
(``batch.step``) rather than waiting for one (``batch.collect``), %."""

from bench_port.spans import total_ms


def read(run):
    step, collect = total_ms(run, "batch.step"), total_ms(run, "batch.collect")
    return 100.0 * step / (step + collect) if step + collect > 0 else None
