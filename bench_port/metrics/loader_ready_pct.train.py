"""Share of the batches whose item loads were all done when the training
loop asked for them (the loader's ``loader.ready`` over ``loader.asked``
counters), %."""

from bench_port.spans import counters


def read(run):
    c = counters(run)
    if not c or not c.get("loader.asked"):
        return None
    return 100.0 * c.get("loader.ready", 0) / c["loader.asked"]
