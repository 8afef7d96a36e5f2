"""Share of the traced window with no kernel, copy or memset on the
device, %."""

from bench_port.readings import idle_pct


def read(run):
    return idle_pct(run)
