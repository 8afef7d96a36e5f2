"""Host time of a flash call in its wrapper, the launch included: the mean
of the median ``ops.flash_fwd`` and the median ``ops.flash_bwd``, us. A
training step makes as many of each, so this is half a typical forward and
backward pair; one median over both kinds would fall between the slower
forwards and the faster backwards."""

from bench_port.spans import median_ms


def read(run):
    fwd, bwd = median_ms(run, "ops.flash_fwd"), median_ms(run, "ops.flash_bwd")
    return None if fwd is None or bwd is None else 1e3 * (fwd + bwd) / 2
