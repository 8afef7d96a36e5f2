"""Clips a batcher step carried over the window (MicroBatcher.items_run
over batches_run; padded bucket rows not counted)."""


def read(run):
    batches = getattr(run, "batches", 0)
    return run.items / batches if batches else None
