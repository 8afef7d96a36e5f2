"""Share of the window the training loop waited for the loader's next
batch on the device, %."""


def read(run):
    wait = getattr(run, "loader_wait_s", None)
    return None if wait is None else 100.0 * wait / run.window_s
