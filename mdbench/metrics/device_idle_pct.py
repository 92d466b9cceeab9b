"""100 (1 - device busy / traced window) over the traced slice."""


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
