"""Device operations (kernels, copies, fills) per MD step in the traced
slice."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["n_events"] / run.trace["steps"]
