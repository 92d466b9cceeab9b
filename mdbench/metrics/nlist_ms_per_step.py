"""Device ms per step of the neighbor-list builds (layers/nlist/), in the
traced slice; nothing when the slice built no list."""


def read(run):
    if run.trace is None or "nlist" not in run.trace["by_layer"]:
        return None
    return 1e3 * run.trace["by_layer"]["nlist"] / run.trace["steps"]
