"""Device ms per step of the rebin layer's kernels (layers/rebin/), in
the traced slice; nothing when the slice ran none of them."""


def read(run):
    if run.trace is None or "rebin" not in run.trace["by_layer"]:
        return None
    return 1e3 * run.trace["by_layer"]["rebin"] / run.trace["steps"]
