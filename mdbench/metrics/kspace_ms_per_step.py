"""Device ms per step of the kspace layer's kernels (layers/kspace/), in
the traced slice; nothing when the slice ran none of them."""


def read(run):
    if run.trace is None or "kspace" not in run.trace["by_layer"]:
        return None
    return 1e3 * run.trace["by_layer"]["kspace"] / run.trace["steps"]
