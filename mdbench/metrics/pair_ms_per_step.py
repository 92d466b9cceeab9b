"""Device ms per step of the pair layer's kernels (layers/pair/), in
the traced slice; nothing when the slice ran none of them."""


def read(run):
    if run.trace is None or "pair" not in run.trace["by_layer"]:
        return None
    return 1e3 * run.trace["by_layer"]["pair"] / run.trace["steps"]
