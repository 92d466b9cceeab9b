"""Device ms per step of the bonded_shake layer's kernels
(layers/bonded_shake/: the bonded terms K14 and the constraints K13), in
the traced slice; nothing when the slice ran none of them."""


def read(run):
    if run.trace is None or "bonded_shake" not in run.trace["by_layer"]:
        return None
    return 1e3 * run.trace["by_layer"]["bonded_shake"] / run.trace["steps"]
