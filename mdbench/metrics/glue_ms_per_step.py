"""Device ms per step of the operations that match no layer's kernel
names (torch's own kernels, copies and fills), in the traced slice."""
from mdbench.harness.layers import GLUE


def read(run):
    if run.trace is None:
        return None
    return 1e3 * run.trace["by_layer"].get(GLUE, 0.0) / run.trace["steps"]
