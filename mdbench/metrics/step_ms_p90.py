"""The 90th percentile over the window's thermo intervals of each
interval's wall ms per step (host clock, one interval = the deck's
thermo steps ending in one thermo row)."""
import numpy as np


def read(run):
    if len(run.step_ms) < 10:
        return None
    return float(np.percentile(run.step_ms, 90))
