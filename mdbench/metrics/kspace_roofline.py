"""100 x the least time the H100 could take for the PPPM solves of the
traced steps (``work.kspace``: deposit, FFTs, solve and gather on the
mesh the deck's accuracy needs) over the k-space layer's device time."""
from mdbench.work import kspace


def read(run):
    if run.trace is None or "kspace" not in run.trace["by_layer"]:
        return None
    bound = kspace.bound_s(run.deck, run.n_atoms) * run.trace["steps"]
    return 100.0 * bound / run.trace["by_layer"]["kspace"]
