"""100 x the least time the H100 could take for the pair forces of the
traced steps (``work.pair``: pairs inside the cutoff counted once from
the atoms' positions, in the traced box) over the pair layer's device
time."""
from mdbench.work import pair


def read(run):
    if run.trace is None or "pair" not in run.trace["by_layer"]:
        return None
    bound = pair.bound_s(run.deck, run.positions, run.box) \
        * run.trace["steps"]
    return 100.0 * bound / run.trace["by_layer"]["pair"]
