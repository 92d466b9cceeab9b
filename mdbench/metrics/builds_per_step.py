"""Rebins or neighbor-list builds per MD step: the program's
``neighbor_build`` counter over its ``step`` counter
(``lammps_buck_intel_tpu_torch.utils.trace``), over every step the process
ran (warm-up, window, traced slice and the check's step).  None where the
program keeps no such counters."""
import sys


def read(run):
    trace = sys.modules.get("lammps_buck_intel_tpu_torch.utils.trace")
    if trace is None:
        return None
    c = trace.counters()
    if not c.get("step"):
        return None
    return c["neighbor_build"] / c["step"]
