"""Constraint clusters left above the deck's SHAKE tolerance per thermo
row: the program's ``shake.unconverged`` counter over its ``thermo_row``
counter (``lammps_buck_intel_tpu_torch.utils.trace``), over every row the
process ran (warm-up, window and traced slice).  None where the program
keeps no such counter."""
import sys


def read(run):
    trace = sys.modules.get("lammps_buck_intel_tpu_torch.utils.trace")
    if trace is None:
        return None
    c = trace.counters()
    if "shake.unconverged" not in c or not c.get("thermo_row"):
        return None
    return c["shake.unconverged"] / c["thermo_row"]
