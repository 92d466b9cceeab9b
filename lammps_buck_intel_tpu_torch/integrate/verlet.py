"""Neighbor policy of the run loop.

Counterpart of ``NeighborPolicy`` in
``lammps_buck_intel_tpu.integrate.verlet``.  The neighbor-list engine
``Simulation`` is ROADMAP queue 1 item 11.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class NeighborPolicy:
    """``neighbor <skin> bin`` + ``neigh_modify`` knobs."""

    skin: float
    every: int = 1
    delay: int = 0
    check: bool = True
