"""Velocity-Verlet NVE updates on slot planes (the FixNVEIntel analog).

Counterpart of the NVE half of ``lammps_buck_intel_tpu.integrate.nve`` as
the cell-pair engine uses it: ``v += dtfm * f`` and ``x += dtv * v``, with
``dtfm = dtf / mass[type]`` per slot and 0 on empty slots, which freezes
them.  The updates are in place; each is a multiply and an add rounded
separately, as in the JAX package.  The two-float compensated
integration exists only for f32-only hardware and is not ported.
"""
from __future__ import annotations


def half_kick(vs, fs, dtfm):
    """v += dtfm * f for each (v, f) plane pair, in place."""
    for v, f in zip(vs, fs):
        v.add_(dtfm * f)


def drift(xs, vs, dtv: float):
    """x += dtv * v for each (x, v) plane pair, in place."""
    for x, v in zip(xs, vs):
        x.add_(dtv * v)
