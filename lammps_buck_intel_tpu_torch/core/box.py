"""Orthogonal periodic simulation box (host numpy).

Counterpart of ``lammps_buck_intel_tpu.core.box`` for orthogonal boxes.
The box stays on the host: its constants are passed to the kernels as
scalars.  Triclinic (tilted) boxes are ROADMAP queue 1 item 14.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Box(NamedTuple):
    """lo, hi: (3,) box bounds; periodic: (3,) bool; tilt: always None."""

    lo: np.ndarray
    hi: np.ndarray
    periodic: np.ndarray
    tilt: np.ndarray = None

    @property
    def lengths(self) -> np.ndarray:
        return self.hi - self.lo

    @property
    def volume(self) -> float:
        L = self.lengths
        return float(L[0] * L[1] * L[2])

    @property
    def is_triclinic(self) -> bool:
        return False

    @property
    def h_matrix(self) -> np.ndarray:
        """(3,3) cell matrix: x = lo + h @ lamda."""
        lx, ly, lz = (float(v) for v in self.lengths)
        return np.array([[lx, 0.0, 0.0], [0.0, ly, 0.0], [0.0, 0.0, lz]])

    @property
    def perp_widths(self) -> np.ndarray:
        """(3,) distances between opposite faces, by the same formula as
        the JAX package so both size their cell grids identically."""
        h = self.h_matrix
        a, b, c = h[:, 0], h[:, 1], h[:, 2]
        V = abs(float(np.linalg.det(h)))
        return np.array([
            V / np.linalg.norm(np.cross(b, c)),
            V / np.linalg.norm(np.cross(c, a)),
            V / np.linalg.norm(np.cross(a, b)),
        ])


def make_box(lo, hi, periodic=(True, True, True), dtype=None,
             tilt=None) -> Box:
    if tilt is not None and np.any(np.asarray(tilt, np.float64) != 0.0):
        raise NotImplementedError(
            "triclinic boxes are not ported: ROADMAP queue 1 item 14")
    dt = np.float64 if dtype is None else np.dtype(dtype)
    return Box(
        lo=np.asarray(lo, dtype=dt),
        hi=np.asarray(hi, dtype=dt),
        periodic=np.asarray(periodic, dtype=bool),
    )
