"""Lattice / create_atoms — deck geometry generation (host numpy).

Counterpart of ``lammps_buck_intel_tpu.io.lattice`` (``lattice_constant``
and ``create_atoms``); ``replicate`` serves read_data decks and is not
ported yet.  Geometry generation never runs on the device.
"""
from __future__ import annotations

import numpy as np

# Basis sites in lattice-cell fractional coordinates.
_BASES = {
    "sc": np.array([[0.0, 0.0, 0.0]]),
    "bcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    "fcc": np.array(
        [[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]
    ),
}


def lattice_constant(style: str, reduced_density: float) -> float:
    """LAMMPS ``lattice <style> <rho>`` in lj units: a = (nbasis/rho)^(1/3)."""
    nbasis = len(_BASES[style])
    return (nbasis / reduced_density) ** (1.0 / 3.0)


def create_atoms(
    style: str,
    reduced_density: float,
    nx: int,
    ny: int,
    nz: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fill a block region of nx*ny*nz lattice cells with atoms.

    Reproduces ``lattice fcc rho; region box block 0 nx 0 ny 0 nz;
    create_atoms 1 box``: returns (positions, box_lo, box_hi) in
    simulation units, in the same atom order as the JAX package.
    """
    a = lattice_constant(style, reduced_density)
    basis = _BASES[style]
    ii, jj, kk = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    cells = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)  # (ncell, 3)
    pos = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a
    lo = np.zeros(3)
    hi = np.array([nx, ny, nz], dtype=float) * a
    return pos.astype(np.float64), lo, hi
