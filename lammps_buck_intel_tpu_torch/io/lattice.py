"""Lattice / create_atoms — deck geometry generation (host numpy).

Counterpart of ``lammps_buck_intel_tpu.io.lattice`` (``lattice_constant``,
``create_atoms`` and ``replicate`` for per-atom arrays).  Geometry
generation never runs on the device.
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


def replicate(x: np.ndarray, lo: np.ndarray, hi: np.ndarray,
              nrep: tuple[int, int, int], per_atom: dict | None = None,
              bonds=None, angles=None, dihedrals=None, impropers=None,
              molecule=None, tilt=None):
    """LAMMPS ``replicate nx ny nz``: tile the box, remapping topology.

    per_atom: dict of (N, ...) arrays tiled along atoms (type, q, v,
    image).  Positions are unwrapped by their image flags before tiling
    and the returned images are zero, as the JAX package does: a molecule
    that straddles a boundary of the original box is bonded only through
    it.  Bonded index lists are offset per replica, and molecule ids so
    that replicas stay distinct molecules.  Returns (x, lo, hi, per_atom,
    bonds, angles, dihedrals, impropers, molecule).  Tilted boxes raise
    (ROADMAP queue 1 item 14).
    """
    if tilt is not None and np.any(tilt):
        raise NotImplementedError(
            "replicate with tilt is not ported: ROADMAP queue 1 item 14 "
            "(triclinic)")
    nx, ny, nz = nrep
    n = x.shape[0]
    L = hi - lo
    hmat = np.diag(np.asarray(L, np.float64))
    per_atom = dict(per_atom) if per_atom else {}
    img = per_atom.get("image")
    if img is not None:
        x = x + np.asarray(img, np.float64) @ hmat
        per_atom["image"] = np.zeros_like(np.asarray(img))
    shifts = np.asarray([[ix, iy, iz] for iz in range(nz) for iy in range(ny)
                         for ix in range(nx)], np.float64) @ hmat
    nrep_total = len(shifts)
    x_new = (x[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    hi_new = lo + L * np.array([nx, ny, nz])
    tiled = {k: np.concatenate([v] * nrep_total, axis=0)
             for k, v in per_atom.items()}

    def rep_topo(t):
        if t is None or len(t) == 0:
            return t
        t = np.asarray(t)
        offset = np.zeros_like(t[0])
        offset[1:] = n
        return np.concatenate([t + r * offset for r in range(nrep_total)])

    if molecule is not None and len(molecule):
        nmol = int(molecule.max()) + 1
        molecule = np.concatenate(
            [molecule + r * nmol for r in range(nrep_total)])
    return (x_new, lo, hi_new, tiled, rep_topo(bonds), rep_topo(angles),
            rep_topo(dihedrals), rep_topo(impropers), molecule)
