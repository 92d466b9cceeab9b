"""Generate examples/data.cristobalite — ideal beta-cristobalite silica.

The silica decks of this repository (silica_pppm.yaml, buck_coul_long.yaml,
buck_coul_cut.yaml) read the reference's amorphous-silica data file, which
is distributed separately.  This generator builds a deterministic stand-in
with the same chemistry: an orthogonal block of ideal beta-cristobalite
(space group Fd-3m, cubic cell a = 7.16 A, 24 atoms per cell), whose
density (~2.2 g/cm^3) is that of amorphous silica.

- Si (type 1, q = +2.4, mass 28.0855) on the 8 diamond sites of each cell;
- O (type 2, q = -1.2, mass 15.9994) at the midpoint of each of the 16
  Si-Si bonds, so Si-O = a sqrt(3) / 8 ~ 1.55 A.

Types and charges follow the BKS reading of the decks' coefficients:
"1 1" (zero) = Si-Si, "1 2" = Si-O, "2 2" = O-O.  The block is neutral.
The file is LAMMPS ``atom_style charge`` with image flags and no
Velocities section (the decks seed velocities with ``velocity``).

Run: python examples/gen_cristobalite.py [nx ny nz]
     (default 4 5 3 -> 1,440 atoms; writes examples/data.cristobalite)

``write(..., jitter=amp)`` displaces every coordinate by a deterministic
amount in [-amp, amp) (``jitter``), so that a check can start from a
state whose forces are not zero by symmetry, identical on every machine.
"""
import os
import sys

import numpy as np

A_CELL = 7.16
_GOLDEN = (np.sqrt(5.0) - 1.0) / 2.0
MASS = (28.0855, 15.9994)
CHARGE = (2.4, -1.2)

_FCC = np.array([[0.0, 0.0, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5],
                 [0.5, 0.5, 0.0]])
# the four bond directions of a diamond A site (even number of minus signs)
_BONDS = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]) / 4.0


def unit_cell():
    """(24, 3) fractional positions and (24,) 0-based types of one cell."""
    si = np.concatenate([_FCC, _FCC + 0.25])
    o = (_FCC[:, None, :] + 0.5 * _BONDS[None, :, :]).reshape(-1, 3)
    frac = np.mod(np.concatenate([si, o]), 1.0)
    typ = np.concatenate([np.zeros(8, np.int32), np.ones(16, np.int32)])
    return frac, typ


def build(nx=4, ny=5, nz=3, a=A_CELL):
    """Positions (N, 3), 0-based types (N,), charges (N,) and box hi (3,)
    of an nx * ny * nz block of cells, cells x-fastest."""
    frac, typ = unit_cell()
    cells = np.array([[ix, iy, iz] for iz in range(nz) for iy in range(ny)
                      for ix in range(nx)], np.float64)
    x = ((cells[:, None, :] + frac[None, :, :]) * a).reshape(-1, 3)
    t = np.tile(typ, len(cells))
    q = np.asarray(CHARGE)[t]
    return x, t, q, np.array([nx, ny, nz], np.float64) * a


def jitter(n, amp):
    """(n, 3) displacements in [-amp, amp): the Weyl sequence k * golden
    ratio mod 1, k = 1 .. 3n, in IEEE double arithmetic alone, so every
    machine makes the same ones (no random stream)."""
    k = np.arange(1, 3 * n + 1, dtype=np.float64)
    return (amp * (2.0 * np.mod(k * _GOLDEN, 1.0) - 1.0)).reshape(n, 3)


def write(path, nx=4, ny=5, nz=3, jitter_amp=0.0):
    x, t, q, hi = build(nx, ny, nz)
    n = len(x)
    what = "ideal"
    if jitter_amp:
        x = np.mod(x + jitter(n, jitter_amp), hi)
        what = f"jittered (+-{jitter_amp} A)"
    with open(path, "w") as f:
        f.write(f"{what} beta-cristobalite SiO2, {nx}x{ny}x{nz} cells of "
                f"{A_CELL} A (examples/gen_cristobalite.py)\n\n")
        f.write(f"{n} atoms\n2 atom types\n\n")
        for ax, name in enumerate("xyz"):
            f.write(f"0.0 {hi[ax]:.6f} {name}lo {name}hi\n")
        f.write("\nMasses\n\n")
        for i, m in enumerate(MASS):
            f.write(f"{i + 1} {m}\n")
        f.write("\nAtoms # charge\n\n")
        for i in range(n):
            f.write(f"{i + 1} {t[i] + 1} {q[i]:.1f} {x[i, 0]:.6f} "
                    f"{x[i, 1]:.6f} {x[i, 2]:.6f} 0 0 0\n")
    return n


if __name__ == "__main__":
    dims = [int(v) for v in sys.argv[1:4]] or [4, 5, 3]
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "data.cristobalite")
    print(f"wrote {write(out, *dims)} atoms to {out}")
