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
     python examples/gen_cristobalite.py --slab
     (4 x 5 x 18 cells -> 8,640 atoms in a box twice as tall; writes
     examples/data.cristobalite_slab, the input of cristobalite_slab.yaml)

``write(..., vacuum=v)`` makes a slab: the box's z length is (1 + v)
times the block's, and the block sits in its middle, a gap of v / 2 of
its height above and below it, so that no atom comes near the periodic z
boundary in a short run (``kspace_modify slab`` treats z as open).  A
block cut at cell faces is polar: its top layer is oxygen (each O missing
the Si above it), its bottom layer silicon (each Si missing the two O
below it), a dipole of -2,062 e A per 4 x 5 cells of face that the BKS
crystal answers by heating to ~9,000 K within 10 fs.  So every other O of
the top layer moves one block height down, under the bottom Si layer,
where it binds one of those Si: both faces then alike, the slab neutral
and without a net dipole (``slab_block``).

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


def slab_block(x, t, hi):
    """The non-polar slab of a block (``build``): every other O of the top
    layer (z within 1 A of the block's top) moved down by the block's
    height."""
    top = np.where((t == 1) & (x[:, 2] > hi[2] - 1.0))[0]
    x = x.copy()
    x[top[::2], 2] -= hi[2]
    return x


def jitter(n, amp):
    """(n, 3) displacements in [-amp, amp): the Weyl sequence k * golden
    ratio mod 1, k = 1 .. 3n, in IEEE double arithmetic alone, so every
    machine makes the same ones (no random stream)."""
    k = np.arange(1, 3 * n + 1, dtype=np.float64)
    return (amp * (2.0 * np.mod(k * _GOLDEN, 1.0) - 1.0)).reshape(n, 3)


def write(path, nx=4, ny=5, nz=3, jitter_amp=0.0, vacuum=0.0):
    x, t, q, hi = build(nx, ny, nz)
    n = len(x)
    what = "ideal"
    if vacuum:
        # the slab's faces stay where they are: the jitter wraps x and y
        # only
        x = slab_block(x, t, hi)
    if jitter_amp:
        x = x + jitter(n, jitter_amp)
        x = np.mod(x, hi) if not vacuum else np.concatenate(
            [np.mod(x[:, :2], hi[:2]), x[:, 2:]], axis=1)
        what = f"jittered (+-{jitter_amp} A)"
    if vacuum:
        x = x + np.array([0.0, 0.0, 0.5 * vacuum * hi[2]])
        hi = hi * np.array([1.0, 1.0, 1.0 + vacuum])
        what = f"{what} slab (vacuum {vacuum} of its height)"
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
    here = os.path.dirname(os.path.abspath(__file__))
    if sys.argv[1:] == ["--slab"]:
        out = os.path.join(here, "data.cristobalite_slab")
        print(f"wrote {write(out, 4, 5, 18, vacuum=1.0)} atoms to {out}")
    else:
        dims = [int(v) for v in sys.argv[1:4]] or [4, 5, 3]
        out = os.path.join(here, "data.cristobalite")
        print(f"wrote {write(out, *dims)} atoms to {out}")
