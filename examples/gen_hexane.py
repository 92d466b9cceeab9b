"""Generate examples/data.hexane_gen: united-atom hexane, a stand-in for
the reference's equilibrated_data.hexane (in.hexane's data file, which is
not in this repository).

System: 1,000 all-trans hexane chains of six united atoms (type 1 CH3,
15.035 g/mol, at the ends; type 2 CH2, 14.027 g/mol, inside), C-C 1.54 A
and C-C-C 114 deg, each a molecule of its own (atom_style full, no
bonds: fix rigid/small holds the chains rigid).  The chains lie along x
on a 10 x 10 x 10 lattice of spacing (8.4, 5.1, 5.1) A: an 84 x 51 x 51
A box at 0.655 g/cm^3, each axis at least three cells of the deck's cut
+ skin = 11.8 A.  Alternate x layers are shifted by half a lattice step
in y and z: along x a chain's 6.46 A ends leave 1.94 A to the next
chain on the same axis, so the next layer's chains sit between the axes
(ends ~3.9 A apart, the closest intermolecular pair ~3.6 A against sigma
3.97).  Each chain's zig-zag plane is rotated about x by a seeded
random angle, and the Velocities section holds seeded 298 K Gaussian
velocities (real units, A/fs) with zero total momentum.

Run: python examples/gen_hexane.py   (writes examples/data.hexane_gen)
"""
import os
import sys

import numpy as np

MASS = (15.035, 14.027)     # CH3, CH2
BOND = 1.54
ANGLE = 114.0
SPACING = (8.4, 5.1, 5.1)
KB = 0.0019872067           # kcal/mol/K (real units)
MVV2E = 48.88821291 ** 2    # g/mol A^2/fs^2 -> kcal/mol


def chain() -> np.ndarray:
    """(6, 3) all-trans united-atom hexane along x, centred, zig-zag in
    the xy plane."""
    half = np.radians(0.5 * (180.0 - ANGLE))
    ax, perp = BOND * np.cos(half), BOND * np.sin(half)
    k = np.arange(6)
    return np.stack([(k - 2.5) * ax,
                     np.where(k % 2 == 0, -0.5 * perp, 0.5 * perp),
                     np.zeros(6)], -1)


def build(nx=10, ny=10, nz=10, temp=298.0, seed=20261017):
    """(x (N, 3), typ (N,) 0-based, mol (N,) 0-based, v (N, 3), L (3,)).
    nx must be even: the staggered layers alternate along x."""
    if nx % 2:
        raise ValueError(f"nx = {nx}: the staggered x layers need an even "
                         "count to be periodic")
    rng = np.random.default_rng(seed)
    base = chain()
    typ_m = np.array([0, 1, 1, 1, 1, 0], np.int32)
    xs, types, mols = [], [], []
    m = 0
    for i in range(nx):
        lay = 0.25 + 0.5 * (i % 2)
        for j in range(ny):
            for k in range(nz):
                phi = rng.uniform(0.0, 2.0 * np.pi)
                c, s = np.cos(phi), np.sin(phi)
                R = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
                centre = np.array([(i + 0.5) * SPACING[0],
                                   (j + lay) * SPACING[1],
                                   (k + lay) * SPACING[2]])
                xs.append(base @ R.T + centre)
                types.append(typ_m)
                mols.append(np.full(6, m, np.int32))
                m += 1
    x = np.concatenate(xs)
    typ = np.concatenate(types)
    mol = np.concatenate(mols)
    mass = np.asarray(MASS)[typ]
    v = rng.normal(size=x.shape) * np.sqrt(KB * temp / (mass * MVV2E))[:, None]
    v -= (mass[:, None] * v).sum(0) / mass.sum()
    L = np.array([nx, ny, nz], float) * np.asarray(SPACING)
    return x, typ, mol, v, L


def write(path, nx=10, ny=10, nz=10):
    x, typ, mol, v, L = build(nx, ny, nz)
    n = len(x)
    lines = [f"united-atom hexane, {nx * ny * nz} rigid chains "
             "(examples/gen_hexane.py)", "",
             f"{n} atoms", "2 atom types", "",
             f"0.0 {L[0]:.4f} xlo xhi", f"0.0 {L[1]:.4f} ylo yhi",
             f"0.0 {L[2]:.4f} zlo zhi", "", "Masses", "",
             f"1 {MASS[0]}", f"2 {MASS[1]}", "", "Atoms # full", ""]
    for i in range(n):
        lines.append(f"{i + 1} {mol[i] + 1} {typ[i] + 1} 0.0 "
                     f"{x[i, 0]:.6f} {x[i, 1]:.6f} {x[i, 2]:.6f} 0 0 0")
    lines += ["", "Velocities", ""]
    for i in range(n):
        lines.append(f"{i + 1} {v[i, 0]:.8e} {v[i, 1]:.8e} {v[i, 2]:.8e}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return n


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        here, "data.hexane_gen")
    print(f"wrote {write(out)} atoms to {out}")
