#!/usr/bin/env python3
"""Generate mdbench/configs/data.rhodo, the benchmark's stand-in for
in.rhodo's data file, with the PyTorch port.

    python tools/gen_rhodo.py [--device cuda|cpu]

in.rhodo's data.rhodo (32,000 atoms in a 55 x 77 x 72.7 A box, 0.104
atoms/A^3) is not shipped.  This starts from the molecules of
examples/data.rhodo_class (``examples/gen_rhodo_class.py``: 216
eight-atom CHARMM-class chains, 1,728 atoms in a 54 A box, 0.011
atoms/A^3) and:

1. gives every hydrogen the H-C-C angles a CHARMM topology has
   (``EXTRA_ANGLES_M``; without them H5 turns about the C1-C2 axis
   through the improper's cusp, H7 turns freely on C3, and at 1 fs
   single hydrogens heat until a run fails);
2. compresses the box to in.rhodo's density in ``COMPRESS`` steps, each
   moving the molecules' centres (not their shapes) with the box and
   then relaxing at 0.5 fs under a stiff chain with fresh 300 K
   velocities;
3. relaxes it under LAMMPS' torsion angle by examples/gen_rhodo_class.py's
   protocol: six anneal stages (0.25 fs, t_damp 5 fs, tchain 3, 400
   steps, fresh velocities) and a 2,000-step settle (0.5 fs, t_damp 10
   fs, tchain 3);
4. runs 2,000 steps of the deck's own dynamics (1 fs, t_damp 50 fs,
   tchain 1) and refuses to write a box that did not stay near 300 K.

Everything runs in f64 (``precision: double``) on the deck
examples/decks/rhodo_class.yaml.
"""
import argparse
import copy
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# in.rhodo's data.rhodo: 32,000 atoms in 55 x 77 x 72.726 A^3
DENSITY = 32000 / (55.0 * 77.0 * 72.726)
COMPRESS = 24
# the H-C-C angles a CHARMM topology adds to gen_rhodo_class.build's:
# C0-C1-H5, C1-C2-H6 and C2-C3-H7 (type 1, the H-C-C angle)
EXTRA_ANGLES_M = [(1, 0, 1, 5), (1, 1, 2, 6), (1, 2, 3, 7)]
TITLE = ("CHARMM-class rhodo box at in.rhodo's density, full H-C-C angles, "
         "relaxed under LAMMPS' torsion angle (tools/gen_rhodo.py)")


def with_full_angles(angles: np.ndarray, n_atoms: int) -> np.ndarray:
    """``angles`` (0-based [type, i, j, k]) with ``EXTRA_ANGLES_M`` added
    to each eight-atom molecule."""
    base = 8 * np.arange(n_atoms // 8)
    extra = [np.stack([np.full_like(base, t), base + a, base + b, base + c],
                      1) for t, a, b, c in EXTRA_ANGLES_M]
    return np.concatenate([np.asarray(angles)] + extra).astype(np.int32)


def scale_box(d, x, image, s: float):
    """``d`` (a ``DataFile`` with box lo 0) with its box and the molecules'
    centres scaled by ``s``: returns the new data file and the wrapped
    positions and images."""
    L = d.box_hi - d.box_lo
    u = x - d.box_lo + image * L
    nmol = int(d.molecule.max()) + 1
    cen = np.zeros((nmol, 3))
    np.add.at(cen, d.molecule, u)
    cen /= np.bincount(d.molecule, minlength=nmol)[:, None]
    u = u + (s - 1.0) * cen[d.molecule]
    L2 = L * s
    img = np.floor(u / L2).astype(np.int32)
    d2 = dataclasses.replace(d, box_lo=np.zeros(3), box_hi=L2)
    return d2, u - img * L2, img


def write_state(path: str, d, x, image, v):
    """A data file (atom style full, with image flags and Velocities) of
    the topology and box of ``d`` (a port ``DataFile``) at positions
    ``x``, images ``image`` and velocities ``v`` (atom order)."""
    topo = (("Bonds", d.bonds), ("Angles", d.angles),
            ("Dihedrals", d.dihedrals), ("Impropers", d.impropers))

    def r(v):
        return repr(float(v))

    with open(path, "w") as f:
        f.write(f"{TITLE}\n\n{d.n_atoms} atoms\n")
        for name, arr in topo:
            f.write(f"{len(arr)} {name.lower()}\n")
        f.write(f"{d.n_atom_types} atom types\n")
        for name, arr in topo:
            f.write(f"{int(arr[:, 0].max()) + 1} {name.lower()[:-1]} "
                    "types\n")
        f.write("\n")
        for a, ax in enumerate("xyz"):
            f.write(f"{r(d.box_lo[a])} {r(d.box_hi[a])} {ax}lo {ax}hi\n")
        f.write("\nMasses\n\n")
        for t, m in enumerate(d.mass):
            f.write(f"{t + 1} {r(m)}\n")
        f.write("\nAtoms # full\n\n")
        for a in range(d.n_atoms):
            f.write(f"{a + 1} {d.molecule[a] + 1} {d.type[a] + 1} "
                    f"{r(d.q[a])} {r(x[a, 0])} {r(x[a, 1])} {r(x[a, 2])} "
                    f"{image[a, 0]} {image[a, 1]} {image[a, 2]}\n")
        f.write("\nVelocities\n\n")
        for a in range(d.n_atoms):
            f.write(f"{a + 1} {r(v[a, 0])} {r(v[a, 1])} {r(v[a, 2])}\n")
        for name, arr in topo:
            f.write(f"\n{name}\n\n")
            for k, row in enumerate(arr):
                f.write(f"{k + 1} {row[0] + 1} "
                        + " ".join(str(int(i) + 1) for i in row[1:]) + "\n")


def generate(dst: str, device: str = "cuda", log: bool = False):
    import yaml

    from lammps_buck_intel_tpu_torch.io.data_reader import read_data
    from lammps_buck_intel_tpu_torch.run import build_simulation

    d = read_data(os.path.join(ROOT, "examples", "data.rhodo_class"))
    d = dataclasses.replace(d, angles=with_full_angles(d.angles, d.n_atoms))
    state = {"x": d.x, "image": d.image, "v": d.v}
    work = dst + ".building"
    with open(os.path.join(ROOT, "examples", "decks",
                           "rhodo_class.yaml")) as f:
        base = yaml.safe_load(f)
    base.update(read_data=work, precision="double")

    def stage(timestep, t_damp, tchain, steps, seed=None):
        write_state(work, d, state["x"], state["image"], state["v"])
        cfg = copy.deepcopy(base)
        cfg["timestep"] = timestep
        cfg["fixes"] = [{"name": "shake", "m": 1.0, "tol": 0.0001},
                        {"name": "nvt", "t_start": 300.0,
                         "t_damp": t_damp, "tchain": tchain}]
        if seed is not None:
            cfg["velocity"] = {"temp": 300.0, "seed": seed}
        sim = build_simulation(cfg, device=device)
        rows = sim.run(steps, thermo_every=steps // 2, log=log)
        a = sim.get_atoms()
        state.update(x=a["x"], image=a["image"], v=a["v"])
        temps = [float(r["temp"]) for r in rows]
        if not np.all(np.isfinite(temps)):
            raise RuntimeError(f"a stage went non-finite: {temps}")
        return temps

    n = d.n_atoms
    s = (n / DENSITY / np.prod(d.box_hi - d.box_lo)) ** (1.0 / 3.0)
    step = s ** (1.0 / COMPRESS)
    for k in range(COMPRESS):
        d, state["x"], state["image"] = scale_box(d, state["x"],
                                                  state["image"], step)
        t = stage(0.5, 10.0, 3, 300, seed=7301 + 17 * k)
        print(f"# compress {k + 1}/{COMPRESS}: box "
              f"{d.box_hi[0]:.3f} A, T {t[-1]:.1f} K", flush=True)
    for k in range(6):
        t = stage(0.25, 5.0, 3, 400, seed=4928459 + 101 * k)
        print(f"# anneal {k + 1}/6: T {t[-1]:.1f} K", flush=True)
    t = stage(0.5, 10.0, 3, 2000)
    print(f"# settle: T {t[-1]:.1f} K", flush=True)
    t = stage(1.0, 50.0, 1, 2000)
    print(f"# deck dynamics: T {min(t):.1f}-{max(t):.1f} K", flush=True)
    if not all(250.0 < x < 350.0 for x in t):
        raise RuntimeError(f"the deck's dynamics left 300 K: {t}; "
                           "nothing written")
    os.replace(work, dst)
    print(f"wrote {dst}: {n} atoms, box {d.box_hi[0]:.4f} A, "
          f"{n / np.prod(d.box_hi):.4f} atoms/A^3 (f64, {device})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "mdbench", "configs",
                                                  "data.rhodo"))
    ap.add_argument("--log", action="store_true")
    args = ap.parse_args(argv)
    generate(args.out, args.device, args.log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
