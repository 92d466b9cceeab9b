#!/usr/bin/env python3
"""Record the JAX package's reference for the hexane path.

    python tools/record_hexane.py        (CPU, a few minutes)

Writes tests/goldens/torch_disp.json, which chip_smoke.py (on the card)
holds the PyTorch port to.  Everything is computed by the JAX package's
deck runner on the CPU in f64, from examples/decks/hexane_gen.yaml
(in.hexane's lines on the generated liquid of examples/gen_hexane.py:
6,000 atoms, lj/long/coul/long with coul off, pppm/disp, fix
rigid/small, the cell engine with CellPPPMDisp):

1. ``step0``: the step-0 thermo row, elong split into the mesh sum
   (``elong_mesh``) and the k = 0 and self terms of the composition
   (``elong_const``, ``PPPMDisp.elong_const``), the dispersion mesh,
   g_ewald_6, the cell grid and the rigid bodies' removed degrees of
   freedom.
2. ``traj``: 50 steps with thermo every 10: the rows, and the wrapped
   positions and image flags of every 60th atom at step 50.
3. ``deck``: the deck's own run (200 steps, thermo 50): the rows and
   ``drift`` = max |etotal - e0| / |e0|, the energy drift of the JAX f64
   run from the unequilibrated lattice start.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DECK = os.path.join(ROOT, "examples", "decks", "hexane_gen.yaml")
OUT = os.path.join(ROOT, "tests", "goldens", "torch_disp.json")
ROW_KEYS = ("temp", "evdwl", "ecoul", "elong", "emol", "epair", "ke",
            "etotal", "press")
TRAJ = dict(steps=50, every=10, stride=60)


def _deck():
    with open(DECK) as f:
        cfg = yaml.safe_load(f)
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    cfg["precision"] = "double"
    return cfg


def _row(r):
    return dict({k: float(r[k]) for k in ROW_KEYS}, step=int(r["step"]))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from lammps_buck_intel_tpu.run import build_simulation

    t0 = time.perf_counter()
    sim = build_simulation(_deck())
    pmd = sim.kspace.pmd
    typ = np.asarray(jax.device_get(sim.get_atoms()["typ"]), np.int64)
    b = np.asarray(pmd.B, np.float64)[typ]
    econst = pmd.elong_const(float(b.sum()), float((b * b).sum()))
    rows = sim.run(TRAJ["steps"], thermo_every=TRAJ["every"], log=False)
    atoms = sim.get_atoms()
    sel = np.arange(0, sim.n_atoms, TRAJ["stride"])
    step0 = dict(
        row=_row(rows[0]), elong_const=float(econst),
        elong_mesh=float(rows[0]["elong"] - econst),
        n_atoms=int(sim.n_atoms), mesh=list(pmd.grid), order=int(pmd.order),
        g_ewald_6=float(pmd.g_ewald_6), nc=list(sim.grid.nc),
        cap=int(sim.grid.cap), n_constraints=int(sim.rigid.n_constraints))
    traj = dict(TRAJ, rows=[_row(r) for r in rows], atoms=sel.tolist(),
                x_end=np.asarray(atoms["x"])[sel].tolist(),
                image_end=np.asarray(atoms["image"])[sel].tolist(),
                wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cfg = _deck()
    sim = build_simulation(cfg)
    rows = sim.run(int(cfg["run"]), thermo_every=int(cfg["thermo"]),
                   log=False)
    e0 = rows[0]["etotal"]
    deck = dict(rows=[_row(r) for r in rows], steps=int(cfg["run"]),
                thermo_every=int(cfg["thermo"]),
                drift=max(abs(r["etotal"] - e0) for r in rows) / abs(e0),
                wall_s=time.perf_counter() - t0)
    rec = dict(step0=step0, traj=traj, deck=deck)
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = "unknown"
    rec.update(backend="cpu", command="python tools/record_hexane.py",
               jax_package_commit=commit)
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: ({kk: vv for kk, vv in v.items()
                           if kk not in ("x_end", "image_end", "atoms")}
                          if isinstance(v, dict) else v)
                      for k, v in rec.items()}, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
