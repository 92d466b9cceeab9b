#!/usr/bin/env python3
"""Record the JAX package's reference for the neighbor-list engine.

    python tools/record_nlist.py        (CPU, a few minutes)

Writes tests/goldens/torch_nlist.json, which chip_smoke.py holds the
PyTorch port's ``Simulation`` to on the card.  Everything is computed by
the JAX package's ``Simulation`` (its default engine) on the CPU in f64;
full-size configurations are not run on a shared CPU.

1. ``cristobalite``: cristobalite_pppm_nlist.yaml (buck/coul/long 10 A +
   PPPM 1e-4 order 7 on the generic mesh, NVE) on 2x2x2 copies (11,520
   atoms, 5x6x3 cells: the binned build) of a copy of
   examples/data.cristobalite that gen_cristobalite.jitter displaced by up
   to 0.1 A, 10 steps: the rows at steps 0 and 10, the step-0 forces and
   the step-10 wrapped positions and image flags of every 360th atom.
2. ``rhodo``: rhodo_class.yaml (NVT + SHAKE + the CHARMM stack, PPPM
   order 5) with ``engine: nlist`` on one copy of examples/data.rhodo_class
   (1,728 atoms, 4x4x3 cells), 20 steps with rows every 5: the rows, the
   step-0 forces and the final wrapped positions and image flags of every
   4th atom, the final thermostat chain.
3. ``full``: the generic PPPM mesh, g_ewald and list sizing of the
   full-size decks (cristobalite_pppm_nlist.yaml at 259,200 atoms,
   rhodo_nve_nlist.yaml at 31,104 and at replicate [6, 6, 4], 248,832),
   from the JAX package's deck runner with its engine stubbed out: host
   set-up alone, no force at that size.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
DECKS = os.path.join(ROOT, "examples", "decks")
OUT = os.path.join(ROOT, "tests", "goldens", "torch_nlist.json")
ROW_KEYS = ("temp", "evdwl", "ecoul", "elong", "emol", "epair", "ke",
            "etotal", "press")
CRIS = dict(amp=0.1, replicate=[2, 2, 2], steps=10, every=10, stride=360)
RHODO = dict(replicate=[1, 1, 1], steps=20, every=5, stride=4)


def _deck(name, **kw):
    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(kw)
    return cfg


def _rows(rows):
    return [dict({k: float(r[k]) for k in ROW_KEYS}, step=int(r["step"]))
            for r in rows]


def _run(cfg, steps, every, stride):
    from lammps_buck_intel_tpu.run import build_simulation

    t0 = time.perf_counter()
    sim = build_simulation(cfg)
    n = int(sim.n_atoms)
    pick = np.arange(0, n, stride)
    f0 = np.asarray(sim.state.f, np.float64)
    rows = sim.run(steps, thermo_every=every, log=False)
    st = sim.state
    pm = sim.kspace
    return dict(
        n_atoms=n, precision="double", steps=steps, thermo_every=every,
        spec=dict(cutneigh=float(sim.spec.cutneigh),
                  kmax=int(sim.spec.kmax),
                  nc=None if sim.spec.nc is None else list(sim.spec.nc)),
        pppm_grid=[int(v) for v in pm.grid], g_ewald=float(pm.g_ewald),
        rows=_rows(rows), atoms=[int(i) for i in pick],
        f0=f0[pick].tolist(),
        x_end=np.asarray(st.x, np.float64)[pick].tolist(),
        image_end=np.asarray(st.image)[pick].astype(int).tolist(),
        therm_end=np.asarray(st.therm, np.float64).tolist(),
        wall_s=round(time.perf_counter() - t0, 2))


def _full(name, replicate=None):
    """Host set-up of a full-size deck through the JAX deck runner with
    its Simulation stubbed out."""
    import lammps_buck_intel_tpu.integrate as jint
    from lammps_buck_intel_tpu.neighbor import neighbor_list as jnl
    from lammps_buck_intel_tpu.run import build_simulation

    seen = {}

    class Stub:
        def __init__(self, system, style, **kw):
            seen.update(system=system, style=style, **kw)

    real = jint.Simulation
    jint.Simulation = Stub
    try:
        cfg = _deck(name, read_data=os.path.join(
            ROOT, _deck(name)["read_data"]))
        if replicate is not None:
            cfg["replicate"] = replicate
        build_simulation(cfg)
    finally:
        jint.Simulation = real
    system, style, pm = seen["system"], seen["style"], seen["kspace"]
    L = np.asarray(system.box.lengths, np.float64)
    cutneigh = float(np.sqrt(style.cutsq_max)) + seen["neighbor"].skin
    spec = jnl.make_spec(int(system.x.shape[0]), L, cutneigh)
    return dict(
        deck=name, replicate=cfg["replicate"],
        n_atoms=int(system.x.shape[0]),
        box=[float(v) for v in L], pppm_grid=[int(v) for v in pm.grid],
        order=int(pm.order), g_ewald=float(pm.g_ewald),
        elong_self=float(pm.elong_self),
        spec=dict(cutneigh=float(spec.cutneigh), kmax=int(spec.kmax),
                  nc=None if spec.nc is None else list(spec.nc),
                  cell_cap=int(spec.cell_cap)))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import gen_cristobalite

    full = {"cristobalite_pppm_nlist": _full("cristobalite_pppm_nlist.yaml"),
            "rhodo_nve_nlist": _full("rhodo_nve_nlist.yaml"),
            "rhodo_nve_nlist_6x6x4": _full("rhodo_nve_nlist.yaml",
                                           [6, 6, 4])}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.cristobalite_jitter")
        gen_cristobalite.write(path, jitter_amp=CRIS["amp"])
        cris = _run(_deck("cristobalite_pppm_nlist.yaml", read_data=path,
                          replicate=CRIS["replicate"], precision="double"),
                    CRIS["steps"], CRIS["every"], CRIS["stride"])
    cris.update(deck="cristobalite_pppm_nlist.yaml", amp=CRIS["amp"],
                replicate=CRIS["replicate"])
    rhodo = _run(_deck("rhodo_class.yaml", engine="nlist",
                       read_data=os.path.join(ROOT, "examples",
                                              "data.rhodo_class"),
                       replicate=RHODO["replicate"], precision="double"),
                 RHODO["steps"], RHODO["every"], RHODO["stride"])
    rhodo.update(deck="rhodo_class.yaml", engine="nlist",
                 replicate=RHODO["replicate"])
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = "unknown"
    rec = {"backend": "cpu", "command": "python tools/record_nlist.py",
           "jax_package_commit": commit, "cristobalite": cris,
           "rhodo": rhodo, "full": full}
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"full": full,
                      "cristobalite": {k: cris[k] for k in
                                       ("rows", "spec", "pppm_grid",
                                        "wall_s")},
                      "rhodo": {k: rhodo[k] for k in
                                ("rows", "spec", "pppm_grid", "wall_s")}},
                     indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
