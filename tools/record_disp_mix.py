#!/usr/bin/env python3
"""Record the JAX package's reference for the pppm/disp channel decks.

    python tools/record_disp_mix.py        (CPU, a few minutes)

Writes tests/goldens/torch_disp_mix.json, which chip_smoke.py (on the
card) holds the PyTorch port to.  Everything is computed by the JAX
package's deck runner on the CPU in f64:

1. ``cristobalite``: examples/decks/cristobalite_buck_long.yaml
   (buck/long/coul/long + pppm/disp mix none: the Coulomb PPPM beside the
   two-channel no-mix dispersion mesh, summed by the JAX CombinedKSpace)
   at 2x2x2 copies of examples/data.cristobalite (11,520 atoms), the
   smallest replicate on which the JAX package builds its cell engine
   (3 cells or more per axis at the 11 A list cutoff; one copy is 2.6
   cells wide along x):
   - ``step0``: the deck's step-0 thermo row on the ideal crystal, the
     meshes, g_ewald, g_ewald_6, the channel count and the cell grid, and
     the same row at 3x2x2 copies (17,280 atoms, other meshes):
     ``scale_dev``, the relative deviation of each extensive field from
     the 2x2x2 row scaled by 3/2, says how far scaling the record to the
     full deck's 6x5x6 copies holds (ke by the 3N - 3 degrees of freedom,
     elong by the two meshes' accuracy);
   - ``traj`` and ``traj_nlist``: a copy of the data file that
     gen_cristobalite.jitter displaced by up to 0.1 A (forces not zero by
     symmetry), 20 steps with rows every 5, on the cell engine (the deck)
     and on the neighbor-list engine (cristobalite_buck_long_nlist.yaml);
   - ``deck``: the deck's own 100 steps at 2x2x2 (thermo 50): ``drift``,
     max |etotal - e0| / N of the f64 run.
2. ``hexane``: examples/decks/hexane_gen_arith.yaml (lj/long/coul/long
   coul off + pppm/disp mix arithmetic: seven channels, fix rigid/small,
   the cell engine with the generic dispersion solver on its slot
   positions) at its own 6,000 atoms: ``step0`` (row, mesh, g_ewald_6,
   channels, cells), ``traj`` (20 steps, rows every 5), ``deck`` (the
   deck's 200 steps, thermo 50, ``drift`` = max |etotal - e0| / |e0|).
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
OUT = os.path.join(ROOT, "tests", "goldens", "torch_disp_mix.json")
ROW_KEYS = ("temp", "evdwl", "ecoul", "elong", "emol", "epair", "ke",
            "etotal", "press")
EXTENSIVE = ("evdwl", "ecoul", "elong", "emol", "epair", "ke", "etotal")
CRIS, CRIS_NLIST, HEX = ("cristobalite_buck_long.yaml",
                         "cristobalite_buck_long_nlist.yaml",
                         "hexane_gen_arith.yaml")
REPLICATE, REPLICATE_ALT = [2, 2, 2], [3, 2, 2]
TRAJ = dict(amp=0.1, steps=20, every=5)


def _deck(name, **kw):
    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    cfg.update(precision="double", **kw)
    return cfg


def _row(r):
    return dict({k: float(r[k]) for k in ROW_KEYS}, step=int(r["step"]))


def _solvers(sim):
    ks = sim.kspace
    return list(getattr(ks, "solvers", [ks]))


def _meshes(sim):
    """(Coulomb mesh or None, g_ewald, dispersion mesh, order, g6, nch)."""
    coul, disp = None, None
    for s in _solvers(sim):
        if hasattr(s, "solver"):
            disp = s.solver
        else:
            coul = s
    return dict(mesh=None if coul is None else list(coul.grid),
                order=None if coul is None else int(coul.order),
                g_ewald=float(sim.pair.g_ewald),
                mesh_disp=list(disp.grid), order_disp=int(disp.order),
                g_ewald_6=float(disp.g_ewald_6), mix=str(disp.mix),
                nch=int(np.asarray(disp.A).shape[0]))


def _run(cfg, steps, every):
    from lammps_buck_intel_tpu.run import build_simulation

    t0 = time.perf_counter()
    sim = build_simulation(cfg)
    rows = sim.run(steps, thermo_every=every, log=False)
    info = dict(_meshes(sim), n_atoms=int(sim.n_atoms),
                engine=type(sim).__name__,
                wall_s=time.perf_counter() - t0)
    if hasattr(sim, "grid"):
        info.update(nc=list(sim.grid.nc), cap=int(sim.grid.cap))
    return sim, [_row(r) for r in rows], info


def _cristobalite():
    import gen_cristobalite

    _, rows, info = _run(_deck(CRIS, replicate=REPLICATE), 0, 1)
    step0 = dict(info, row=rows[0], replicate=REPLICATE)
    _, alt, alt_info = _run(_deck(CRIS, replicate=REPLICATE_ALT), 0, 1)
    ratio = np.prod(REPLICATE_ALT) / np.prod(REPLICATE)
    dev = {k: abs(alt[0][k] - ratio * rows[0][k])
           / max(abs(ratio * rows[0][k]), 1.0) for k in EXTENSIVE}
    step0.update(alt_row=alt[0], alt_replicate=REPLICATE_ALT,
                 alt_mesh=alt_info["mesh"],
                 alt_mesh_disp=alt_info["mesh_disp"], scale_dev=dev)
    out = dict(step0=step0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.cristobalite_jitter")
        gen_cristobalite.write(path, jitter_amp=TRAJ["amp"])
        for key, name in (("traj", CRIS), ("traj_nlist", CRIS_NLIST)):
            _, rows, info = _run(_deck(name, replicate=REPLICATE,
                                       read_data=path),
                                 TRAJ["steps"], TRAJ["every"])
            out[key] = dict(info, **TRAJ, rows=rows, replicate=REPLICATE)
    cfg = _deck(CRIS, replicate=REPLICATE)
    sim, rows, info = _run(cfg, int(cfg["run"]), int(cfg["thermo"]))
    e0 = rows[0]["etotal"]
    out["deck"] = dict(info, rows=rows, steps=int(cfg["run"]),
                       thermo_every=int(cfg["thermo"]),
                       drift=max(abs(r["etotal"] - e0) for r in rows)
                       / sim.n_atoms)
    return out


def _hexane():
    _, rows, info = _run(_deck(HEX), TRAJ["steps"], TRAJ["every"])
    out = dict(step0=dict(info, row=rows[0]),
               traj=dict(info, steps=TRAJ["steps"], every=TRAJ["every"],
                         rows=rows))
    cfg = _deck(HEX)
    _, rows, info = _run(cfg, int(cfg["run"]), int(cfg["thermo"]))
    e0 = rows[0]["etotal"]
    out["deck"] = dict(info, rows=rows, steps=int(cfg["run"]),
                       thermo_every=int(cfg["thermo"]),
                       drift=max(abs(r["etotal"] - e0) for r in rows)
                       / abs(e0))
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    rec = dict(cristobalite=_cristobalite(), hexane=_hexane())
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = "unknown"
    rec.update(backend="cpu", command="python tools/record_disp_mix.py",
               jax_package_commit=commit)
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(rec, indent=1, sort_keys=True)[:6000])


if __name__ == "__main__":
    main()
