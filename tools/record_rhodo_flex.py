#!/usr/bin/env python3
"""Record the JAX package's reference for the flexible rhodo-class decks.

    python tools/record_rhodo_flex.py        (CPU, about three minutes)

Writes tests/goldens/torch_rhodo_flex.json, which chip_smoke.py holds the
PyTorch port to on the card.  Everything is computed by the JAX package on
the CPU on ONE copy of examples/data.rhodo_class (1,728 atoms, 4 cells per
axis), because full-size configurations are not run on a shared CPU:

1. ``f64``: rhodo_flex_nve.yaml and rhodo_flex_nvt.yaml in double at
   replicate [1, 1, 1], 10 steps: the thermo rows at steps 0 and 10, the
   step-0 forces of every 4th atom and their rms, the unwrapped positions
   of those atoms at step 10 and, for NVT, the thermostat chain.
2. ``single``: rhodo_flex_nve.yaml in its own f32 at [1, 1, 1], 100 steps
   with thermo every 50: the rows, and the NVE drift max|etotal - e0| / N.
   ``drift_gate`` is three times that drift and no looser than 1e-2
   kcal/mol per atom; it is fixed here, before any run on the card.
   ``single_nvt``: rhodo_flex_nvt.yaml the same way; the card's NVT
   temperatures at 31,104 atoms are held to these rows (temperature is
   intensive and the replicated box repeats the one-copy trajectory) at
   ``nvt_temp_rtol``, also fixed here.
3. ``full``: the step-0 row scaled to the decks' 3x3x2 (31,104 atoms) and
   to 6x6x4 (248,832 atoms).  A replicated box with replicated velocities
   is exactly periodic, so each thermo field is extensive (times the number
   of copies) or intensive (temp, press); ``cross_check_2x1x1`` records how
   well a real f32 run of two copies agrees with the scaled row.  With them
   the cell grid, the PPPM mesh and g_ewald that the JAX package's host
   set-up gives at those sizes (no device work).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DECKS = os.path.join(ROOT, "examples", "decks")
OUT = os.path.join(ROOT, "tests", "goldens", "torch_rhodo_flex.json")
EXTENSIVE = ("evdwl", "ecoul", "elong", "epair", "ke", "etotal", "emol")
ROW_KEYS = ("step", "temp", "evdwl", "ecoul", "elong", "emol", "epair", "ke",
            "etotal", "press")
F64_STEPS, STRIDE = 10, 4
FULL = ([3, 3, 2], [6, 6, 4])
DRIFT_CEILING = 1e-2     # kcal/mol per atom
# An f32 trajectory of 100 steps on another machine, in another order of
# summation: the step-0 temperature of two real copies already differs
# from one copy's by 2.9e-4 (cross_check_2x1x1), and the thermostat feeds
# that back; 5e-3 (1.5 K at 300 K) is far below what a wrong chain does
# (the 239 K start reaches ~344 K by step 100).
NVT_TEMP_RTOL = 5e-3


def _deck(name, **kw):
    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    cfg.update(kw)
    return cfg


def _row(r):
    return {k: float(r[k]) for k in ROW_KEYS}


def _f64(name):
    from lammps_buck_intel_tpu.run import build_simulation

    sim = build_simulation(_deck(name, replicate=[1, 1, 1],
                                 precision="double"))
    pick = np.arange(0, int(sim.n_atoms), STRIDE)
    f0 = sim.get_atoms()["f"]
    rows = sim.run(F64_STEPS, thermo_every=F64_STEPS, log=False)
    at = sim.get_atoms()
    x = at["x"] + at["image"] * np.asarray(sim.box.lengths)
    pm = sim.kspace.pm
    rec = dict(
        deck=name, n_atoms=int(sim.n_atoms), precision="double",
        steps=F64_STEPS, cell_grid=[int(v) for v in sim.grid.nc],
        pppm_grid=[int(v) for v in pm.grid], g_ewald=float(pm.g_ewald),
        rows=[_row(r) for r in rows], atoms=[int(i) for i in pick],
        f0=np.asarray(f0[pick], np.float64).tolist(),
        f0_rms=float(np.sqrt(np.mean(np.sum(f0 * f0, axis=1)))),
        x_end=np.asarray(x[pick], np.float64).tolist())
    therm = np.asarray(sim.state.therm, np.float64)
    if therm.size:
        rec["therm"] = therm.tolist()
    return rec


def _host_setup(d, rep, cfg, g_ewald, qqrd2e):
    """Cell grid and PPPM mesh of the JAX package at replicate ``rep``,
    from its host set-up alone."""
    import jax.numpy as jnp

    from lammps_buck_intel_tpu.core import make_box
    from lammps_buck_intel_tpu.models.kspace import setup_pppm
    from lammps_buck_intel_tpu.models.kspace.base import (solve_g_ewald,
                                                          two_charge_force)
    from lammps_buck_intel_tpu.neighbor import cell_slots
    from lammps_buck_intel_tpu.run import _patch_aligned_smin

    copies = int(np.prod(rep))
    n = d.n_atoms * copies
    L = (d.box_hi - d.box_lo) * np.asarray(rep)
    q = np.tile(d.q, copies)
    ps, ks = cfg["pair_style"], cfg["kspace_style"]
    g = solve_g_ewald(ks["accuracy"] * two_charge_force(qqrd2e),
                      ps["cut_coul"], n, float(np.prod(L)),
                      float((q * q).sum()) * qqrd2e)
    if abs(g - g_ewald) > 1e-12 * g:
        raise SystemExit(f"g_ewald {g} at {rep}, {g_ewald} on one copy")
    skin, order = cfg["neighbor"]["skin"], ks.get("order", 5)
    # the engine sizes its cells by the box's perpendicular widths, which
    # a rounding can leave a hair under the lengths (108 A / 12 A: 8 cells)
    box = make_box(d.box_lo, d.box_lo + L)
    widths = np.asarray(box.perp_widths)
    nc = np.asarray(cell_slots.make_grid(n, widths, ps["cut"] + skin).nc)
    smin = _patch_aligned_smin(nc, widths, skin, order)
    pm = setup_pppm(
        box, q, cutoff=ps["cut_coul"],
        accuracy_rel=ks["accuracy"], qqrd2e=qqrd2e, order=order,
        g_ewald=g_ewald, multiple_of=tuple(int(v) for v in nc),
        grid_min=tuple(int(s * c) for s, c in zip(smin, nc)),
        acc_dtype=jnp.float32)
    return dict(n_atoms=n, copies=copies, cell_grid=[int(v) for v in nc],
                pppm_grid=[int(v) for v in pm.grid], g_ewald=float(g),
                order=int(pm.order))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from lammps_buck_intel_tpu.io import read_data
    from lammps_buck_intel_tpu.run import run_deck

    # part 2 first: the deck's own f32, before x64 is switched on
    cfg = _deck("rhodo_flex_nve.yaml", replicate=[1, 1, 1])
    t0 = time.perf_counter()
    sim, rows = run_deck(dict(cfg), log=False)
    wall = time.perf_counter() - t0
    n = int(sim.n_atoms)
    e0 = float(rows[0]["etotal"])
    drift = max(abs(float(r["etotal"]) - e0) for r in rows) / n
    row = _row(rows[0])
    pm = sim.kspace.pm
    two = run_deck(dict(cfg, replicate=[2, 1, 1], run=0, thermo=1),
                   log=False)[1][0]
    scale = max(abs(row["epair"]), 1.0)
    cross = {k: (abs(float(two[k]) - 2 * row[k]) / (2 * scale)
                 if k in EXTENSIVE else
                 abs(float(two[k]) - row[k]) / max(abs(row[k]), 1.0))
             for k in ROW_KEYS if k != "step"}
    single = dict(
        deck="rhodo_flex_nve.yaml", n_atoms=n, precision="single",
        steps=int(cfg["run"]), rows=[_row(r) for r in rows],
        drift_per_atom=drift, wall_s=round(wall, 2),
        cell_grid=[int(v) for v in sim.grid.nc],
        pppm_grid=[int(v) for v in pm.grid], g_ewald=float(pm.g_ewald),
        cross_check_2x1x1=cross)

    nvt_cfg = _deck("rhodo_flex_nvt.yaml", replicate=[1, 1, 1])
    nvt_rows = run_deck(dict(nvt_cfg), log=False)[1]
    single_nvt = dict(deck="rhodo_flex_nvt.yaml", n_atoms=n,
                      precision="single", steps=int(nvt_cfg["run"]),
                      rows=[_row(r) for r in nvt_rows])

    d = read_data(cfg["read_data"])
    full = {}
    for rep in FULL:
        rec = _host_setup(d, rep, cfg, float(pm.g_ewald), sim.units.qqrd2e)
        rec["row"] = {k: (v * rec["copies"] if k in EXTENSIVE else v)
                      for k, v in row.items()}
        full["x".join(map(str, rep))] = rec

    jax.config.update("jax_enable_x64", True)
    rec = {
        "backend": "cpu",
        "command": "python tools/record_rhodo_flex.py",
        "extensive": list(EXTENSIVE),
        "f64": {"nve": _f64("rhodo_flex_nve.yaml"),
                "nvt": _f64("rhodo_flex_nvt.yaml")},
        "single": single,
        "single_nvt": single_nvt,
        "nvt_temp_rtol": NVT_TEMP_RTOL,
        "nvt_temp_rtol_rule": "f32 trajectories of 100 steps; the 2x1x1 "
                              "cross-check of the step-0 temperature is "
                              "2.9e-4",
        "drift_gate": min(3.0 * drift, DRIFT_CEILING),
        "drift_gate_rule": "min(3 * single.drift_per_atom, 1e-2) kcal/mol "
                           "per atom",
        "full": full,
    }
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    show = dict(rec, f64={k: {kk: vv for kk, vv in v.items()
                              if kk not in ("f0", "x_end", "atoms")}
                          for k, v in rec["f64"].items()})
    print(json.dumps(show, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
