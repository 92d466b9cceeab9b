#!/usr/bin/env python3
"""Record the JAX package's reference for the literal rhodo decks (SHAKE).

    python tools/record_rhodo_shake.py        (CPU, about three minutes)

Writes tests/goldens/torch_rhodo_shake.json, which chip_smoke.py holds the
PyTorch port to on the card.  Everything is computed by the JAX package on
the CPU on ONE copy of examples/data.rhodo_class (1,728 atoms, 864 C-H
constraints, 4 cells per axis), because full-size configurations are not
run on a shared CPU:

1. ``f64``: rhodo_nve.yaml (NVE + shake) and rhodo_class.yaml (NVT +
   shake) in double at replicate [1, 1, 1], 10 steps: the thermo rows at
   steps 0 and 10, the step-0 forces of every 4th atom and their rms, the
   unwrapped positions of those atoms at step 10, the constraint
   violation max |r^2/d^2 - 1| at step 10 and, for NVT, the chain.
2. ``single``: rhodo_nve.yaml in its own f32 at [1, 1, 1], 100 steps with
   thermo every 50: the rows and the drift max|etotal - e0| / N.
   ``single_nvt``: rhodo_class.yaml (rhodo_32k.yaml on one copy) the same
   way; the card's NVT temperatures at 31,104 atoms are held to these rows
   at ``nvt_temp_rtol``, fixed here before any run on the card, after the
   move from one copy's degrees of freedom to the full box's
   (``temp_scale``: the kinetic energy is extensive, 3N - 3 - Nc is not
   quite).
3. ``full``: the f32 step-0 row of one copy scaled to 3x3x2 (31,104 atoms)
   and 6x6x4 (248,832 atoms): the energies times the number of copies,
   press as it is, temp times ``temp_scale``; with the cell grid, PPPM
   mesh and g_ewald of the JAX package's host set-up at those sizes.
   ``cross_check_2x1x1`` records how well a real f32 run of two copies
   agrees with the scaled row.

Nc and the degrees of freedom 3N - 3 - Nc are recorded for each size.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
OUT = os.path.join(ROOT, "tests", "goldens", "torch_rhodo_shake.json")
F64_STEPS, STRIDE = 10, 4
FULL = ([3, 3, 2], [6, 6, 4])
# An f32 NVT trajectory of 100 steps on another machine, in another order
# of summation, of another box size: the thermostat feels the temperature
# of 3N - 3 - Nc degrees of freedom, which differs from one copy's by
# 6.6e-4, and feeds it back.  5e-3 (1.5 K at 300 K) is the flexible decks'
# rule (tools/record_rhodo_flex.py) and far below what a wrong chain or a
# chain fed pre-RATTLE velocities does.
NVT_TEMP_RTOL = 5e-3


def _dof(n_atoms: int, nc: int) -> int:
    return 3 * n_atoms - 3 - nc


def _f64(name):
    from record_rhodo_flex import _deck, _row

    from lammps_buck_intel_tpu.integrate.shake import max_violation
    from lammps_buck_intel_tpu.run import build_simulation

    sim = build_simulation(_deck(name, replicate=[1, 1, 1],
                                 precision="double"))
    pick = np.arange(0, int(sim.n_atoms), STRIDE)
    f0 = sim.get_atoms()["f"]
    rows = sim.run(F64_STEPS, thermo_every=F64_STEPS, log=False)
    at = sim.get_atoms()
    x = at["x"] + at["image"] * np.asarray(sim.box.lengths)
    pm = sim.kspace.pm
    nc = int(sim.shake.n_constraints)
    rec = dict(
        deck=name, n_atoms=int(sim.n_atoms), precision="double",
        steps=F64_STEPS, n_constraints=nc,
        dof=_dof(int(sim.n_atoms), nc),
        cell_grid=[int(v) for v in sim.grid.nc],
        pppm_grid=[int(v) for v in pm.grid], g_ewald=float(pm.g_ewald),
        rows=[_row(r) for r in rows], atoms=[int(i) for i in pick],
        f0=np.asarray(f0[pick], np.float64).tolist(),
        f0_rms=float(np.sqrt(np.mean(np.sum(f0 * f0, axis=1)))),
        x_end=np.asarray(x[pick], np.float64).tolist(),
        violation_end=float(max_violation(
            sim.shake, at["x"], np.asarray(sim.box.lengths))))
    therm = np.asarray(sim.state.therm, np.float64)
    if therm.size:
        rec["therm"] = therm.tolist()
    return rec


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from record_rhodo_flex import EXTENSIVE, ROW_KEYS, _deck, _host_setup, _row

    from lammps_buck_intel_tpu.io import read_data
    from lammps_buck_intel_tpu.run import run_deck

    # part 2 first: the decks' own f32, before x64 is switched on
    cfg = _deck("rhodo_nve.yaml", replicate=[1, 1, 1])
    t0 = time.perf_counter()
    sim, rows = run_deck(dict(cfg), log=False)
    wall = time.perf_counter() - t0
    n, nc = int(sim.n_atoms), int(sim.shake.n_constraints)
    e0 = float(rows[0]["etotal"])
    drift = max(abs(float(r["etotal"]) - e0) for r in rows) / n
    row = _row(rows[0])
    pm = sim.kspace.pm
    two = run_deck(dict(cfg, replicate=[2, 1, 1], run=0, thermo=1),
                   log=False)[1][0]
    single = dict(
        deck="rhodo_nve.yaml", n_atoms=n, n_constraints=nc,
        dof=_dof(n, nc), precision="single", steps=int(cfg["run"]),
        rows=[_row(r) for r in rows], drift_per_atom=drift,
        wall_s=round(wall, 2), cell_grid=[int(v) for v in sim.grid.nc],
        pppm_grid=[int(v) for v in pm.grid], g_ewald=float(pm.g_ewald))

    def scaled(copies):
        """The one-copy step-0 row at ``copies`` copies."""
        ts = copies * _dof(n, nc) / _dof(copies * n, copies * nc)
        return ts, {k: (v * copies if k in EXTENSIVE else
                        v * ts if k == "temp" else v)
                    for k, v in row.items()}

    scale = max(abs(row["epair"]), 1.0)
    want = scaled(2)[1]
    single["cross_check_2x1x1"] = {
        k: (abs(float(two[k]) - want[k]) / (2 * scale) if k in EXTENSIVE
            else abs(float(two[k]) - want[k]) / max(abs(want[k]), 1.0))
        for k in ROW_KEYS if k != "step"}

    nvt_cfg = _deck("rhodo_class.yaml")
    nvt_sim, nvt_rows = run_deck(dict(nvt_cfg), log=False)
    assert int(nvt_sim.n_atoms) == n
    single_nvt = dict(deck="rhodo_class.yaml", n_atoms=n, n_constraints=nc,
                      dof=_dof(n, nc), precision="single",
                      steps=int(nvt_cfg["run"]),
                      rows=[_row(r) for r in nvt_rows])

    d = read_data(cfg["read_data"])
    full = {}
    for rep in FULL:
        rec = _host_setup(d, rep, cfg, float(pm.g_ewald), sim.units.qqrd2e)
        copies = rec["copies"]
        rec["n_constraints"] = copies * nc
        rec["dof"] = _dof(rec["n_atoms"], copies * nc)
        rec["temp_scale"], rec["row"] = scaled(copies)
        full["x".join(map(str, rep))] = rec

    jax.config.update("jax_enable_x64", True)
    rec = {
        "backend": "cpu",
        "command": "python tools/record_rhodo_shake.py",
        "extensive": list(EXTENSIVE),
        "f64": {"nve": _f64("rhodo_nve.yaml"),
                "nvt": _f64("rhodo_class.yaml")},
        "single": single,
        "single_nvt": single_nvt,
        "nvt_temp_rtol": NVT_TEMP_RTOL,
        "nvt_temp_rtol_rule": "f32 NVT trajectories of 100 steps, one copy "
                              "against 18; the rule of "
                              "tools/record_rhodo_flex.py",
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
