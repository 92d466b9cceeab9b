#!/usr/bin/env python3
"""Record the JAX package's reference for rhodo_npt.yaml (fix npt + shake).

    python tools/record_rhodo_npt.py        (CPU, a few minutes)

Writes tests/goldens/torch_rhodo_npt.json, which chip_smoke.py holds the
PyTorch port to on the card.  Everything is computed by the JAX package's
NPTSimulation on the CPU, on ONE copy of examples/data.rhodo_class (1,728
atoms, 864 C-H constraints, 4 cells per axis) and, for a cross-check, on
two copies: full-size configurations are not run on a shared CPU.

1. ``f64``: the deck in double at replicate [1, 1, 1], 20 steps with rows
   every 5 (four neighbor blocks): the rows with boxL and omega_dot, the
   step-0 forces of every 4th atom and their rms, the final wrapped
   positions and image flags of those atoms, the final box, strain rate
   and thermostat chain, the list sizing, mesh and g_ewald.
2. ``single`` / ``double``: the deck in its own f32 and in f64 at [1, 1, 1],
   100 steps with thermo every 50 (rows at 0, 50, 100); ``single_2x1x1``:
   the f32 deck on two copies (3,456 atoms), the same rows.
3. ``full``: the f32 rows of one copy scaled to 3x3x2 (31,104 atoms) and
   6x6x4 (248,832 atoms): extensive energies, ke and the volume times the
   number of copies, the box lengths per axis times the replication,
   press as it is, temp from the scaled ke and the larger box's 3N - 3 -
   Nc; with the generic PPPM mesh and g_ewald of the JAX package's host
   set-up at that box.  The one-copy runs of 2 follow their share of the
   3x3x2 box: the thermostat's degrees of freedom and the barostat's mass
   per copy (``_run``).  ``vs_long_rhodo_npt`` compares the scaled rows
   with the JAX package's own f32 run of the full deck (the TPU record).
4. ``row_tol``: the tolerances of the card's rows at steps 50 and 100
   (temp, press, vol, etotal), fixed here before any run on the card:
   SAFETY times the largest of three spreads at those steps: the JAX f32
   run against the JAX f64 run (rounding, grown by the dynamics), the
   scaled one-copy row against the real two-copy run (another box size),
   and, at step 100, the scaled row against the JAX package's own f32 run
   of the full deck on a TPU (long_rhodo_npt.json: other hardware's
   rounding over 18 copies).  temp and press in their units, vol
   relative, etotal per atom.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DECK = os.path.join(ROOT, "examples", "decks", "rhodo_npt.yaml")
OUT = os.path.join(ROOT, "tests", "goldens", "torch_rhodo_npt.json")
F64_STEPS, F64_EVERY, STRIDE = 20, 5, 4
FULL = ([3, 3, 2], [6, 6, 4])
ROW_KEYS = ("temp", "ke", "press", "vol", "evdwl", "ecoul", "elong", "emol",
            "epair", "etotal")
EXTENSIVE = ("ke", "vol", "evdwl", "ecoul", "elong", "emol", "epair",
             "etotal")
GATED = ("temp", "press", "vol", "etotal")
# the card runs the same dynamics in another order of summation on a box
# 18 times larger: its rows at 50 and 100 may stray from the one-copy
# reference by a few times what the measured spreads show
SAFETY = 4.0


def _deck(**kw):
    with open(DECK) as f:
        cfg = yaml.safe_load(f)
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    cfg.update(kw)
    return cfg


def _row(r):
    out = {k: float(r[k]) for k in ROW_KEYS}
    out["step"] = int(r["step"])
    out["boxL"] = [float(v) for v in np.asarray(r["boxL"])]
    out["omega_dot"] = [float(v) for v in np.asarray(r["omega_dot"])]
    return out


def _run(precision, rep, full=None):
    """The deck at replicate ``rep``, 100 steps, rows at 0, 50 and 100.
    With ``full`` = (N, dof) of a larger box made of copies of this one,
    the thermostat takes that box's degrees of freedom per copy and the
    barostat its mass per copy, W = (N + 1) kT p_damp^2, so that this run
    follows what each copy of the larger box does (the temperature of a
    row is then 2 ke / (dof kB) of the larger box, see ``_scaled``)."""
    import dataclasses

    from lammps_buck_intel_tpu.run import build_simulation

    cfg = _deck(precision=precision, replicate=rep)
    sim = build_simulation(cfg)
    if full is not None:
        share = int(sim.n_atoms) / full[0]
        sim.thermostat = dataclasses.replace(sim.thermostat,
                                             dof=full[1] * share)
        sim.n_atoms = (full[0] + 1) * share - 1
    rows = sim.run(int(cfg["run"]), thermo_every=int(cfg["thermo"]),
                   log=False)
    return sim, [_row(r) for r in rows]


def _dof(n_atoms: int, nc: int) -> int:
    return 3 * n_atoms - 3 - nc


def _f64():
    from lammps_buck_intel_tpu.run import build_simulation

    sim = build_simulation(_deck(replicate=[1, 1, 1], precision="double"))
    pick = np.arange(0, int(sim.n_atoms), STRIDE)
    f0 = np.asarray(sim.get_atoms()["f"], np.float64)
    rows = sim.run(F64_STEPS, thermo_every=F64_EVERY, log=False)
    at = sim.get_atoms()
    st = sim.state
    nc = int(sim.shake.n_constraints)
    return dict(
        deck="rhodo_npt.yaml", n_atoms=int(sim.n_atoms), precision="double",
        steps=F64_STEPS, every=F64_EVERY, n_constraints=nc,
        dof=_dof(int(sim.n_atoms), nc),
        spec=dict(kmax=int(sim.spec.kmax), nc=[int(v) for v in sim.spec.nc],
                  cell_cap=int(sim.spec.cell_cap)),
        pppm_grid=[int(v) for v in sim.kspace.grid],
        g_ewald=float(sim.kspace.g_ewald),
        rows=[_row(r) for r in rows], atoms=[int(i) for i in pick],
        f0=f0[pick].tolist(),
        f0_rms=float(np.sqrt(np.mean(np.sum(f0 * f0, axis=1)))),
        x_end=np.asarray(at["x"], np.float64)[pick].tolist(),
        image_end=np.asarray(at["image"])[pick].astype(int).tolist(),
        boxL_end=np.asarray(st.boxL, np.float64).tolist(),
        omega_dot_end=np.asarray(st.omega_dot, np.float64).tolist(),
        therm=np.asarray(st.therm, np.float64).tolist())


def _host_mesh(rep, g_ewald, qqrd2e):
    """The generic PPPM mesh and g_ewald of the JAX package's host set-up
    at replicate ``rep`` (what its NPT branch solves on)."""
    import jax.numpy as jnp

    from lammps_buck_intel_tpu.core import make_box
    from lammps_buck_intel_tpu.io import read_data
    from lammps_buck_intel_tpu.models.kspace import setup_pppm
    from lammps_buck_intel_tpu.models.kspace.base import (solve_g_ewald,
                                                          two_charge_force)

    cfg = _deck()
    d = read_data(cfg["read_data"])
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
    pm = setup_pppm(make_box(d.box_lo, d.box_lo + L), q,
                    cutoff=ps["cut_coul"], accuracy_rel=ks["accuracy"],
                    qqrd2e=qqrd2e, order=ks.get("order", 5), g_ewald=g,
                    acc_dtype=jnp.float32)
    return n, copies, [int(v) for v in pm.grid], float(g)


def _scaled(row, copies, dof, boltz, rep):
    """A row of one copy as the row of ``copies`` copies with ``dof``
    degrees of freedom: extensive entries times copies, the temperature
    from the scaled kinetic energy, press as it is."""
    out = {k: (v * copies if k in EXTENSIVE else v)
           for k, v in row.items() if k in ROW_KEYS}
    out["temp"] = 2.0 * out["ke"] / (dof * boltz)
    out["step"] = row["step"]
    out["boxL"] = [b * r for b, r in zip(row["boxL"], rep)]
    return out


def _spread(a, b, n_atoms):
    """|a - b| per gated key in the units of ``row_tol``."""
    return {"temp": abs(a["temp"] - b["temp"]),
            "press": abs(a["press"] - b["press"]),
            "vol": abs(a["vol"] - b["vol"]) / abs(b["vol"]),
            "etotal": abs(a["etotal"] - b["etotal"]) / n_atoms}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from lammps_buck_intel_tpu.core.units import get_units
    from lammps_buck_intel_tpu.io import read_data

    u = get_units(_deck()["units"])
    d = read_data(_deck()["read_data"])
    n1 = d.n_atoms
    nc1 = int(np.sum(np.isin(d.mass[d.type], [d.mass.min()])))
    big = {}
    for rep in FULL:
        copies = int(np.prod(rep))
        big[tuple(rep)] = (copies * n1, _dof(copies * n1, copies * nc1))
    n_full, dof_full = big[tuple(FULL[0])]
    # the deck's own f32 first, before x64 is switched on: one copy and
    # two copies, each following its share of the 3x3x2 box
    sim1, single = _run("single", [1, 1, 1], (n_full, dof_full))
    if int(sim1.shake.n_constraints) != nc1:
        raise SystemExit("constraint count differs from the H-atom count")
    g1 = float(sim1.kspace.g_ewald)
    sim2, two = _run("single", [2, 1, 1], (n_full, dof_full))
    n2, nc2 = int(sim2.n_atoms), int(sim2.shake.n_constraints)
    jax.config.update("jax_enable_x64", True)
    _, double = _run("double", [1, 1, 1], (n_full, dof_full))
    f64 = _f64()

    # the two spreads at steps 50 and 100, on rows of the 3x3x2 box
    def as_full(r, share):
        return _scaled(r, 18 // share, dof_full, u.boltz, (1, 1, 1))

    spreads = {"f32_vs_f64": {}, "one_vs_two": {}}
    for s, dd, t in zip(single, double, two, strict=True):
        if s["step"] == 0:
            continue
        spreads["f32_vs_f64"][s["step"]] = _spread(
            as_full(s, 1), as_full(dd, 1), n_full)
        spreads["one_vs_two"][s["step"]] = _spread(
            as_full(s, 1), as_full(t, 2), n_full)

    full = {}
    for rep in FULL:
        n, copies, grid, g = _host_mesh(rep, g1, u.qqrd2e)
        dof = big[tuple(rep)][1]
        full["x".join(map(str, rep))] = dict(
            n_atoms=n, copies=copies, n_constraints=copies * nc1, dof=dof,
            pppm_grid=grid, g_ewald=g,
            rows=[_scaled(r, copies, dof, u.boltz, rep) for r in single])
    # how the model compares with the JAX package's own f32 run of the
    # full 31,104-atom deck (on a TPU, tests/goldens/long_rhodo_npt.json)
    with open(os.path.join(ROOT, "tests", "goldens",
                           "long_rhodo_npt.json")) as f:
        tpu = {int(r["step"]): r for r in json.load(f)["rows"]}
    check = {}
    for r in full["3x3x2"]["rows"]:
        if r["step"] in tpu:
            t = tpu[r["step"]]
            check[r["step"]] = _spread(r, dict(t, vol=r["vol"]), n_full)
            check[r["step"]].pop("vol")
    # a third spread: the JAX package's f32 run of the full deck on other
    # hardware, at the one gated step its record holds
    spreads["long_rhodo_npt"] = {s: v for s, v in check.items() if s}
    row_tol = {k: SAFETY * max(sp[step][k] for sp in spreads.values()
                               for step in sp if k in sp[step])
               for k in GATED}
    rec = dict(
        deck="rhodo_npt.yaml",
        source="JAX package NPTSimulation on the CPU "
               "(tools/record_rhodo_npt.py)",
        f64=f64,
        single=dict(n_atoms=n1, n_constraints=nc1, dof=_dof(n1, nc1),
                    rows=single),
        double=dict(n_atoms=n1, rows=double),
        single_2x1x1=dict(n_atoms=n2, n_constraints=nc2, dof=_dof(n2, nc2),
                          rows=two),
        spreads=spreads, safety=SAFETY, row_tol=row_tol,
        vs_long_rhodo_npt=check,
        row_tol_rule="SAFETY x the larger measured spread at steps 50 and "
                     "100: temp in K, press in atm, vol relative, etotal "
                     "per atom",
        full=full)
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps({"row_tol": row_tol, "spreads": spreads,
                      "vs_long_rhodo_npt": check}, indent=1))
    for r in full["3x3x2"]["rows"]:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in r.items()})


if __name__ == "__main__":
    main()
