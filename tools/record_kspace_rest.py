#!/usr/bin/env python3
"""Record the JAX package's reference for the rest of the Coulomb k-space.

    python tools/record_kspace_rest.py        (CPU, a few minutes)

Writes tests/goldens/torch_kspace_rest.json, which
tests/test_torch_ewald_npt.py and tests/test_torch_pppm_ad.py (on the CPU)
and chip_smoke.py (on the card, which has no JAX) hold the PyTorch port
to.  Everything is computed by the JAX package's deck runner and engines
on the CPU in f64.

1. ``cases``: the six decks of pppm diff ad, kspace_modify slab and Ewald
   on the cell engine and under fix npt, each cut to one copy
   (``examples/kspace_rest_cases.py``: a jittered cristobalite block,
   cutoff 5 / skin 0.5, the Ewald decks at accuracy 1e-4, rhodo_npt_ad on
   one copy of its data file), run ``steps`` steps with a row every
   ``every``: the rows, the step-0 forces, final wrapped positions and
   image flags of every 40th atom, the engine and solver the runner built
   (mesh, g_ewald, number of k vectors), and ``drift`` = max |etotal -
   e0| / N over the run.
2. ``slab_full``: cristobalite_slab.yaml on one copy of its data file
   (examples/data.cristobalite_slab, 8,640 atoms, the deck's own cutoff
   and mesh rule), in f64, the deck's 100 steps with rows every 50: the
   step-0 row scaled to the deck's 6x5x1 copies (extensive entries times
   30, intensive as they are; the slab repeats along x and y only, and
   its slab term grows with the number of copies: M and V both scale by
   30, M^2 / V by 30), and the drift per atom of the run, the gate of the
   card's f32 run of the full deck.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
OUT = os.path.join(ROOT, "tests", "goldens", "torch_kspace_rest.json")
ROW_KEYS = ("temp", "evdwl", "ecoul", "elong", "emol", "epair", "ke",
            "etotal", "press")
EXTENSIVE = ("evdwl", "ecoul", "elong", "emol", "epair", "ke", "etotal")
STRIDE = 40
SLAB_COPIES = 30     # cristobalite_slab.yaml's replicate [6, 5, 1]


def _row(r):
    out = {k: float(r[k]) for k in ROW_KEYS}
    out["step"] = int(r["step"])
    if "vol" in r:
        out["vol"] = float(r["vol"])
    return out


def _solver(sim):
    ks = sim.kspace
    pm = getattr(ks, "pm", ks)
    out = dict(engine=type(sim).__name__, kspace=type(ks).__name__,
               g_ewald=float(pm.g_ewald))
    if hasattr(pm, "grid"):
        out.update(grid=[int(v) for v in pm.grid], diff=pm.diff,
                   slab=pm.slab)
    if hasattr(pm, "kvecs"):
        out.update(n_k=int(pm.kvecs.shape[0]))
    return out


def _atoms(sim):
    """f, x (wrapped) and image flags in atom order."""
    if hasattr(sim, "get_atoms"):
        return sim.get_atoms()
    st = sim.state      # the neighbor-list Simulation keeps atom order
    return {"f": st.f, "x": st.x, "image": st.image}


def _drift(rows, n):
    e0 = rows[0]["etotal"]
    return max(abs(r["etotal"] - e0) for r in rows) / n


def _case(name, tmp):
    import kspace_rest_cases as kc
    from lammps_buck_intel_tpu.run import build_simulation

    t0 = time.perf_counter()
    _, _, _, steps, every = kc.CASES[name]
    sim = build_simulation(kc.deck_cfg(name, tmp))
    n = int(sim.n_atoms)
    pick = np.arange(0, n, STRIDE)
    f0 = np.asarray(_atoms(sim)["f"], np.float64)
    rows = [_row(r) for r in sim.run(steps, thermo_every=every, log=False)]
    at = _atoms(sim)
    return dict(
        _solver(sim), case=name, deck=kc.CASES[name][0], n_atoms=n,
        steps=steps, every=every, rows=rows, atoms=[int(i) for i in pick],
        f0=f0[pick].tolist(),
        x_end=np.asarray(at["x"], np.float64)[pick].tolist(),
        image_end=np.asarray(at["image"])[pick].astype(int).tolist(),
        drift=_drift(rows, n), wall_s=round(time.perf_counter() - t0, 2))


def _slab_full():
    import kspace_rest_cases as kc
    from lammps_buck_intel_tpu.run import build_simulation

    t0 = time.perf_counter()
    cfg = kc.load_deck("cristobalite_slab.yaml")
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    cfg.update(replicate=[1, 1, 1], precision="double")
    sim = build_simulation(cfg)
    n = int(sim.n_atoms)
    rows = [_row(r) for r in sim.run(int(cfg["run"]),
                                     thermo_every=int(cfg["thermo"]),
                                     log=False)]
    row0 = {k: (v * SLAB_COPIES if k in EXTENSIVE else v)
            for k, v in rows[0].items()}
    return dict(_solver(sim), deck="cristobalite_slab.yaml",
                n_atoms=n * SLAB_COPIES, recorded_atoms=n,
                copies=SLAB_COPIES, extensive=list(EXTENSIVE), row=row0,
                rows=rows, drift=_drift(rows, n),
                wall_s=round(time.perf_counter() - t0, 2))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import kspace_rest_cases as kc

    cases = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in kc.CASES:
            cases[name] = _case(name, tmp)
            print(name, cases[name]["wall_s"], "s", flush=True)
    rec = {"cases": cases, "slab_full": _slab_full(), "stride": STRIDE,
           "jitter": kc.JITTER}
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = "unknown"
    rec.update(backend="cpu", command="python tools/record_kspace_rest.py",
               jax_package_commit=commit)
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    short = {k: {kk: vv for kk, vv in v.items()
                 if kk not in ("f0", "x_end", "image_end", "atoms")}
             for k, v in cases.items()}
    print(json.dumps(dict(short, slab_full=rec["slab_full"]), indent=1,
                     sort_keys=True))


if __name__ == "__main__":
    main()
