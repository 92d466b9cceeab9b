"""Record the JAX package's reference rows of cristobalite_pppm.yaml for
the port.

The PyTorch port runs examples/decks/cristobalite_pppm.yaml (259,200
atoms) on a CUDA card, where there is no JAX; chip_smoke.py holds it to
this record of the JAX package, made on the CPU:

    python tools/record_cristobalite_step0.py [--replicate 2 2 2]

It writes tests/goldens/torch_cristobalite_pppm_step0.json with three
parts.

1. ``row``: the step-0 thermo row of the deck in its own f32.  The JAX
   package runs at a reduced replication of the same crystal (default
   2x2x2 copies of examples/data.cristobalite, 11,520 atoms), and the row
   is scaled to the deck's count: the structure is an ideal periodic
   crystal, so evdwl, ecoul, elong and ke are extensive and temp and
   press intensive; g_ewald is the same at every size (its accuracy
   equation depends on N only through N * V / qsqsum^2, which
   replication leaves unchanged).  The full deck's cell grid, PPPM mesh
   and self energy come from the JAX package's host set-up alone
   (make_grid, the run's mesh rule, setup_pppm; no force is computed at
   that size).
2. ``elong_recip``: the reciprocal part of elong (elong minus the self
   energy), which the ideal crystal's step-0 elong hides under a self
   energy 10^4 times larger.  It is taken in f64 at the reduced
   replication and scaled; ``elong_recip_per_atom`` holds it at three
   other replications (other meshes per cell) to show how far the
   scaling holds.
3. ``jittered``: a state whose forces are not zero by symmetry.  The
   deck, in f64 at 2x2x2, reads a copy of the data file whose
   coordinates gen_cristobalite.jitter displaced by up to 0.1 A, and runs
   10 steps: the thermo rows at steps 0 and 10, the step-0 forces and
   the step-10 unwrapped positions of every 360th atom, and the rms
   step-0 force.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
DECK = os.path.join(ROOT, "examples", "decks", "cristobalite_pppm.yaml")
OUT = os.path.join(ROOT, "tests", "goldens",
                   "torch_cristobalite_pppm_step0.json")
EXTENSIVE = ("evdwl", "ecoul", "elong", "epair", "ke", "etotal", "emol")
ROW_KEYS = ("temp", "evdwl", "ecoul", "elong", "epair", "etotal", "press")
JITTER = dict(amp=0.1, replicate=[2, 2, 2], steps=10, stride=360)
CHECK_REPLICATIONS = ([3, 2, 2], [2, 3, 2], [2, 2, 3])


def _run(cfg, **kw):
    from lammps_buck_intel_tpu.run import run_deck

    return run_deck(dict(cfg, run=0, thermo=1, **kw), log=False)


def _recip_per_atom(cfg, rep):
    sim, rows = _run(cfg, replicate=list(rep), precision="double")
    return ((float(rows[0]["elong"]) - float(sim.kspace.pm.elong_self))
            / int(sim.n_atoms))


def _jittered(cfg, dims):
    """The f64 jittered run of part 3."""
    import gen_cristobalite

    from lammps_buck_intel_tpu.run import build_simulation

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.cristobalite_jitter")
        gen_cristobalite.write(path, *dims, jitter_amp=JITTER["amp"])
        jcfg = dict(cfg, read_data=path, replicate=JITTER["replicate"],
                    precision="double")
        sim = build_simulation(jcfg)
    n = int(sim.n_atoms)
    pick = np.arange(0, n, JITTER["stride"])
    f0 = sim.get_atoms()["f"]
    rows = sim.run(JITTER["steps"], thermo_every=JITTER["steps"], log=False)
    at = sim.get_atoms()
    x = at["x"] + at["image"] * np.asarray(sim.box.lengths)
    pm = sim.kspace.pm
    return dict(
        JITTER, dims=list(dims), n_atoms=n, precision="double",
        pppm_grid=[int(v) for v in pm.grid], g_ewald=float(pm.g_ewald),
        rows=[{k: float(r[k]) for k in ROW_KEYS + ("step",)} for r in rows],
        atoms=[int(i) for i in pick],
        f0=np.asarray(f0[pick], np.float64).tolist(),
        f0_rms=float(np.sqrt(np.mean(np.sum(f0 * f0, axis=1)))),
        x_end=np.asarray(x[pick], np.float64).tolist())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicate", type=int, nargs=3, default=[2, 2, 2])
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from lammps_buck_intel_tpu.core import make_box
    from lammps_buck_intel_tpu.io import read_data
    from lammps_buck_intel_tpu.models.kspace import setup_pppm
    from lammps_buck_intel_tpu.models.kspace.base import (solve_g_ewald,
                                                          two_charge_force)
    from lammps_buck_intel_tpu.neighbor import cell_slots
    from lammps_buck_intel_tpu.run import _patch_aligned_smin

    with open(DECK) as f:
        cfg = yaml.safe_load(f)
    full_rep = list(cfg["replicate"])
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    t0 = time.perf_counter()
    sim, rows = _run(cfg, replicate=list(args.replicate))
    wall = time.perf_counter() - t0
    row = {k: float(v) for k, v in rows[0].items() if np.ndim(v) == 0}
    n = int(sim.n_atoms)
    d = read_data(cfg["read_data"])
    n_full = d.n_atoms * int(np.prod(full_rep))
    scale = n_full / n
    scaled = {k: (v * scale if k in EXTENSIVE else v) for k, v in row.items()}
    pm = sim.kspace.pm
    # the full deck's g_ewald from the same accuracy equation: it must
    # equal the reduced run's
    L_full = (d.box_hi - d.box_lo) * np.asarray(full_rep)
    q_full = np.tile(d.q, int(np.prod(full_rep)))
    ps, ks = cfg["pair_style"], cfg["kspace_style"]
    qqrd2e = sim.units.qqrd2e
    g_full = solve_g_ewald(
        ks["accuracy"] * two_charge_force(qqrd2e), ps["cut"], n_full,
        float(np.prod(L_full)), float((q_full * q_full).sum()) * qqrd2e)
    if abs(g_full - pm.g_ewald) > 1e-12 * g_full:
        raise SystemExit(f"g_ewald {g_full} at full size, {pm.g_ewald} here")
    # the full deck's cell grid (the reach-1 view the mesh aligns to) and
    # mesh, by the deck runner's rule
    skin = cfg["neighbor"]["skin"]
    nc = np.asarray(cell_slots.make_grid(n_full, L_full,
                                         ps["cut"] + skin).nc)
    smin = _patch_aligned_smin(nc, L_full, skin, ks["order"])
    pm_full = setup_pppm(
        make_box(d.box_lo, d.box_lo + L_full), q_full, cutoff=ps["cut"],
        accuracy_rel=ks["accuracy"], qqrd2e=qqrd2e, order=ks["order"],
        g_ewald=pm.g_ewald, multiple_of=tuple(int(v) for v in nc),
        grid_min=tuple(int(s * c) for s, c in zip(smin, nc)),
        acc_dtype=jnp.float32)
    # parts 2 and 3 in f64, after the deck's own f32 run
    jax.config.update("jax_enable_x64", True)
    recip = {"x".join(map(str, r)): _recip_per_atom(cfg, r)
             for r in [args.replicate, *CHECK_REPLICATIONS]}
    import gen_cristobalite

    dims = [int(round(v / gen_cristobalite.A_CELL))
            for v in d.box_hi - d.box_lo]
    rec = {
        "deck": "cristobalite_pppm.yaml",
        "n_atoms": n_full,
        "backend": "cpu",
        "precision": cfg.get("precision", "single"),
        "g_ewald": float(pm.g_ewald),
        "cell_grid": [int(v) for v in nc],
        "pppm_grid": [int(v) for v in pm_full.grid],
        "elong_self": float(pm_full.elong_self),
        "elong_recip": recip["x".join(map(str, args.replicate))] * n_full,
        "elong_recip_per_atom": recip,
        "recorded_at": {
            "replicate": list(args.replicate), "n_atoms": n,
            "pppm_grid": [int(v) for v in pm.grid], "order": int(pm.order),
            "cell_grid": [int(v) for v in sim.grid.nc],
            "row": row, "wall_s": round(wall, 2),
        },
        "scale": scale,
        "extensive": list(EXTENSIVE),
        "row": scaled,
        "jittered": _jittered(cfg, dims),
        "command": "python tools/record_cristobalite_step0.py --replicate "
                   + " ".join(str(v) for v in args.replicate),
    }
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: v for k, v in rec.items() if k != "jittered"},
                     indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
