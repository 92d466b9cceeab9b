#!/usr/bin/env python3
"""Record the JAX package's per-atom energies and virials (compute pe/atom,
compute stress/atom and the per-atom solver functions).

    python tools/record_peratom.py [peratom|disp]   (CPU; both by default)

``peratom`` (about a minute) writes tests/goldens/torch_peratom.json,
which tests/test_torch_peratom.py (CPU) and chip_smoke.py (on the card)
hold the PyTorch port to: four cases (examples/peratom_cases.py CASES:
jittered silica with PPPM and with Ewald on the neighbor-list engine,
rhodo_class.yaml on the cell engine, one copy of rhodo_npt.yaml).
``disp`` (about a minute) writes tests/goldens/torch_peratom_disp.json,
held by tests/test_torch_peratom_disp.py and chip_smoke.py: the three
dispersion cases (DISP_CASES: cristobalite_buck_long.yaml on the jittered
copy, hexane_gen.yaml and hexane_gen_arith.yaml on the 4x4x4 cut-out).
Each deck is built by the JAX package's deck runner on the CPU in f64
with ``run: 0``.

Per case: the thermo row; ``pe`` and ``stress``, the JAX ``pe_atom`` and
``stress_atom`` (which cast positions and charges to f32 for the pair and
k-space passes); and ``f64``, the per-atom functions on the same snapshot
in f64 (``compute_pair_peratom`` on a fresh list, ``compute_peratom`` /
``ewald_compute_peratom`` on the deck's solver, ``compute_bonded_peratom``
with its 1-4 channel).  Each array is kept as its column sums and 64
sampled atoms (``sample``, a seeded choice).  ``kspace_virial_miss``: the
JAX per-atom k-space virial's sums less the solver's global virial, of
the latter's largest component (printed too).  The dispersion cases add
``disp_e`` / ``disp_v``, the dispersion solver's per-atom function alone,
and take ``kspace_virial_miss`` per solver (``coul``, ``disp``).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
OUT = os.path.join(ROOT, "tests", "goldens", "torch_peratom.json")
OUT_DISP = os.path.join(ROOT, "tests", "goldens", "torch_peratom_disp.json")

from peratom_cases import (CASES, DISP_CASES, JITTER, SEED,  # noqa: E402
                           case_config, sample_idx, write_hexane_cut,
                           write_jitter)


def _summary(a, idx) -> dict:
    a = np.asarray(a, np.float64)
    return dict(sum=a.sum(0).tolist(), sample=a[idx].tolist())


def _pair_f64(sim, jc):
    """The snapshot in f64 (x, typ, q, box, x on the device) and the pair
    per-atom function on a fresh list of it (with the specials and the
    same-molecule exclusion of the engine)."""
    import jax.numpy as jnp

    from lammps_buck_intel_tpu.models.pair.driver import compute_pair_peratom
    from lammps_buck_intel_tpu.neighbor import neighbor_list as nlmod

    x, _v, typ, q, box, _m = jc._snapshot(sim)
    x = np.asarray(x, np.float64)
    q = np.asarray(q, np.float64)
    n = x.shape[0]
    si, sc = jc._specials(sim)
    mol = jc._excl_mol(sim)
    spec = nlmod.make_spec(n, np.asarray(box.lengths, np.float64),
                           float(np.sqrt(sim.pair.cutsq_max)) * 1.0001)
    xj = jnp.asarray(x)
    nl, _ = nlmod.build_with_retry(
        xj, box, spec, None if si is None else jnp.asarray(si),
        None if sc is None else jnp.asarray(sc),
        None if mol is None else jnp.asarray(mol))
    pair = compute_pair_peratom(
        sim.pair, xj, jnp.asarray(typ), jnp.asarray(q), box, nl,
        acc_dtype=jnp.float64,
        use_special=si is not None and si.shape[1] > 0)
    return x, typ, q, box, xj, pair


def _f64(sim, jc):
    """The per-atom functions on the snapshot in f64."""
    import jax.numpy as jnp

    from lammps_buck_intel_tpu.models.kspace import setup_pppm
    from lammps_buck_intel_tpu.models.kspace.ewald import (
        Ewald, _ewald_compute, ewald_compute_peratom)
    from lammps_buck_intel_tpu.models.kspace.pppm import (
        PPPM, _pppm_compute, compute_peratom)
    from lammps_buck_intel_tpu.models.kspace.pppm_cells import CellPPPM
    from lammps_buck_intel_tpu.models.kspace.pppm_npt import TracedPPPM

    x, typ, q, box, xj, pair = _pair_f64(sim, jc)
    s = sim.kspace
    qj = jnp.asarray(q)
    if isinstance(s, Ewald):
        ks = ewald_compute_peratom(s, xj, qj)
        glob = _ewald_compute(s, xj, qj, True, True)
    else:
        if isinstance(s, PPPM):
            pm = s
        elif isinstance(s, CellPPPM):
            pm = s.pm
        elif isinstance(s, TracedPPPM):
            pm0 = s.pm
            pm = setup_pppm(sim.current_box, q, cutoff=1.0,
                            accuracy_rel=1e-4, qqrd2e=pm0.qqrd2e,
                            grid=pm0.grid, g_ewald=pm0.g_ewald,
                            order=pm0.order, diff=pm0.diff, slab=pm0.slab,
                            acc_dtype=pm0.acc_dtype)
        else:
            raise TypeError(type(s).__name__)
        ks = compute_peratom(pm, xj, qj)
        glob = _pppm_compute(pm, xj, qj, True, True)
    # how far the per-atom virial's sums are from the solver's own global
    # virial, of its largest component (the half-spectrum convention of
    # the JAX compute_peratom at the Nyquist planes)
    vg = np.asarray(glob.virial, np.float64)
    miss = (np.asarray(ks[1], np.float64).sum(0) - vg) / np.abs(vg).max()
    bonded = jc._bonded_peratom(sim, x, box, jc._BONDED_KEYS)
    return pair, ks, bonded, miss


def record_case(name: str, jitter_path: str) -> dict:
    from lammps_buck_intel_tpu import computes as jc
    from lammps_buck_intel_tpu.run import build_simulation

    t0 = time.perf_counter()
    sim = build_simulation(case_config(name, jitter_path))
    row = sim.thermo()
    t1 = time.perf_counter()
    cache = {}
    pe = jc.pe_atom(sim, cache=cache)
    st = jc.stress_atom(sim, cache=cache)
    t2 = time.perf_counter()
    pair, ks, bonded, miss = _f64(sim, jc)
    t3 = time.perf_counter()
    n = int(sim.n_atoms)
    idx = sample_idx(n)
    box = sim.current_box if hasattr(sim, "current_box") else sim.box
    print(f"[{name}] {n} atoms: build + thermo {t1 - t0:.1f} s, computes "
          f"{t2 - t1:.1f} s, f64 functions {t3 - t2:.1f} s; the per-atom "
          f"k-space virial's sums less the global virial, of its largest: "
          + " ".join(f"{v:.3e}" for v in miss))
    f64 = dict(pair_e=_summary(pair[0], idx), pair_v=_summary(pair[1], idx),
               kspace_e=_summary(ks[0], idx), kspace_v=_summary(ks[1], idx),
               bonded_e=_summary(bonded[0], idx),
               bonded_v=_summary(bonded[1], idx),
               bonded_e14=_summary(bonded[2], idx),
               bonded_v14=_summary(bonded[3], idx))
    return dict(
        n_atoms=n, engine=type(sim).__name__, sample=idx.tolist(),
        volume=float(np.prod(np.asarray(box.lengths, np.float64))),
        row={k: float(row[k]) for k in ("epair", "emol", "elong", "press")},
        pe=_summary(pe, idx), stress=_summary(st, idx), f64=f64,
        kspace_virial_miss=miss.tolist())


def _disp_f64(sim, jc):
    """The dispersion cases' per-atom functions on the snapshot in f64: the
    pair pass, each k-space solver's per-atom function (the Coulomb PPPM
    in its half-spectrum convention, the dispersion solver as the JAX
    computes bind it but in f64) and their sums, and each solver's miss."""
    import jax.numpy as jnp

    from lammps_buck_intel_tpu.models.kspace.base import (BoundKSpace,
                                                          CombinedKSpace)
    from lammps_buck_intel_tpu.models.kspace.pppm import (
        PPPM, _pppm_compute, compute_peratom)
    from lammps_buck_intel_tpu.models.kspace.pppm_cells import CellPPPMDisp

    x, typ, q, box, xj, pair = _pair_f64(sim, jc)
    ks = sim.kspace
    solvers = ks.solvers if isinstance(ks, CombinedKSpace) else [ks]
    tj = jnp.asarray(typ)
    per, miss = {}, {}
    for s in solvers:
        if isinstance(s, PPPM):
            key, pa = "coul", compute_peratom(s, xj, jnp.asarray(q))
            glob = _pppm_compute(s, xj, jnp.asarray(q), True, True)
        elif isinstance(s, CellPPPMDisp):
            b = jnp.asarray(np.asarray(s.b_per_type, np.float64)[typ])
            key, pa = "disp", s.pmd.compute_peratom(xj, b_per_atom=b)
            glob = s.pmd.compute(xj, b)
        elif isinstance(s, BoundKSpace) and s.typed:
            key, pa = "disp", s.solver.compute_peratom(xj, typ=tj)
            glob = s.solver.compute_typed(xj, tj)
        elif isinstance(s, BoundKSpace):
            b = jnp.asarray(np.asarray(s.per_atom, np.float64))
            key, pa = "disp", s.solver.compute_peratom(xj, b_per_atom=b)
            glob = s.solver.compute(xj, b)
        else:
            raise TypeError(type(s).__name__)
        per[key] = pa
        vg = np.asarray(glob.virial, np.float64)
        miss[key] = ((np.asarray(pa[1], np.float64).sum(0) - vg)
                     / np.abs(vg).max())
    ks_e = sum(np.asarray(p[0], np.float64) for p in per.values())
    ks_v = sum(np.asarray(p[1], np.float64) for p in per.values())
    return pair, (ks_e, ks_v), per["disp"], miss


def record_disp_case(name: str, jitter_path: str, hexane_path: str) -> dict:
    from lammps_buck_intel_tpu import computes as jc
    from lammps_buck_intel_tpu.run import build_simulation

    t0 = time.perf_counter()
    sim = build_simulation(case_config(name, jitter_path, hexane_path))
    row = sim.thermo()
    t1 = time.perf_counter()
    cache = {}
    pe = jc.pe_atom(sim, cache=cache)
    st = jc.stress_atom(sim, cache=cache)
    t2 = time.perf_counter()
    pair, ks, disp, miss = _disp_f64(sim, jc)
    t3 = time.perf_counter()
    n = int(sim.n_atoms)
    idx = sample_idx(n)
    print(f"[{name}] {n} atoms, {type(sim).__name__} with "
          f"{type(sim.kspace).__name__}: build + thermo {t1 - t0:.1f} s, "
          f"computes {t2 - t1:.1f} s, f64 functions {t3 - t2:.1f} s; the "
          f"per-atom k-space virial's sums less the global virial, of its "
          f"largest: " + "; ".join(
              f"{k} " + " ".join(f"{v:.3e}" for v in m)
              for k, m in miss.items()))
    f64 = dict(pair_e=_summary(pair[0], idx), pair_v=_summary(pair[1], idx),
               kspace_e=_summary(ks[0], idx), kspace_v=_summary(ks[1], idx),
               disp_e=_summary(disp[0], idx), disp_v=_summary(disp[1], idx))
    return dict(
        n_atoms=n, engine=type(sim).__name__,
        kspace=type(sim.kspace).__name__, sample=idx.tolist(),
        volume=float(np.prod(np.asarray(sim.box.lengths, np.float64))),
        row={k: float(row[k]) for k in ("epair", "emol", "elong", "press")},
        pe=_summary(pe, idx), stress=_summary(st, idx), f64=f64,
        kspace_virial_miss={k: m.tolist() for k, m in miss.items()})


def main(argv=None):
    import jax

    which = (argv if argv is not None else sys.argv[1:]) or ["peratom",
                                                               "disp"]
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.cristobalite_jitter")
        write_jitter(path)
        if "peratom" in which:
            out = dict(seed=SEED, jitter=JITTER)
            for name in CASES:
                out[name] = record_case(name, path)
            with open(OUT, "w") as f:
                json.dump(out, f, indent=1)
            print(f"wrote {os.path.relpath(OUT, ROOT)}")
        if "disp" in which:
            hpath = os.path.join(tmp, "data.hexane_cut")
            write_hexane_cut(hpath)
            out = dict(seed=SEED, jitter=JITTER)
            for name in DISP_CASES:
                out[name] = record_disp_case(name, path, hpath)
            with open(OUT_DISP, "w") as f:
                json.dump(out, f, indent=1)
            print(f"wrote {os.path.relpath(OUT_DISP, ROOT)}")


if __name__ == "__main__":
    main()
