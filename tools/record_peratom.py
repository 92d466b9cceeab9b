#!/usr/bin/env python3
"""Record the JAX package's per-atom energies and virials (compute pe/atom,
compute stress/atom and the four per-atom solver functions).

    python tools/record_peratom.py        (CPU, about a minute)

Writes tests/goldens/torch_peratom.json, which tests/test_torch_peratom.py
(CPU) and chip_smoke.py (on the card) hold the PyTorch port to.  Four
cases (examples/peratom_cases.py: jittered silica with PPPM and with
Ewald on the neighbor-list engine, rhodo_class.yaml on the cell engine,
one copy of rhodo_npt.yaml), each deck built by the JAX package's deck
runner on the CPU in f64 with ``run: 0``.

Per case: the thermo row; ``pe`` and ``stress``, the JAX ``pe_atom`` and
``stress_atom`` (which cast positions and charges to f32 for the pair and
k-space passes); and ``f64``, the per-atom functions on the same snapshot
in f64 (``compute_pair_peratom`` on a fresh list, ``compute_peratom`` /
``ewald_compute_peratom`` on the deck's solver, ``compute_bonded_peratom``
with its 1-4 channel).  Each array is kept as its column sums and 64
sampled atoms (``sample``, a seeded choice).  ``kspace_virial_miss``: the
JAX per-atom k-space virial's sums less the solver's global virial, of
the latter's largest component (printed too).
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

from peratom_cases import (CASES, JITTER, SEED, case_config,  # noqa: E402
                           sample_idx, write_jitter)


def _summary(a, idx) -> dict:
    a = np.asarray(a, np.float64)
    return dict(sum=a.sum(0).tolist(), sample=a[idx].tolist())


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
    from lammps_buck_intel_tpu.models.pair.driver import compute_pair_peratom
    from lammps_buck_intel_tpu.neighbor import neighbor_list as nlmod

    x, _v, typ, q, box, _m = jc._snapshot(sim)
    x = np.asarray(x, np.float64)
    q = np.asarray(q, np.float64)
    n = x.shape[0]
    si, sc = jc._specials(sim)
    spec = nlmod.make_spec(n, np.asarray(box.lengths, np.float64),
                           float(np.sqrt(sim.pair.cutsq_max)) * 1.0001)
    xj = jnp.asarray(x)
    nl, _ = nlmod.build_with_retry(
        xj, box, spec, None if si is None else jnp.asarray(si),
        None if sc is None else jnp.asarray(sc), None)
    pair = compute_pair_peratom(
        sim.pair, xj, jnp.asarray(typ), jnp.asarray(q), box, nl,
        acc_dtype=jnp.float64,
        use_special=si is not None and si.shape[1] > 0)
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


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = dict(seed=SEED, jitter=JITTER)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.cristobalite_jitter")
        write_jitter(path)
        for name in CASES:
            out[name] = record_case(name, path)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {os.path.relpath(OUT, ROOT)}")


if __name__ == "__main__":
    main()
