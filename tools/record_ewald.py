#!/usr/bin/env python3
"""Record the JAX package's reference for the Ewald and coul/cut decks.

    python tools/record_ewald.py        (CPU, a few minutes)

Writes tests/goldens/torch_ewald.json, which tests/test_torch_ewald.py
(on the CPU) and chip_smoke.py (on the card) hold the PyTorch port to.
Everything is computed by the JAX package's deck runner and its
``Simulation`` (its default engine) on the CPU in f64.

1. ``ewald_step0``: cristobalite_ewald.yaml at its full size (2x2x2 copies
   of examples/data.cristobalite, 11,520 atoms, K = 31,248 k vectors):
   the step-0 thermo row, the k set's size, kmax and g_ewald, elong split
   into the self and background terms (``elong_self``) and the reciprocal
   part (``elong_recip``), and the list sizing.  The JAX ``_ewald_compute``
   holds (N, K) f64 arrays of 2.9 GB each at this size; here it runs the
   same expressions over chunks of 960 atoms (``jax.lax.map``: S(k) summed
   over the chunks, then ``sk_force_energy_virial`` per chunk), which
   changes nothing but the order of the sum over atoms.
2. ``coul_cut_step0``: cristobalite_coul_cut.yaml's step-0 row, recorded at
   2x2x2 copies (11,520 atoms) and scaled to the deck's 4x4x4 (92,160
   atoms): the crystal is ideal and periodic, so evdwl, ecoul, epair, ke
   and etotal are extensive and temp and press intensive (the 10 A
   Coulomb cutoff is under half of every box length at both sizes).  The
   full deck's list sizing comes from the host set-up alone.  The same
   2x2x2 copy then runs the deck's 100 steps (thermo 20): ``drift`` is
   max |etotal - e0| / N of that f64 run, the energy drift that the
   truncated Coulomb sum (no k-space, no shift) leaves by itself.
3. ``ewald_traj`` and ``coul_cut_traj``: a state whose forces are not zero
   by symmetry.  The deck reads a copy of the data file that
   gen_cristobalite.jitter displaced by up to 0.1 A: the Ewald deck at
   1x1x2 (2,880 atoms, K = 8,820), the coul/cut deck at one copy (1,440
   atoms; its 10.3 A list cutoff is under half of the 21.48 A axis), each
   20 steps with rows every 5: the rows, the step-0 forces and the final
   wrapped positions and image flags of every 40th atom.
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
OUT = os.path.join(ROOT, "tests", "goldens", "torch_ewald.json")
ROW_KEYS = ("temp", "evdwl", "ecoul", "elong", "emol", "epair", "ke",
            "etotal", "press")
EXTENSIVE = ("evdwl", "ecoul", "elong", "emol", "epair", "ke", "etotal")
EWALD_DECK = "cristobalite_ewald.yaml"
CUT_DECK = "cristobalite_coul_cut.yaml"
TRAJ = dict(amp=0.1, steps=20, every=5, stride=40)
CHUNK = 960


def _deck(name, **kw):
    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    cfg.update(precision="double", **kw)
    return cfg


def _row(r):
    return dict({k: float(r[k]) for k in ROW_KEYS}, step=int(r["step"]))


def _spec(sim):
    return dict(cutneigh=float(sim.spec.cutneigh), kmax=int(sim.spec.kmax),
                nc=None if sim.spec.nc is None else list(sim.spec.nc))


def _ewald_fields(ew):
    return dict(g_ewald=float(ew.g_ewald), kmax=[int(v) for v in ew.kmax],
                n_k=int(ew.kvecs.shape[0]), elong_self=float(ew.elong_self))


def _chunked_ewald_compute():
    """The JAX _ewald_compute's expressions over chunks of CHUNK atoms."""
    import jax
    import jax.numpy as jnp

    from lammps_buck_intel_tpu.models.kspace.base import KSpaceResult
    from lammps_buck_intel_tpu.models.kspace.ewald import \
        sk_force_energy_virial

    def compute(ew, x, q, eflag, vflag):
        n = x.shape[0]
        if n % CHUNK:
            raise ValueError(f"{n} atoms are not chunks of {CHUNK}")
        flt, acc = x.dtype, ew.acc_dtype
        kv = jnp.asarray(ew.kvecs, flt)
        xc, qc = x.reshape(n // CHUNK, CHUNK, 3), q.reshape(n // CHUNK, CHUNK)

        def trig(xx):
            phase = xx @ kv.T
            return jnp.cos(phase), jnp.sin(phase)

        def sk(args):
            xx, qq = args
            c, s = trig(xx)
            return (jnp.sum((qq[:, None] * c).astype(acc), axis=0),
                    jnp.sum((qq[:, None] * s).astype(acc), axis=0))

        re, im = jax.lax.map(sk, (xc, qc))
        s_re, s_im = re.sum(0), im.sum(0)

        def force(args):
            xx, qq = args
            c, s = trig(xx)
            return sk_force_energy_virial(ew, c, s, s_re, s_im, qq, False,
                                          False)[0]

        f = jax.lax.map(force, (xc, qc)).reshape(n, 3)
        one = jnp.zeros((1, kv.shape[0]), flt)
        _, elong, virial = sk_force_energy_virial(
            ew, one, one, s_re, s_im, jnp.zeros((1,), flt), eflag, vflag)
        return KSpaceResult(f=f, elong=elong, virial=virial)

    return compute


def _ewald_step0():
    from lammps_buck_intel_tpu.models.kspace import ewald as jewald
    from lammps_buck_intel_tpu.run import run_deck

    real = jewald._ewald_compute
    jewald._ewald_compute = _chunked_ewald_compute()
    try:
        t0 = time.perf_counter()
        sim, rows = run_deck(_deck(EWALD_DECK, run=0, thermo=1), log=False)
    finally:
        jewald._ewald_compute = real
    row = _row(rows[0])
    ew = sim.kspace
    return dict(_ewald_fields(ew), deck=EWALD_DECK, n_atoms=int(sim.n_atoms),
                replicate=_deck(EWALD_DECK)["replicate"], row=row,
                elong_recip=row["elong"] - float(ew.elong_self),
                spec=_spec(sim), chunk=CHUNK,
                wall_s=round(time.perf_counter() - t0, 2))


def _full_spec(name):
    """The full deck's list sizing through the JAX deck runner with its
    Simulation stubbed out (host set-up alone)."""
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
        build_simulation(_deck(name))
    finally:
        jint.Simulation = real
    system, style = seen["system"], seen["style"]
    n = int(system.x.shape[0])
    L = np.asarray(system.box.lengths, np.float64)
    cutneigh = float(np.sqrt(style.cutsq_max)) + seen["neighbor"].skin
    spec = jnl.make_spec(n, L, cutneigh)
    return n, dict(cutneigh=float(spec.cutneigh), kmax=int(spec.kmax),
                   nc=None if spec.nc is None else list(spec.nc),
                   cell_cap=int(spec.cell_cap))


def _coul_cut_step0():
    from lammps_buck_intel_tpu.run import build_simulation

    full = _deck(CUT_DECK)
    rep = [2, 2, 2]
    t0 = time.perf_counter()
    sim = build_simulation(_deck(CUT_DECK, replicate=rep))
    rows = sim.run(int(full["run"]), thermo_every=int(full["thermo"]),
                   log=False)
    n = int(sim.n_atoms)
    n_full, spec_full = _full_spec(CUT_DECK)
    scale = n_full / n
    row = _row(rows[0])
    e0 = rows[0]["etotal"]
    drift = max(abs(float(r["etotal"]) - float(e0)) for r in rows) / n
    return dict(
        deck=CUT_DECK, n_atoms=n_full, replicate=full["replicate"],
        scale=scale, extensive=list(EXTENSIVE),
        row={k: (v * scale if k in EXTENSIVE else v) for k, v in row.items()},
        spec=spec_full, drift=drift,
        recorded_at=dict(replicate=rep, n_atoms=n, spec=_spec(sim),
                         rows=[_row(r) for r in rows],
                         wall_s=round(time.perf_counter() - t0, 2)))


def _traj(name, replicate, data_path):
    from lammps_buck_intel_tpu.run import build_simulation

    t0 = time.perf_counter()
    sim = build_simulation(_deck(name, read_data=data_path,
                                 replicate=replicate))
    n = int(sim.n_atoms)
    pick = np.arange(0, n, TRAJ["stride"])
    f0 = np.asarray(sim.state.f, np.float64)
    rows = sim.run(TRAJ["steps"], thermo_every=TRAJ["every"], log=False)
    st = sim.state
    out = dict(
        deck=name, replicate=replicate, amp=TRAJ["amp"], n_atoms=n,
        precision="double", steps=TRAJ["steps"],
        thermo_every=TRAJ["every"], spec=_spec(sim),
        rows=[_row(r) for r in rows], atoms=[int(i) for i in pick],
        f0=f0[pick].tolist(),
        x_end=np.asarray(st.x, np.float64)[pick].tolist(),
        image_end=np.asarray(st.image)[pick].astype(int).tolist(),
        wall_s=round(time.perf_counter() - t0, 2))
    if sim.kspace is not None:
        out.update(_ewald_fields(sim.kspace))
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import gen_cristobalite

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.cristobalite_jitter")
        gen_cristobalite.write(path, jitter_amp=TRAJ["amp"])
        ewald_traj = _traj(EWALD_DECK, [1, 1, 2], path)
        cut_traj = _traj(CUT_DECK, [1, 1, 1], path)
    rec = {"ewald_step0": _ewald_step0(), "coul_cut_step0": _coul_cut_step0(),
           "ewald_traj": ewald_traj, "coul_cut_traj": cut_traj}
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = "unknown"
    rec.update(backend="cpu", command="python tools/record_ewald.py",
               jax_package_commit=commit)
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: ({kk: vv for kk, vv in v.items()
                           if kk not in ("f0", "x_end", "image_end", "atoms")}
                          if isinstance(v, dict) else v)
                      for k, v in rec.items()}, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
