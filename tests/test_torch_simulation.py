"""The neighbor-list ``Simulation`` of the port against the JAX package's
(CPU, f64).

Both packages build the deck (``run.build_simulation``); the port's state
is then set to the JAX engine's (``interop.md_state_from_numpy``), so
both start from the same positions, velocities, images, forces and chain,
and run the same steps.  Compared within 1e-10 relative: the set-up force
(before the state is carried over; of at least a unit force, as the ideal
lattice starts at zero force), every thermo row (temp, evdwl, ecoul, elong,
emol, epair, ke, etotal, press), the final positions (of the box length),
velocities, forces and chain; images equal; the same blocks (segment
length and cadence of every ``_advance``).

(a) buck_small.yaml (500 atoms, the dense build: the cell engine finds
    the box too small and the deck runner falls back), NVE, 20 steps,
    ``check no, every 5``;
(b) the same lattice under ``check yes, every 1`` with thermo every 7:
    the vmax cadence and tail blocks;
(c) one copy of the cristobalite crystal jittered by
    ``gen_cristobalite.jitter``, cristobalite_pppm_nlist.yaml's stack
    (buck/coul/long 10 A + PPPM order 7 on the generic mesh), NVE, 10
    steps: the dense build (one cell along z) and K10;
(d) rhodo_class.yaml with ``engine: nlist`` (1,728 atoms, the binned
    build), NVT + SHAKE + bonded terms + PPPM order 5, 10 steps;
(e) cristobalite_ewald.yaml's stack (buck/coul/long + ewald 1e-6, every 1
    check yes) on the same jittered copy, its cutoff cut from 12 to 10 A
    to fit one copy (the dense build, the same k set in both packages);
(f) cristobalite_coul_cut.yaml (buck/coul/cut 10 A, no k-space: elong 0,
    the Coulomb energy in ecoul) on the same copy.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from lammps_buck_intel_tpu import run as jrun
from lammps_buck_intel_tpu.integrate import Simulation as JSimulation
from lammps_buck_intel_tpu_torch import run as trun
from lammps_buck_intel_tpu_torch.integrate import Simulation
from lammps_buck_intel_tpu_torch.interop import (jax_torsion_deck,
                                                 md_state_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = os.path.join(ROOT, "examples", "decks")
ROW_KEYS = ("temp", "evdwl", "ecoul", "elong", "emol", "epair", "ke",
            "etotal", "press")
RTOL = 1e-10


def _deck(name, **kw):
    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(precision="double", **kw)
    return cfg


def _cristobalite(tmp_path, deck="cristobalite_pppm_nlist.yaml"):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import gen_cristobalite

    path = os.path.join(tmp_path, "data.cristobalite_jitter")
    gen_cristobalite.write(path, jitter_amp=0.1)
    return _deck(deck, read_data=path, replicate=[1, 1, 1])


def _case(name, tmp_path):
    """(deck, steps, thermo_every)."""
    if name == "dense_every5":
        return _deck("buck_small.yaml"), 20, 10
    if name == "dense_check":
        cfg = _deck("buck_small.yaml")
        cfg["neighbor"] = dict(cfg["neighbor"], every=1, check=True)
        return cfg, 20, 7
    if name == "cristobalite_pppm":
        return _cristobalite(tmp_path), 10, 5
    if name == "cristobalite_ewald":
        cfg = _cristobalite(tmp_path, "cristobalite_ewald.yaml")
        cfg["pair_style"]["cut"] = 10.0
        return cfg, 10, 5
    if name == "cristobalite_coul_cut":
        return _cristobalite(tmp_path, "cristobalite_coul_cut.yaml"), 10, 5
    cfg = _deck("rhodo_class.yaml", engine="nlist",
                read_data=os.path.join(ROOT, "examples", "data.rhodo_class"))
    return cfg, 10, 5


def _close(a, b, what):
    assert abs(a - b) <= RTOL * max(abs(b), 1e-300), (what, a, b)


def _advances(monkeypatch, cls):
    seen = []
    advance = cls._advance

    def spy(self, total, cadence):
        seen.append((total, cadence))
        return advance(self, total, cadence)

    monkeypatch.setattr(cls, "_advance", spy)
    return seen


@pytest.mark.parametrize("name", ["dense_every5", "dense_check",
                                  "cristobalite_pppm", "rhodo_nlist",
                                  "cristobalite_ewald",
                                  "cristobalite_coul_cut"])
def test_simulation_matches_jax(name, tmp_path, monkeypatch):
    cfg, steps, every = _case(name, str(tmp_path))
    jsim = jrun.build_simulation(copy.deepcopy(cfg))
    # the JAX package's torsion angle (interop.jax_torsion_deck)
    tsim = trun.build_simulation(jax_torsion_deck(cfg), device="cpu")
    assert isinstance(jsim, JSimulation) and isinstance(tsim, Simulation)
    assert tsim.spec.dense == jsim.spec.dense == (name != "rhodo_nlist")
    assert (tsim.spec.kmax, tsim.spec.nc) == (jsim.spec.kmax, jsim.spec.nc)
    assert (tsim.kspace is None) == (jsim.kspace is None)
    if name == "cristobalite_ewald":
        assert np.array_equal(tsim.kspace.kvecs, jsim.kspace.kvecs)
        assert np.array_equal(tsim.kspace.ug, jsim.kspace.ug)
        assert tsim.kspace.g_ewald == jsim.kspace.g_ewald
    elif tsim.kspace is not None:
        assert tsim.kspace.grid == tuple(jsim.kspace.grid)
        assert tsim.kspace.g_ewald == jsim.kspace.g_ewald
    if name == "cristobalite_coul_cut":
        assert tsim.kspace is None and tsim.pair.cfg.coul == "cut"
    if name == "rhodo_nlist":
        assert tsim.shake is not None and tsim.thermostat is not None
        assert tsim.bonded is not None and tsim._special is not None
    js = jsim.state
    fj = np.asarray(js.f)
    ft = tsim.state.f.t().numpy()
    # (the ideal lattice starts at zero force: at least a unit scale)
    assert np.abs(ft - fj).max() <= RTOL * max(np.abs(fj).max(), 1.0)

    tsim.state = md_state_from_numpy(js.x, js.v, js.image, js.therm,
                                     device="cpu", f=js.f)
    jadv = _advances(monkeypatch, JSimulation)
    tadv = _advances(monkeypatch, Simulation)
    jrows = jsim.run(steps, thermo_every=every, log=False)
    trows = tsim.run(steps, thermo_every=every, log=False)
    assert tadv == jadv
    if name == "dense_check":
        # the vmax cadence, and a tail block after the full ones
        assert all(c > 1 for _, c in jadv) and any(t % c for t, c in jadv)
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    for jr, tr in zip(jrows, trows):
        for key in ROW_KEYS:
            _close(tr[key], jr[key], (jr["step"], key))
        assert not tr["overflow"]
        if name == "cristobalite_coul_cut":
            assert tr["elong"] == 0.0 and tr["ecoul"] < -1e3
    L = np.asarray(tsim.box.lengths)
    js = jsim.state
    st = tsim.state
    assert np.abs(st.x.t().numpy() - np.asarray(js.x)).max() <= \
        RTOL * L.max()
    for field in ("v", "f"):
        aj = np.asarray(getattr(js, field))
        at = getattr(st, field).t().numpy()
        assert np.abs(at - aj).max() <= RTOL * np.abs(aj).max(), field
    np.testing.assert_array_equal(st.image.t().numpy(), np.asarray(js.image))
    thj = np.asarray(js.therm)
    assert st.therm.shape == thj.shape
    if thj.size:
        assert np.abs(st.therm.numpy() - thj).max() <= \
            RTOL * np.abs(thj).max()


def test_run_without_thermo_raises_on_overflow():
    """A run with thermo off still surfaces the sticky overflow flag."""
    cfg = _deck("buck_small.yaml")
    tsim = trun.build_simulation(cfg, device="cpu")
    tsim.state = tsim.state._replace(overflow=torch.tensor(True))
    with pytest.raises(RuntimeError, match="overflow"):
        tsim.run(5, thermo_every=0, log=False)
