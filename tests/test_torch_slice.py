"""The port's main path end to end against the JAX package (CPU, f64).

buck.yaml shrunk to 6^3 (864 atoms, the smallest lattice that keeps 3
cells per axis for the cell-pair engine), 40 steps, thermo every 20:
thermo rows agree to rel 1e-9 and final atom-order unwrapped positions
to 1e-9 abs.  Variants: buck_big's neighbor policy (every 1, delay 5,
check yes — the vmax-driven rebin cadence) and a forced capacity that
overflows mid-run (rollback, grow, rebin, replay).

cristobalite_pppm.yaml (buck/coul/long + PPPM order 7, ik) shrunk to one
copy of examples/data.cristobalite (1,440 atoms) with cutoff 5.0 and
skin 0.5 (cells 5x6x3), 20 steps in double: thermo rows (temp, epair,
elong, etotal, press) rel 1e-9 and final unwrapped positions 1e-9; both
packages solve on the same mesh with the same g_ewald.

rhodo_flex_nve.yaml and rhodo_flex_nvt.yaml (lj/charmm/coul/long with
special bonds, PPPM order 5, bonds, CHARMM angles, dihedrals with 1-4
terms, impropers) on one copy of examples/data.rhodo_class (1,728 atoms,
4 cells per axis, so both packages run the cell engine), 10 steps in
double: every thermo field (temp, evdwl, ecoul, elong, emol, press,
etotal) rel 1e-9 and unwrapped positions 1e-9 A.  The NVE run crosses a
rebin (every 5); the NVT run is cut in two by a forced capacity grow, so
the slot-of-atom map and the thermostat chain are seen to survive both.
"""
import os

import numpy as np
import pytest
import yaml

from lammps_buck_intel_tpu.run import run_deck as jax_run_deck
from lammps_buck_intel_tpu_torch.integrate import CellPairSimulation
from lammps_buck_intel_tpu_torch.interop import jax_torsion_deck
from lammps_buck_intel_tpu_torch.run import build_simulation, run_deck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = os.path.join(ROOT, "examples", "decks")


def _cfg(variant):
    with open(os.path.join(DECKS, "buck.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["lattice"].update(nx=6, ny=6, nz=6)
    cfg.update(run=40, thermo=20, precision="double")
    if variant == "check":
        cfg["neighbor"] = {"skin": 0.3, "every": 1, "delay": 5,
                           "check": True}
    elif variant == "overflow":
        cfg["cap"] = 32   # every cell starts full: the melt overflows
    return cfg


def _unwrapped(sim):
    a = sim.get_atoms()
    return a["x"] + a["image"] * np.asarray(sim.box.lengths)


@pytest.mark.parametrize("variant", ["every20", "check", "overflow"])
def test_buck_deck_matches_jax(variant, monkeypatch):
    blocks = []
    block = CellPairSimulation._block

    def counted(self, state, nsteps):
        blocks.append(nsteps)
        return block(self, state, nsteps)

    monkeypatch.setattr(CellPairSimulation, "_block", counted)
    jsim, jrows = jax_run_deck(_cfg(variant), log=False)
    tsim, trows = run_deck(_cfg(variant), device="cpu", log=False)
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] \
        == [0, 20, 40]
    for jr, tr in zip(jrows, trows):
        for key in ("temp", "epair", "etotal", "press"):
            assert abs(tr[key] - jr[key]) <= 1e-9 * abs(jr[key]), \
                (variant, jr["step"], key, tr[key], jr[key])
    assert np.abs(_unwrapped(tsim) - _unwrapped(jsim)).max() <= 1e-9
    assert tsim.grid == type(tsim.grid)(
        nc=jsim.grid.nc, cap=jsim.grid.cap, n_atoms=jsim.grid.n_atoms,
        reach_z=jsim.grid.reach_z)
    if variant == "overflow":
        assert tsim.grows >= 1 and tsim.grid.cap > 32
    if variant == "check":
        # vmax-driven cadence: blocks of several steps, not every=1
        assert 1 < len(blocks) < 40 and max(blocks) > 1
    else:
        assert sum(blocks) >= 40


def _cristobalite_cfg():
    with open(os.path.join(DECKS, "cristobalite_pppm.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(read_data=os.path.join(ROOT, "examples", "data.cristobalite"),
               replicate=[1, 1, 1], run=20, thermo=10, precision="double")
    cfg["pair_style"]["cut"] = 5.0
    cfg["neighbor"] = dict(cfg["neighbor"], skin=0.5)
    return cfg


def test_cristobalite_pppm_deck_matches_jax():
    jsim, jrows = jax_run_deck(_cristobalite_cfg(), log=False)
    tsim, trows = run_deck(_cristobalite_cfg(), device="cpu", log=False)
    assert tsim.n_atoms == 1440 and tsim.grid.nc == tuple(jsim.grid.nc) \
        == (5, 6, 3)
    pm, jpm = tsim.kspace.pm, jsim.kspace.pm
    assert pm.grid == tuple(jpm.grid) and pm.order == 7
    assert pm.g_ewald == jpm.g_ewald == tsim.pair.g_ewald
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] \
        == [0, 10, 20]
    for jr, tr in zip(jrows, trows):
        assert abs(jr["elong"]) > 1.0 and abs(jr["ecoul"]) > 1.0
        for key in ("temp", "epair", "elong", "etotal", "press"):
            assert abs(tr[key] - jr[key]) <= 1e-9 * abs(jr[key]), \
                (jr["step"], key, tr[key], jr[key])
    assert np.abs(_unwrapped(tsim) - _unwrapped(jsim)).max() <= 1e-9


def test_initial_force_includes_kspace():
    """The engine calls its k-space factory once with its own grid and
    starts from the pair force plus the solver's force, evaluated once,
    on jittered silica."""
    import torch

    from lammps_buck_intel_tpu_torch.core import make_system
    from lammps_buck_intel_tpu_torch.io import read_data
    from lammps_buck_intel_tpu_torch.models.pair.cellpair import \
        compute_cellpair
    from lammps_buck_intel_tpu_torch.neighbor import cell_slots as cs

    cfg = _cristobalite_cfg()
    a = build_simulation(cfg, device="cpu")
    at = a.get_atoms()
    x = at["x"] + np.random.default_rng(4).uniform(-0.1, 0.1, at["x"].shape)
    system = make_system(x, a.box, type=at["typ"], v=at["v"], q=at["q"],
                         image=at["image"],
                         mass=read_data(cfg["read_data"]).mass,
                         dtype=torch.float64, device="cpu")
    solver, grids, calls = a.kspace, [], []
    compute = solver.compute_slots

    def counted(*args):
        calls.append(args[1:])
        return compute(*args)

    solver.compute_slots = counted

    def make(grid):
        grids.append(grid)
        return solver

    b = CellPairSimulation(system, a.pair, units=a.units,
                           precision=a.precision, dt=a.dt,
                           neighbor=a.neighbor, kspace=make)
    assert grids == [b.grid] and b.kspace is solver
    assert calls == [(False, False)]
    st = b.state
    r = compute_cellpair(b.pair, b.grid, b.box, st, acc_dtype=torch.float64)
    kf = compute(st, False, False)[:3]
    want = cs.to_atoms(b.grid, st._replace(
        fx=r.fx + kf[0], fy=r.fy + kf[1], fz=r.fz + kf[2]))["f"].numpy()
    k_only = cs.to_atoms(b.grid, st._replace(
        fx=kf[0], fy=kf[1], fz=kf[2]))["f"].numpy()
    f = b.get_atoms()["f"]
    assert np.abs(k_only).max() > 1e-2
    np.testing.assert_allclose(f, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


RHODO_FIELDS = ("temp", "evdwl", "ecoul", "elong", "emol", "press", "etotal")


def _rhodo_cfg(name):
    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(read_data=os.path.join(ROOT, cfg["read_data"]),
               replicate=[1, 1, 1], run=10, thermo=5, precision="double")
    return cfg


def _assert_rows(jrows, trows, steps):
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == steps
    for jr, tr in zip(jrows, trows):
        for key in RHODO_FIELDS:
            assert abs(jr[key]) > 1e-3, key
            assert abs(tr[key] - jr[key]) <= 1e-9 * abs(jr[key]), \
                (jr["step"], key, tr[key], jr[key])


def test_rhodo_flex_nve_deck_matches_jax(monkeypatch):
    blocks = []
    block = CellPairSimulation._block

    def counted(self, state, nsteps):
        blocks.append(nsteps)
        return block(self, state, nsteps)

    monkeypatch.setattr(CellPairSimulation, "_block", counted)
    cfg = _rhodo_cfg("rhodo_flex_nve.yaml")
    jsim, jrows = jax_run_deck(dict(cfg), log=False)
    tsim, trows = run_deck(jax_torsion_deck(cfg), device="cpu", log=False)
    assert tsim.n_atoms == 1728 and tsim.grid.nc == tuple(jsim.grid.nc) \
        == (4, 4, 4)
    assert blocks == [5, 5]          # a rebin at step 5
    assert tsim.special.width == 7 and tsim.thermostat is None
    assert tsim.state.therm is None
    pm, jpm = tsim.kspace.pm, jsim.kspace.pm
    assert pm.grid == tuple(jpm.grid) and pm.order == 5
    assert pm.g_ewald == jpm.g_ewald == tsim.pair.g_ewald
    _assert_rows(jrows, trows, [0, 5, 10])
    assert np.abs(_unwrapped(tsim) - _unwrapped(jsim)).max() <= 1e-9
    # NVE: the flexible deck conserves energy
    assert abs(trows[-1]["etotal"] - trows[0]["etotal"]) < 1.0


def test_rhodo_flex_nvt_deck_matches_jax_across_a_capacity_grow():
    from lammps_buck_intel_tpu.run import build_simulation as jax_build

    cfg = _rhodo_cfg("rhodo_flex_nvt.yaml")
    jsim = jax_build(dict(cfg))
    tsim = build_simulation(jax_torsion_deck(cfg), device="cpu")
    assert tsim.thermostat.dof == jsim.thermostat.dof == 3 * 1728 - 3
    assert tsim.thermostat.tchain == 1
    jrows, trows = [], []
    for sim, rows, kw in ((jsim, jrows, {}), (tsim, trows, {})):
        rows += sim.run(5, thermo_every=5, log=False, **kw)
        cap = sim.grid.cap
        sim._grow_capacity()
        assert sim.grid.cap > cap
        rows += sim.run(5, thermo_every=5, log=False)[1:]
    assert tsim.grows == 1 and tsim.grid.cap == jsim.grid.cap
    assert tsim.state.x.shape[0] == tsim.grid.nslots
    _assert_rows(jrows, trows, [0, 5, 10])
    assert np.abs(_unwrapped(tsim) - _unwrapped(jsim)).max() <= 1e-9
    jtherm = np.asarray(jsim.state.therm)
    ttherm = tsim.state.therm.numpy()
    assert ttherm.shape == jtherm.shape == (2, 1) and abs(jtherm[0, 0]) > 1e-4
    assert np.abs(ttherm - jtherm).max() <= 1e-9 * np.abs(jtherm).max()
    # the thermostat does work: NVT's etotal moves where NVE's holds
    assert abs(trows[-1]["etotal"] - trows[0]["etotal"]) > 1.0
