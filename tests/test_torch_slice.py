"""The port's main path end to end against the JAX package (CPU, f64).

buck.yaml shrunk to 6^3 (864 atoms, the smallest lattice that keeps 3
cells per axis for the cell-pair engine), 40 steps, thermo every 20:
thermo rows agree to rel 1e-9 and final atom-order unwrapped positions
to 1e-9 abs.  Variants: buck_big's neighbor policy (every 1, delay 5,
check yes — the vmax-driven rebin cadence) and a forced capacity that
overflows mid-run (rollback, grow, rebin, replay).
"""
import os

import numpy as np
import pytest
import yaml

from lammps_buck_intel_tpu.run import run_deck as jax_run_deck
from lammps_buck_intel_tpu_torch.integrate import CellPairSimulation
from lammps_buck_intel_tpu_torch.run import run_deck

DECKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "decks")


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
