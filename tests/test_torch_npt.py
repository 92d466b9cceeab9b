"""fix npt of the port against the JAX package (CPU, f64).

(a) The barostat's scalar arithmetic: ``nh_omega_dot_half``,
    ``nh_press_vfac`` and ``baro_chain_half`` against the JAX functions
    over a few chained calls (iso, per-axis z, aniso; mtk on and off;
    pchain 2 and 3), rel 1e-13.
(b) The slice: ``NPTSimulation`` on one copy of rhodo_npt.yaml's stack
    (examples/data.rhodo_class, 1,728 atoms, lj/charmm/coul/long with
    specials, PPPM, CHARMM bonded terms, fix npt z 0 0 1000 mtk no pchain 0
    tchain 1) in double, through ``build_simulation(device="cpu")`` on both
    sides, 10 steps (two neighbor blocks) with rows every 5: the thermo rows,
    boxL, omega_dot, the thermostat chain, forces, positions, velocities
    and image flags within 1e-10 relative; with fix shake and without.
    The deck front-end gives the JAX package's NPTConfig and thermostat.
(c) The front-end parses iso, aniso and per-axis forms as the JAX package
    does and refuses what it does not port, naming the ROADMAP item.
(d) ``interop.npt_config_from_numpy`` / ``npt_barostat_from_numpy`` carry
    a JAX barostat into the port.
"""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lammps_buck_intel_tpu.core.units import REAL as JREAL
from lammps_buck_intel_tpu.integrate import npt as jnpt
from lammps_buck_intel_tpu.run import build_simulation as jbuild
from lammps_buck_intel_tpu_torch import interop
from lammps_buck_intel_tpu_torch import run as trun
from lammps_buck_intel_tpu_torch.core.units import REAL as TREAL
from lammps_buck_intel_tpu_torch.integrate import npt as tnpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECK = os.path.join(ROOT, "examples", "decks", "rhodo_npt.yaml")


def _deck(**kw):
    with open(DECK) as f:
        cfg = yaml.safe_load(f)
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    cfg.update(kw)
    return cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


# ---- (a) the barostat's scalar arithmetic ----

CONFIGS = {
    "iso_mtk": dict(p_start=(1.0,) * 3, p_stop=(1.0,) * 3, p_damp=1000.0,
                    flags=(True, True, True), couple="xyz", mtk=True),
    "z_nomtk": dict(p_start=(0.0,) * 3, p_stop=(0.0,) * 3, p_damp=1000.0,
                    flags=(False, False, True), couple="none", mtk=False),
    "aniso_mtk": dict(p_start=(1.0, 2.0, 3.0), p_stop=(1.0, 2.0, 3.0),
                      p_damp=500.0, flags=(True, True, True), couple="none",
                      mtk=True),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("pchain", [0, 2, 3])
def test_barostat_scalars_match_jax(name, pchain):
    kw = dict(CONFIGS[name], pchain=pchain)
    jc, tc = jnpt.NPTConfig(**kw), tnpt.NPTConfig(**kw)
    rng = np.random.default_rng(5)
    n, dt, tt = 1728, 1.0, 300.0
    od = rng.normal(0.0, 1e-6, 3)
    pth = rng.normal(0.0, 1e-3, (2, pchain))
    pt = np.asarray(kw["p_start"])
    jod, tod = jnp.asarray(od), torch.as_tensor(od)
    jpt, tpt = jnp.asarray(pth), torch.as_tensor(pth)
    for _ in range(3):
        mv2 = rng.uniform(1e4, 2e4, 3)
        vir3 = rng.normal(0.0, 5e3, 3)
        V = 157464.0 * rng.uniform(0.99, 1.01)
        jod = jnpt.nh_omega_dot_half(jc, JREAL, n, dt, jod, jnp.asarray(mv2),
                                     jnp.asarray(vir3), V, tt, pt)
        tod = tnpt.nh_omega_dot_half(tc, TREAL, n, dt, tod,
                                     torch.as_tensor(mv2),
                                     torch.as_tensor(vir3), V, tt,
                                     torch.as_tensor(pt))
        assert _rel(tod.numpy(), jod) <= 1e-13
        assert _rel(tnpt.nh_press_vfac(tc, n, dt, tod).numpy(),
                    jnpt.nh_press_vfac(jc, n, dt, jod)) <= 1e-13
        if pchain:
            jod, jpt = jnpt.baro_chain_half(jc, JREAL, n, dt, jod, jpt, tt)
            tod, tpt = tnpt.baro_chain_half(tc, TREAL, n, dt, tod, tpt, tt)
            assert _rel(tod.numpy(), jod) <= 1e-13
            assert _rel(tpt.numpy(), jpt) <= 1e-13


# ---- (b) the slice ----

ROW_KEYS = ("temp", "ke", "press", "vol", "evdwl", "ecoul", "elong", "emol",
            "epair", "etotal", "boxL", "omega_dot", "p_axis")


@pytest.mark.parametrize("shake", [True, False])
def test_npt_simulation_matches_jax(shake):
    cfg = _deck(replicate=[1, 1, 1], precision="double")
    if not shake:
        cfg["fixes"] = [f for f in cfg["fixes"] if f["name"] != "shake"]
    js = jbuild(copy.deepcopy(cfg))
    # the JAX package's torsion angle (interop.jax_torsion_deck)
    ts = trun.build_simulation(interop.jax_torsion_deck(cfg), device="cpu")
    assert isinstance(ts, tnpt.NPTSimulation)
    # the front-end: the same barostat, thermostat, mesh and list sizing
    for f in ("p_start", "p_stop", "p_damp", "flags", "couple", "mtk",
              "pchain"):
        assert getattr(ts.npt, f) == getattr(js.npt, f), f
    for f in ("t_start", "t_stop", "t_damp", "tchain", "dof"):
        assert getattr(ts.thermostat, f) == getattr(js.thermostat, f), f
    assert ts.kspace.grid == tuple(js.kspace.grid)
    assert ts.kspace.g_ewald == float(js.kspace.g_ewald)
    assert (ts.spec.kmax, ts.spec.nc, ts.spec.cell_cap) == \
        (js.spec.kmax, js.spec.nc, js.spec.cell_cap)
    assert (ts.shake is None) == (not shake)
    ja, ta = js.get_atoms(), ts.get_atoms()
    assert _rel(ta["x"], ja["x"]) <= 1e-14     # the settle
    assert _rel(ta["f"], ja["f"]) <= 1e-10
    jrows = js.run(10, thermo_every=5, log=False)
    trows = ts.run(10, thermo_every=5, log=False)
    assert [r["step"] for r in trows] == [0, 5, 10]
    for tr, jr in zip(trows, jrows, strict=True):
        for k in ROW_KEYS:
            # omega_dot starts at 0: its first row is exactly 0 on both
            assert _rel(tr[k], jr[k]) <= 1e-10, (tr["step"], k)
    ja, ta = js.get_atoms(), ts.get_atoms()
    for k in ("x", "v", "f", "boxL"):
        assert _rel(ta[k], ja[k]) <= 1e-10, k
    np.testing.assert_array_equal(ta["image"], ja["image"])
    assert _rel(ts.state.therm.numpy(), np.asarray(js.state.therm)) <= 1e-10
    assert _rel(ts.state.omega_dot.numpy(),
                np.asarray(js.state.omega_dot)) <= 1e-10
    # the barostat moved the box and the thermostat the chain
    assert abs(trows[-1]["boxL"][2] - trows[0]["boxL"][2]) > 1e-6
    assert float(ts.state.therm.abs().max()) > 0.0


# ---- (c) the front-end ----

@pytest.mark.parametrize("form,flags,couple", [
    ({"iso": [1.0, 2.0, 100.0]}, (True, True, True), "xyz"),
    ({"aniso": [1.0, 2.0, 100.0]}, (True, True, True), "none"),
    ({"x": [1.0, 1.0, 50.0], "z": [3.0, 4.0, 70.0]}, (True, False, True),
     "none"),
])
def test_npt_parse_forms(form, flags, couple):
    fx = dict(name="npt", t_start=300.0, t_damp=100.0, mtk=False, pchain=2,
              **form)
    npt, thermo = trun._npt_config(fx)
    assert npt.flags == flags and npt.couple == couple
    assert npt.mtk is False and npt.pchain == 2
    assert (thermo.t_start, thermo.t_stop, thermo.t_damp, thermo.tchain) == \
        (300.0, 300.0, 100.0, 3)
    if "iso" in form or "aniso" in form:
        pv = form.get("iso", form.get("aniso"))
        assert npt.p_start == (pv[0],) * 3 and npt.p_stop == (pv[1],) * 3
        assert npt.p_damp == pv[2]
    else:
        assert npt.p_start == (1.0, 0.0, 3.0) and npt.p_stop == (1.0, 0.0, 4.0)
        assert npt.p_damp == 70.0     # the last named axis's damping


@pytest.mark.parametrize("change,match", [
    (lambda c: c["fixes"].append({"name": "rigid/npt/small"}), "item 13"),
    (lambda c: c["kspace_style"].update(mesh=[8, 8, 8]), "item 10"),
    (lambda c: c["kspace_style"].update(name="ewald", slab=3.0), "item 10"),
    (lambda c: c["kspace_style"].update(name="pppm/disp"), "item 13"),
    (lambda c: c["kspace_style"].update(name="ewald", order=5), "item 10"),
    (lambda c: c["fixes"][1].update(drag=1.0), "not ported"),
    (lambda c: c["fixes"][1].update(xy=[0.0, 0.0, 1000.0]), "item 14"),
    (lambda c: c.update(engine="slab"), "item 16"),
])
def test_npt_unported_forms_raise(change, match):
    cfg = _deck()
    change(cfg)
    with pytest.raises(NotImplementedError, match=match):
        trun._check_deck(cfg)


def test_npt_conflicting_fixes_raise():
    cfg = _deck()
    cfg["fixes"].append({"name": "nvt", "t_start": 300.0, "t_damp": 100.0})
    with pytest.raises(ValueError, match="drop fix"):
        trun._check_deck(cfg)
    cfg = _deck()
    cfg["fixes"][1]["iso"] = [0.0, 0.0, 1000.0]
    with pytest.raises(ValueError, match="exactly one pressure form"):
        trun._check_deck(cfg)
    # the literal deck passes, with and without an engine key
    trun._check_deck(_deck())
    trun._check_deck(_deck(engine="cellpair"))


def test_triclinic_npt_raises(tmp_path):
    """The NPT deck on a tilted copy of its data file raises, naming the
    ROADMAP item of triclinic NPT."""
    with open(_deck()["read_data"]) as f:
        lines = f.readlines()
    at = next(i for i, ln in enumerate(lines) if "zlo zhi" in ln)
    lines.insert(at + 1, "2.0 0.0 0.0 xy xz yz\n")
    data = tmp_path / "data.tilted"
    data.write_text("".join(lines))
    with pytest.raises(NotImplementedError, match="item 14"):
        trun.build_simulation(_deck(read_data=str(data), replicate=[1, 1, 1]),
                              device="cpu")


# ---- (d) interop ----

def test_npt_interop_carries_the_barostat():
    cfg = _deck(replicate=[1, 1, 1], precision="double")
    ts = trun.build_simulation(copy.deepcopy(cfg), device="cpu")
    jc = jnpt.NPTConfig(p_start=(0.0,) * 3, p_stop=(0.0,) * 3, p_damp=1000.0,
                        flags=(False, False, True), couple="none", mtk=False,
                        pchain=0)
    tc = interop.npt_config_from_numpy(jc.p_start, jc.p_stop, jc.p_damp,
                                       jc.flags, jc.couple, jc.mtk, jc.pchain)
    assert tc == ts.npt
    od = np.array([0.0, 0.0, 3.5e-7])
    boxL = np.array([54.0, 54.0, 53.99])
    interop.npt_barostat_from_numpy(ts, od, np.zeros((2, 0)), boxL)
    st = ts.state
    assert st.omega_dot.dtype == torch.float64
    np.testing.assert_array_equal(st.omega_dot.numpy(), od)
    np.testing.assert_array_equal(st.boxL.numpy(), boxL)
    row = ts.thermo()
    assert abs(row["vol"] - float(np.prod(boxL))) <= 1e-9 * row["vol"]
    with pytest.raises(ValueError, match="links"):
        interop.npt_barostat_from_numpy(ts, od, np.zeros((2, 2)), boxL)
