"""Dispersion PPPM (``pppm/disp``, K12) and the lj/long pair term of the
port against the JAX package (CPU, f64).

(a) ``setup_pppm_disp``: the mesh, G, vfac, the k vectors and the channel
    tables A and P equal the JAX package's to the bit (geometric and
    arithmetic on ``tests/test_pppm_disp.py``'s system, and the
    cell-aligned mesh of a hexane cut-out); ``interop.pppm_disp_from_numpy``
    carries a JAX PPPMDisp over unchanged.
(b) ``disp_compute_plain`` (the version the kernels are held to) against
    the JAX ``_disp_compute_multi``: forces, elong and the virial within
    1e-10 relative, with one geometric channel and the seven arithmetic
    ones; the row route (``disp_compute_rows``, each stage's plain version
    on the CPU) gives the plain result to 1e-12.
(c) The lj/long and lj/cut pair terms (``pair_terms``, with and without
    special-bond factors) and the cell-pair forces of a hexane cut-out
    with same-molecule exclusion (``slot_mol``) within 1e-10.
(d) ``CellPPPMDisp.compute_slots`` and ``BoundKSpace`` against the JAX
    classes on the same slot state / atoms within 1e-10.
(e) The deck runner: the pppm/disp forms the port does not run raise; the
    forms it has run since the arithmetic and no-mix channels and coul long
    with disp long were ported (mix arithmetic; ``coul`` dropped, on
    charged chains) run on the cut-out as in the JAX package; the
    generated decks are the reference deck line for line but for the data
    file (and the replication).
"""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.models.kspace import pppm_disp as jdisp
from lammps_buck_intel_tpu.models.kspace.base import BoundKSpace as JBound
from lammps_buck_intel_tpu.models.pair import cellpair as jcellpair
from lammps_buck_intel_tpu.models.pair import styles as jstyles
from lammps_buck_intel_tpu.run import build_simulation as jbuild
from lammps_buck_intel_tpu_torch.core import make_box as tmake_box
from lammps_buck_intel_tpu_torch.interop import (pair_style_from_numpy,
                                                 pppm_disp_from_numpy,
                                                 slot_state_from_numpy)
from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as tdisp
from lammps_buck_intel_tpu_torch.models.kspace.base import BoundKSpace
from lammps_buck_intel_tpu_torch.models.kspace.pppm_cells import CellPPPMDisp
from lammps_buck_intel_tpu_torch.models.pair import cellpair as tcellpair
from lammps_buck_intel_tpu_torch.models.pair import styles as tstyles
from lammps_buck_intel_tpu_torch.neighbor import cell_slots as tcs
from lammps_buck_intel_tpu_torch.run import build_simulation as tbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = os.path.join(ROOT, "examples", "decks")
sys.path.insert(0, os.path.join(ROOT, "examples"))
import gen_hexane  # noqa: E402

RTOL = 1e-10
EPS = np.array([0.30, 0.18])
SIG = np.array([1.10, 1.25])


def _disp_system(seed=0, n=24, L=7.0):
    """tests/test_pppm_disp.py's _disp_system: n atoms of two types, no
    pair closer than sqrt(1.2), in a cube of side L."""
    rng = np.random.RandomState(seed)
    x = []
    while len(x) < n:
        p = rng.uniform(0, L, 3)
        ok = True
        for xx in x:
            d = p - xx
            d -= np.round(d / L) * L
            ok &= float((d ** 2).sum()) > 1.2
        if ok:
            x.append(p)
    return np.asarray(x), rng.randint(0, 2, n).astype(np.int32), L


def _setups(mix, **kw):
    x, typ, L = _disp_system()
    B = np.sqrt(4.0 * EPS) * SIG**3
    mk = dict(B_per_type=B, typ=typ, cutoff=3.2, tol_real=1e-5, mix=mix,
              epsilon=EPS, sigma=SIG, **kw)
    j = jdisp.setup_pppm_disp(jmake_box([0, 0, 0], [L] * 3),
                              acc_dtype=jnp.float64, **mk)
    t = tdisp.setup_pppm_disp(tmake_box([0, 0, 0], [L] * 3),
                              acc_dtype=torch.float64, **mk)
    return x, typ, j, t


def _port_of(j):
    return pppm_disp_from_numpy(j.g_ewald_6, j.grid, j.order, j.greensfn,
                                j.kx, j.ky, j.kz, j.B, j.volume, j.box_lo,
                                j.h, j.mix, j.A, j.P, j.vfac)


def _same_tables(j, t):
    assert t.grid == j.grid and t.order == j.order
    assert t.g_ewald_6 == j.g_ewald_6 and t.volume == j.volume
    assert t.h == j.h and t.box_lo == j.box_lo and t.w0 == j.w0
    for name in ("greensfn", "kx", "ky", "kz", "B", "A", "P", "vfac"):
        assert np.array_equal(np.asarray(getattr(t, name)),
                              np.asarray(getattr(j, name))), name


@pytest.mark.parametrize("mix,kw", [
    ("geometric", {}), ("arithmetic", {}),
    ("geometric", dict(multiple_of=(3, 3, 3), grid_min=(12, 15, 12)))])
def test_setup_pppm_disp_tables_bit_equal(mix, kw):
    _, _, j, t = _setups(mix, **kw)
    _same_tables(j, t)
    _same_tables(j, _port_of(j))
    assert tdisp.solve_g6(9.8, 1e-4) == jdisp.solve_g6(9.8, 1e-4)
    assert np.array_equal(
        tdisp.dispersion_kernel(0.38)(np.linspace(0.0, 9.0, 37)),
        jdisp.dispersion_kernel(0.38)(np.linspace(0.0, 9.0, 37)))


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rtol * scale, (
        float(np.abs(a - b).max()), scale)


@pytest.mark.parametrize("mix", ["geometric", "arithmetic"])
def test_disp_compute_plain_matches_jax(mix):
    x, typ, j, t = _setups(mix)
    A = np.asarray(j.A)
    a = A[:, typ]
    jr = jdisp._disp_compute_multi(j, jnp.asarray(x), jnp.asarray(a), j.P,
                                   True, True)
    xt = torch.as_tensor(x.T.copy())
    at = torch.as_tensor(a)
    tr = tdisp.disp_compute_plain(t, xt, at, t.P, True, True)
    _close(torch.stack(tr.f, -1).numpy(), jr.f)
    _close(float(tr.elong), float(jr.elong))
    _close(tr.virial.numpy(), jr.virial)
    # the row route (the multi-channel deposit and gather) with each
    # stage's plain version
    st = tdisp.disp_compute_rows(
        t, xt, torch.arange(len(x), dtype=torch.int32), at, t.P, True, True)
    _close(torch.stack(st.f, -1).numpy(), torch.stack(tr.f, -1).numpy(),
           1e-12)
    _close(float(st.elong), float(tr.elong), 1e-12)
    _close(st.virial.numpy(), tr.virial.numpy(), 1e-12)
    # eflag / vflag off
    off = tdisp.disp_compute_plain(t, xt, at, t.P, False, False)
    assert float(off.elong) == 0.0 and not off.virial.any()


@pytest.mark.parametrize("disp,special", [("long", False), ("long", True),
                                          ("cut", False), ("cut", True)])
def test_lj_pair_terms_matches_jax(disp, special):
    coeffs = {0: (0.1744742, 3.97), 1: (0.1147228, 3.97)}
    j = jstyles.build_lj(2, coeffs, cut_global=9.8, disp=disp,
                         dtype=jnp.float64, shift=disp == "cut")
    t = tstyles.build_lj(2, coeffs, cut_global=9.8, disp=disp,
                         shift=disp == "cut")
    assert np.array_equal(j.tables, t.tables) and j.cutsq_max == t.cutsq_max
    g6 = jdisp.solve_g6(9.8, 1e-4)
    j, t = j.replace(g_ewald_6=g6), t.replace(g_ewald_6=g6)
    rng = np.random.default_rng(5)
    rsq = rng.uniform(9.0, 110.0, size=3000)   # both sides of cut^2 96.04
    tt = rng.integers(0, 4, size=rsq.shape)
    flat = j.tables.reshape(4, -1)
    jcoef = {n: jnp.asarray(flat[tt, c])
             for c, n in enumerate(jstyles.COEF_NAMES)}
    tcoef = {n: torch.as_tensor(flat[tt, c])
             for c, n in enumerate(tstyles.COEF_NAMES)}
    f_lj = rng.choice([0.0, 0.5, 1.0], size=rsq.shape) if special else 1.0
    jf, je, _ = jstyles.pair_terms(
        j, jnp.asarray(rsq), jcoef, 0.0, 0.0,
        jnp.asarray(f_lj) if special else 1.0, 1.0, eflag=True)
    tf, te, _ = tstyles.pair_terms(
        t, torch.as_tensor(rsq), tcoef, 0.0, 0.0,
        torch.as_tensor(f_lj) if special else 1.0, 1.0, eflag=True)
    for a, b in ((jf, tf), (je, te)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max())


def _cutout_cfg(tmp_path, nx=4, ny=4, nz=4, cut=5.0, skin=1.0):
    """hexane_gen.yaml on an nx x ny x nz lattice of chains, at a cutoff
    the cell engine takes on that box (three cells of cut + skin an axis),
    in f64: the hexane path at test size."""
    data = str(tmp_path / "data.hexane_cut")
    gen_hexane.write(data, nx, ny, nz)
    with open(os.path.join(DECKS, "hexane_gen.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(read_data=data, precision="double")
    cfg["pair_style"]["cut"] = cut
    cfg["neighbor"]["skin"] = skin
    return cfg


@pytest.fixture(scope="module")
def cutout(tmp_path_factory):
    """The JAX engine of the hexane cut-out at step 0 (rigid, CellPPPMDisp)
    and its slot state in the port."""
    cfg = _cutout_cfg(tmp_path_factory.mktemp("hexane"))
    cfg["run"] = 0
    sim = jbuild(copy.deepcopy(cfg))
    planes = {k: np.asarray(v) for k, v in
              jax.device_get(sim.state._asdict()).items() if v is not None}
    g = sim.grid
    tgrid = tcs.CellGrid(nc=g.nc, cap=g.cap, n_atoms=g.n_atoms,
                         reach_z=g.reach_z)
    return cfg, sim, tgrid, slot_state_from_numpy(planes, device="cpu")


def _atoms(aid, n, planes):
    out = np.zeros((n + 1, len(planes)))
    out[np.minimum(np.asarray(aid), n)] = np.stack(
        [np.asarray(p) for p in planes], -1)
    return out[:n]


def test_cellpair_lj_long_exclusion_matches_jax(cutout):
    cfg, sim, tgrid, tst = cutout
    js = sim.pair
    t = pair_style_from_numpy(
        js.tables, js.special_lj, js.special_coul, js.qqrd2e, js.g_ewald,
        js.cutsq_max, dict(name=js.cfg.name, vdw=js.cfg.vdw,
                           coul=js.cfg.coul, disp=js.cfg.disp))
    t = t.replace(g_ewald_6=js.g_ewald_6)
    n = sim.n_atoms
    jmol = sim._slot_mol(sim.state)
    tmol = tcellpair.slot_mol_gather(
        torch.as_tensor(np.asarray(sim._excl_mol)), tst.aid, n)
    assert np.array_equal(tmol.numpy(), np.asarray(jmol))
    jr = jcellpair.compute_cellpair(
        js, sim.grid, sim.box, sim.state, eflag=True, vflag=True,
        acc_dtype=jnp.float64, slot_mol=jmol, newton=True)
    tr = tcellpair.compute_cellpair(
        t, tgrid, sim.box, tst, eflag=True, vflag=True,
        acc_dtype=torch.float64, slot_mol=tmol)
    aid = tst.aid.numpy()
    _close(_atoms(aid, n, (tr.fx, tr.fy, tr.fz)),
           _atoms(aid, n, (jr.fx, jr.fy, jr.fz)))
    _close(float(tr.evdwl), float(jr.evdwl))
    _close(tr.virial.numpy(), np.asarray(jr.virial))
    # the exclusion removes every intramolecular pair: 15 a chain
    full = tcellpair.compute_cellpair(t, tgrid, sim.box, tst, eflag=True,
                                      acc_dtype=torch.float64)
    assert float(full.evdwl) != float(tr.evdwl)


def test_cell_pppm_disp_matches_jax(cutout):
    cfg, sim, tgrid, tst = cutout
    pmd = _port_of(sim.kspace.pmd)
    typ = np.asarray(sim.state.typ)
    atom_typ = _atoms(tst.aid.numpy(), sim.n_atoms, (typ,))[:, 0].astype(int)
    kt = CellPPPMDisp(pmd, sim.n_atoms, atom_typ)
    jfx, jfy, jfz, je, jv = sim.kspace.compute_slots(sim.state, True, True)
    tfx, tfy, tfz, te, tv = kt.compute_slots(tst, True, True)
    aid = tst.aid.numpy()
    _close(_atoms(aid, sim.n_atoms, (tfx, tfy, tfz)),
           _atoms(aid, sim.n_atoms, (jfx, jfy, jfz)))
    _close(float(te), float(je))
    _close(tv.numpy(), np.asarray(jv))
    b = kt._slot_b(tst)
    want = sim.kspace.pmd.elong_const(float(b.sum()), float((b * b).sum()))
    assert abs(kt.elong_const - want) <= 1e-13 * abs(want)
    # without eflag / vflag: the same forces, elong and the virial zero
    ofx, _, _, oe, ov = kt.compute_slots(tst, False, False)
    assert torch.equal(ofx, tfx) and float(oe) == 0.0 and not ov.any()


@pytest.mark.parametrize("typed", [False, True])
def test_bound_kspace_matches_jax(typed):
    x, typ, j, t = _setups("arithmetic" if typed else "geometric")
    per_atom = typ if typed else (np.sqrt(4.0 * EPS) * SIG**3)[typ]
    jb, tb = JBound(j, per_atom, typed=typed), BoundKSpace(t, per_atom,
                                                          typed=typed)
    n = len(x)
    jr = jb.compute(jnp.asarray(x), None)
    tr = tb.compute(torch.as_tensor(x.T.copy()), None)
    _close(torch.stack(tr.f, -1).numpy(), jr.f)
    _close(float(tr.elong), float(jr.elong))
    _close(tr.virial.numpy(), jr.virial)
    # slot order: a permutation of the atoms with empty slots (aid = n)
    rng = np.random.default_rng(3)
    aid = np.concatenate([rng.permutation(n), [n, n, n]])
    xs = np.concatenate([x, np.full((3, 3), 1.0)])[
        np.concatenate([aid[:n], [n, n + 1, n + 2]])]
    jr = jb.compute_slot(jnp.asarray(xs), jnp.asarray(aid), None)
    tr = tb.compute_slot(torch.as_tensor(xs.T.copy()), torch.as_tensor(aid),
                         None)
    _close(torch.stack(tr.f, -1).numpy(), jr.f)
    _close(float(tr.elong), float(jr.elong))


def _deck(name):
    with open(os.path.join(DECKS, name)) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("change,match", [
    (lambda c: c.update(engine="nlist"), "13\\(c\\)"),
    (lambda c: c["kspace_style"].update(name="pppm"), "pppm/disp"),
    (lambda c: c["kspace_style"].update(diff="ad"), "item 10"),
    (lambda c: c["fixes"].append({"name": "nvt", "t_start": 300,
                                  "t_damp": 100}), "13\\(c\\)"),
    (lambda c: c.update(fixes=[{"name": "npt", "t_start": 300,
                                "t_damp": 100, "iso": [1.0, 1.0, 1000.0]}]),
     "K16d.*13\\(c\\)"),
])
def test_unported_dispersion_forms_raise(change, match):
    cfg = _deck("hexane_gen.yaml")
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    change(cfg)
    with pytest.raises(NotImplementedError, match=match):
        tbuild(cfg, device="cpu")


def _charge_chains(path):
    """Neutral charges on the chains of a gen_hexane data file: +0.2 on
    the CH3 ends (type 1), -0.1 on the CH2 atoms (type 2)."""
    with open(path) as f:
        lines = f.read().split("\n")
    start = lines.index("Atoms # full") + 2
    for i in range(start, len(lines)):
        cols = lines[i].split()
        if len(cols) < 7:
            break
        cols[3] = "0.2" if cols[2] == "1" else "-0.1"
        lines[i] = " ".join(cols)
    with open(path, "w") as f:
        f.write("\n".join(lines))


@pytest.mark.parametrize("form", ["mix arithmetic", "coul long"])
def test_formerly_unported_dispersion_forms_run(form, tmp_path):
    """mix arithmetic (seven channels) and lj/long/coul/long with its
    Coulomb term (``coul`` dropped from the deck; the chains charged):
    the port builds them as the JAX package does and gives its rows
    within 1e-9 on the cut-out over 3 steps."""
    cfg = _cutout_cfg(tmp_path)
    if form == "mix arithmetic":
        cfg["kspace_style"]["mix"] = "arithmetic"
    else:
        cfg["pair_style"].pop("coul")
        _charge_chains(cfg["read_data"])
    jsim = jbuild(copy.deepcopy(cfg))
    tsim = tbuild(copy.deepcopy(cfg), device="cpu")
    assert type(tsim.kspace).__name__ == type(jsim.kspace).__name__ == (
        "BoundKSpace" if form == "mix arithmetic" else "CombinedKSpace")
    jrows = jsim.run(3, thermo_every=1, log=False)
    trows = tsim.run(3, thermo_every=1, log=False)
    for jr, tr in zip(jrows, trows):
        for k in ("temp", "evdwl", "ecoul", "elong", "etotal", "press"):
            assert abs(tr[k] - jr[k]) <= 1e-9 * max(abs(jr[k]), 1.0), (
                tr["step"], k, tr[k], jr[k])
    if form == "coul long":
        assert abs(trows[0]["ecoul"]) > 1.0


def test_generated_decks_are_the_reference_lines():
    ref = _deck("hexane.yaml")
    for name, extra in (("hexane_gen.yaml", {}),
                        ("hexane_gen_big.yaml", {"replicate": [2, 4, 4]})):
        cfg = _deck(name)
        assert cfg.pop("read_data") == "examples/data.hexane_gen"
        assert cfg == dict({k: v for k, v in ref.items()
                            if k != "read_data"}, **extra), name
        with open(os.path.join(DECKS, name)) as f:
            first = f.readline()
        assert "in.hexane" in first and "equilibrated_data.hexane" in first
