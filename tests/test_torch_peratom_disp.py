"""Per-atom dispersion k-space of the port (compute pe/atom and stress/atom
on pppm/disp decks; the slot-order per-atom PPPM) against the JAX package
(CPU, f64 through the plain versions).

(a) ``PPPMDisp.compute_peratom`` against the JAX ``compute_peratom`` on
    24 atoms in a 7 A box (the ``_disp_system`` shape of
    tests/test_pppm_disp.py, 24^3 mesh, order 5) with the geometric,
    arithmetic and no-mix channels: eatom and vatom within 1e-10 of their
    largest value; their sums pin to the port's own elong and virial
    within 1e-10 (the dispersion solve's half-spectrum sums agree with
    the irfftn at the Nyquist planes of this even mesh).
(b) ``BoundKSpace`` (typed and per-atom) and ``CombinedKSpace`` through
    ``computes._kspace_peratom``: tests/test_torch_peratom.py
    ``test_dispersion_kspace_raises``, with this file's system.
(c) The slot forms (K18 slots): ``CellPPPM.compute_peratom_slots`` and
    ``CellPPPMDisp.compute_peratom_slots`` against the JAX
    ``compute_peratom_slots`` on the same slot planes, in atom order,
    within 1e-9; 0 on empty slots; sums pinned to the solver's own
    ``compute_slots`` elong and virial (1e-10, 1e-9).
(d) The record tests/goldens/torch_peratom_disp.json
    (tools/record_peratom.py disp; examples/peratom_cases.py DISP_CASES:
    cristobalite_buck_long.yaml on a jittered copy, hexane_gen.yaml and
    hexane_gen_arith.yaml on a 4x4x4 cut-out): the f64 functions within
    1e-9 of the record, ``pe_atom`` / ``stress_atom`` within (2e-5 of the
    sums, 1e-4 of the sampled atoms) of the JAX computes, and the
    dispersion solver's per-atom sums pinned to its global elong and
    virial within 1e-10.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.models.kspace import CellPPPM as JCellPPPM
from lammps_buck_intel_tpu.models.kspace import setup_pppm as jsetup_pppm
from lammps_buck_intel_tpu.models.kspace.pppm_cells import (
    CellPPPMDisp as JCellPPPMDisp)
from lammps_buck_intel_tpu.models.kspace.pppm_disp import (
    setup_pppm_disp as jsetup_disp)
from lammps_buck_intel_tpu.neighbor import cell_slots as jcs
from lammps_buck_intel_tpu_torch import computes
from lammps_buck_intel_tpu_torch.core import make_box
from lammps_buck_intel_tpu_torch.interop import (pppm_from_numpy,
                                                 slot_state_from_numpy)
from lammps_buck_intel_tpu_torch.models.kspace import (BoundKSpace,
                                                       CellPPPM,
                                                       CellPPPMDisp,
                                                       setup_pppm_disp)
from lammps_buck_intel_tpu_torch.run import build_simulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import peratom_cases as rec  # noqa: E402

with open(os.path.join(ROOT, "tests", "goldens",
                       "torch_peratom_disp.json")) as f:
    GOLDEN = json.load(f)
F64 = 1e-10
EPS = np.array([0.30, 0.18])
SIG = np.array([1.10, 1.25])
B = np.sqrt(4.0 * EPS) * SIG**3
# a two-type C6 with one negative eigenvalue: the no-mix split gives two
# signed channels, as BKS's does
C6 = np.array([[0.6, 1.3], [1.3, 0.9]])


def _disp_system(seed=8, n=24, L=7.0):
    """n atoms at least 1.1 A apart (minimum image) in an L box, two
    types."""
    rng = np.random.RandomState(seed)
    x = []
    while len(x) < n:
        p = rng.uniform(0, L, 3)
        if all(np.sum((d - L * np.round(d / L)) ** 2) > 1.2
               for d in (p - xx for xx in x)):
            x.append(p)
    return np.asarray(x), rng.randint(0, 2, n).astype(np.int32), L


def _solvers(mix, x, typ, L, grid=(24, 24, 24)):
    """The JAX and the port's PPPMDisp of one set-up."""
    kw = dict(cutoff=3.0, tol_real=1e-5, grid=grid, mix=mix)
    if mix == "arithmetic":
        kw.update(epsilon=EPS, sigma=SIG)
    elif mix == "none":
        kw.update(C6=C6)
    jpm = jsetup_disp(jmake_box([0, 0, 0], [L] * 3), B, typ,
                      acc_dtype=jnp.float64, **kw)
    tpm = setup_pppm_disp(make_box([0, 0, 0], [L] * 3), B, typ,
                          acc_dtype=torch.float64, **kw)
    return jpm, tpm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


@pytest.mark.parametrize("mix", ["geometric", "arithmetic", "none"])
def test_compute_peratom_matches_jax(mix):
    x, typ, L = _disp_system()
    jpm, tpm = _solvers(mix, x, typ, L)
    xt = torch.as_tensor(x.T.copy())
    if mix == "geometric":
        je, jv = jpm.compute_peratom(jnp.asarray(x),
                                     b_per_atom=jnp.asarray(B[typ]))
        te, tv = tpm.compute_peratom(xt, b_per_atom=torch.as_tensor(B[typ]))
        glob = tpm.compute(xt, torch.as_tensor(B[typ]))
    else:
        je, jv = jpm.compute_peratom(jnp.asarray(x), typ=jnp.asarray(typ))
        te, tv = tpm.compute_peratom(xt, typ=torch.as_tensor(typ))
        glob = tpm.compute_channels(
            xt, torch.as_tensor(tpm.A)[:, torch.as_tensor(typ).long()])
    assert te.dtype == torch.float64 and tv.shape == (len(x), 6)
    assert _rel(te, je) <= F64 and _rel(tv, jv) <= F64
    # the pins: the shares sum to the port's own elong and virial
    assert abs(float(te.sum() - glob.elong)) <= F64 * abs(float(glob.elong))
    vg = glob.virial.numpy()
    assert np.abs(tv.sum(0).numpy() - vg).max() <= F64 * np.abs(vg).max()


L_SLOT, N_SLOT, CUT_SLOT = 12.0, 400, 4.0


def _slot_planes(x, q, typ, L):
    n = len(x)
    box = jmake_box([0, 0, 0], [L] * 3)
    grid = jcs.make_grid(n, [L] * 3, CUT_SLOT)
    st = jcs.from_atoms(grid, box, x, np.zeros_like(x),
                        np.zeros((n, 3), np.int32), typ, q,
                        dtype=jnp.float64)
    planes = {k: np.asarray(v) for k, v in
              jax.device_get(st._asdict()).items() if v is not None}
    return box, grid, st, slot_state_from_numpy(planes, device="cpu")


def _to_atoms(aid, vals, n):
    out = np.zeros((n + 1,) + vals.shape[1:])
    out[np.minimum(aid, n)] = vals
    return out[:n]


def _check_slots(je, jv, te, tv, aid, n, rtol):
    empty = aid >= n
    assert (te.numpy()[empty] == 0).all() and (tv.numpy()[empty] == 0).all()
    for a, b in ((te, je), (tv, jv)):
        assert _rel(_to_atoms(aid, a.numpy(), n),
                    _to_atoms(aid, np.asarray(b), n)) <= rtol


def test_peratom_slots_matches_jax():
    """K18 slots, Coulomb: the 400-charge system of
    tests/test_pppm_cells.py:144-155."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0, L_SLOT, (N_SLOT, 3))
    q = rng.uniform(-1, 1, N_SLOT)
    q -= q.mean()
    box, grid, jst, tst = _slot_planes(x, q, np.zeros(N_SLOT, np.int32),
                                       L_SLOT)
    pm = jsetup_pppm(box, q, cutoff=CUT_SLOT, accuracy_rel=1e-5, qqrd2e=1.0,
                     multiple_of=grid.nc, acc_dtype=jnp.float64)
    tpm = pppm_from_numpy(pm.grid, pm.g_ewald, pm.order, pm.greensfn, pm.kx,
                          pm.ky, pm.kz, pm.qsum, pm.qsqsum, pm.qqrd2e,
                          pm.volume, pm.box_lo, pm.h)
    jcp, tcp = JCellPPPM(pm, grid), CellPPPM(tpm, N_SLOT)
    je, jv = jcp.compute_peratom_slots(jst)
    te, tv = tcp.compute_peratom_slots(tst)
    aid = tst.aid.numpy()
    _check_slots(je, jv, te, tv, aid, N_SLOT, 1e-9)
    # the pins against the solver's own half-spectrum sums
    _, _, _, el, vir = tcp.compute_slots(tst, True, True)
    assert abs(float(te.sum() - el)) <= 1e-10 * abs(float(el))
    vg = vir.numpy()
    assert np.abs(tv.sum(0).numpy() - vg).max() <= 1e-9 * np.abs(vg).max()


def test_disp_peratom_slots_matches_jax():
    """K18 slots, geometric dispersion: the 300-atom system of
    tests/test_pppm_cells.py:255-281."""
    rng = np.random.RandomState(11)
    n = 300
    x = rng.uniform(0, L_SLOT, (n, 3))
    typ = rng.randint(0, 2, n).astype(np.int32)
    Bt = np.array([1.3, 0.7])
    box, grid, jst, tst = _slot_planes(x, np.zeros(n), typ, L_SLOT)
    jpmd = jsetup_disp(box, Bt, typ, cutoff=CUT_SLOT, multiple_of=grid.nc,
                       acc_dtype=jnp.float64)
    tpmd = setup_pppm_disp(make_box([0, 0, 0], [L_SLOT] * 3), Bt, typ,
                           cutoff=CUT_SLOT, multiple_of=grid.nc,
                           acc_dtype=torch.float64)
    assert tpmd.grid == jpmd.grid
    je, jv = JCellPPPMDisp(jpmd, grid).compute_peratom_slots(jst)
    tcp = CellPPPMDisp(tpmd, n, typ)
    te, tv = tcp.compute_peratom_slots(tst)
    aid = tst.aid.numpy()
    _check_slots(je, jv, te, tv, aid, n, 1e-9)
    _, _, _, el, vir = tcp.compute_slots(tst, True, True)
    assert abs(float(te.sum() - el)) <= 1e-10 * abs(float(el))
    vg = vir.numpy()
    assert np.abs(tv.sum(0).numpy() - vg).max() <= 1e-9 * np.abs(vg).max()
    # and the atom-order function on the same atoms
    ae, av = tpmd.compute_peratom(torch.as_tensor(x.T.copy()),
                                  b_per_atom=torch.as_tensor(Bt[typ]))
    assert _rel(_to_atoms(aid, te.numpy(), n), ae) <= 1e-9
    assert _rel(_to_atoms(aid, tv.numpy(), n), av) <= 1e-9


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("peratom_disp")
    jpath, hpath = str(tmp / "data.cris_jitter"), str(tmp / "data.hexane")
    rec.write_jitter(jpath)
    rec.write_hexane_cut(hpath)
    built = {}

    def get(name):
        if name not in built:
            sim = build_simulation(rec.case_config(name, jpath, hpath),
                                   device="cpu")
            built[name] = (sim, sim.thermo())
        return built[name]

    return get


def _close(name, a, ref):
    a = np.asarray(a, np.float64)
    idx = np.asarray(GOLDEN[name]["sample"])
    return (_rel(a.sum(0), ref["sum"]), _rel(a[idx], ref["sample"]))


def _disp_solver(ks):
    return [s for s in computes._solvers(ks)
            if isinstance(s, (BoundKSpace, CellPPPMDisp))][0]


@pytest.mark.parametrize("name", tuple(rec.DISP_CASES))
def test_record_functions_and_computes(name, sims):
    sim, row = sims(name)
    g = GOLDEN[name]
    assert sim.n_atoms == g["n_atoms"] and type(sim).__name__ == g["engine"]
    assert type(sim.kspace).__name__ == g["kspace"]
    at = sim.atoms_on_device()
    x = at["x"].to(torch.float64)
    # the f64 functions: pair, the k-space sum (the Coulomb PPPM in the
    # JAX half-spectrum convention) and the dispersion solver alone
    pair = computes._pair_peratom(sim, at, torch.float64)
    ks = computes._kspace_peratom(sim, at, torch.float64, False)
    ds = _disp_solver(sim.kspace)
    if isinstance(ds, CellPPPMDisp):
        disp = ds.compute_peratom(x, at["typ"])
        glob = ds.pmd.compute(x, torch.as_tensor(
            np.asarray(ds.pmd.B, np.float64))[at["typ"].long()])
    else:
        disp = ds.compute_peratom(x)
        glob = ds.solver.compute_channels(
            x, torch.as_tensor(ds.solver.A)[:, at["typ"].long()])
    got = dict(pair_e=pair[0], pair_v=pair[1], kspace_e=ks[0],
               kspace_v=ks[1], disp_e=disp[0], disp_v=disp[1])
    for key, a in got.items():
        es, ep = _close(name, a.numpy(), g["f64"][key])
        assert es <= 1e-9 and ep <= 1e-9, (key, es, ep)
    # the pins of the dispersion solver
    assert abs(float(disp[0].sum() - glob.elong)) <= F64 * abs(
        float(glob.elong))
    vg = glob.virial.numpy()
    assert np.abs(disp[1].sum(0).numpy() - vg).max() <= \
        F64 * np.abs(vg).max()
    # the computes against the JAX computes and the thermo row
    cache = {}
    pe = computes.pe_atom(sim, cache=cache)
    st = computes.stress_atom(sim, cache=cache)
    st_jax = rec.half_spectrum_stress(sim, st, cache)
    for a, key in ((pe, "pe"), (st_jax, "stress")):
        es, ep = _close(name, a.numpy(), g[key])
        assert es <= 2e-5 and ep <= 1e-4, (key, es, ep)
    total = row["epair"] + row["emol"]
    assert abs(float(pe.sum()) - total) <= 2e-5 * abs(total)
    if name.startswith("silica"):
        vol = float(np.prod(np.asarray(sim.box.lengths)))
        press = -float(st[:, :3].sum()) / (3.0 * vol)
        assert abs(press - row["press"]) <= 2e-4 * max(abs(row["press"]),
                                                        1.0)
