"""Rigid bodies (``fix rigid/small``, K15) of the port against the JAX
package (CPU, f64), and the hexane path as a whole.

(a) ``make_rigid_bodies`` on tests/test_rigid.py's asymmetric 4-atom body
    and its lattice of rigid triatomic ions (``_rigid_melt``): every field
    within 1e-12 (the body frames, masses, inverse moments and removed
    degrees of freedom); ``interop.rigid_from_numpy`` carries them over.
(b) The body functions on the same bodies with seeded forces and
    velocities: ``init_body_state``, ``atom_positions``,
    ``atom_velocities``, ``force_torque``, ``richardson``,
    ``initial_`` / ``final_integrate_rigid``, ``constraint_virial``,
    ``rotational_ke`` and ``body_state_from_atoms`` within 1e-12.
(c) The slot-order plain versions of the kernels K15a-c
    (``slot_force_torque_plain``, ``rigid_update_plain``,
    ``slot_constraint_virial_plain``) against the atom-order functions on
    a shuffled slot layout with empty slots: to 1e-13.
(d) hexane_gen.yaml on a 4 x 4 x 4 lattice of chains (384 atoms, cut
    5.0, skin 1.0, f64: a box the cell engine takes) through
    ``run.build_simulation`` in both packages: rigid bodies +
    ``CellPPPMDisp`` + lj/long with same-molecule exclusion, 10 steps,
    every thermo row within 1e-9 relative and the positions within 1e-9
    of the box length.
(e) Rigid with SHAKE raises (as in the JAX package), rigid under fix nvt
    and on the list engine raise naming ROADMAP queue 1 item 13(c).
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

from lammps_buck_intel_tpu.integrate import rigid as jr
from lammps_buck_intel_tpu.run import build_simulation as jbuild
from lammps_buck_intel_tpu_torch.integrate import rigid as tr
from lammps_buck_intel_tpu_torch.interop import rigid_from_numpy
from lammps_buck_intel_tpu_torch.run import build_simulation as tbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = os.path.join(ROOT, "examples", "decks")
sys.path.insert(0, os.path.join(ROOT, "examples"))
import gen_hexane  # noqa: E402

ROW_KEYS = ("temp", "evdwl", "ecoul", "elong", "epair", "ke", "etotal",
            "press")
FTM2V = 1.0 / 48.88821291 ** 2


def _asym_body():
    """tests/test_rigid.py's one 4-atom asymmetric body."""
    x = np.array([[0.0, 0, 0], [1.5, 0, 0], [0, 1.0, 0], [0, 0, 0.6]]) + 5.0
    return x, np.zeros(4, np.int32), np.array([1.0, 2.0, 3.0, 4.0]), 20.0


def _rigid_melt(n_side=3):
    """tests/test_rigid.py's lattice of rigid triatomic ions."""
    base = np.array([[0.0, 0, 0], [1.0, 0, 0], [0, 1.2, 0]])
    rng = np.random.default_rng(11)
    xs, mols, m = [], [], 0
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                org = np.array([2.0 + 4.0 * i, 2.0 + 4.0 * j, 2.0 + 4.0 * k])
                xs.append(base + org + rng.uniform(-0.05, 0.05, 3))
                mols += [m] * 3
                m += 1
    typ = np.tile(np.array([0, 1, 1]), m)
    return (np.concatenate(xs), np.asarray(mols, np.int32),
            np.array([16.0, 1.0])[typ], 4.0 * n_side)


@pytest.fixture(params=["asym", "melt"])
def bodies(request):
    x, mol, mass, L = _asym_body() if request.param == "asym" \
        else _rigid_melt()
    jrb = jr.make_rigid_bodies(x, mol, mass, [L] * 3)
    trb = tr.make_rigid_bodies(x, mol, mass, [L] * 3)
    return x, jrb, trb, L


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rtol * scale, (
        float(np.abs(a - b).max()), scale)


def test_make_rigid_bodies_matches_jax(bodies):
    _, jrb, trb, _ = bodies
    assert trb.nbody == jrb.nbody
    assert trb.n_constraints == jrb.n_constraints
    assert np.array_equal(trb.body_of, jrb.body_of)
    for name in ("mtotal", "minv", "iinv", "r_body", "mass_per_atom", "X0",
                 "q0"):
        _close(getattr(trb, name), getattr(jrb, name))
    carried, _ = rigid_from_numpy(
        jrb.body_of, jrb.nbody, jrb.mtotal, jrb.minv, jrb.iinv, jrb.r_body,
        jrb.mass_per_atom, jrb.X0, jrb.q0, jrb.n_constraints)
    for name in ("r_body", "q0", "iinv"):
        assert np.array_equal(getattr(carried, name), getattr(jrb, name))


def test_body_functions_match_jax(bodies):
    x, jrb, trb, L = bodies
    n = len(x)
    rng = np.random.default_rng(17)
    v = rng.normal(scale=0.3, size=(n, 3))
    f = rng.normal(size=(n, 3))
    jbs = jr.init_body_state(jrb, v)
    tbs = tr.init_body_state(trb, v)
    for a, b in zip(tbs, jbs):
        _close(a.numpy(), b)
    # give the bodies an angular momentum the build's projection may lack
    jbs = jbs._replace(L=jbs.L + jnp.asarray([0.3, -0.7, 0.2]))
    tbs = tbs._replace(L=tbs.L + torch.tensor([0.3, -0.7, 0.2],
                                              dtype=torch.float64))
    jxa, jd = jr.atom_positions(jrb, jbs)
    txa, td = tr.atom_positions(trb, tbs)
    _close(txa.numpy(), jxa)
    _close(td.numpy(), jd)
    _close(tr.atom_velocities(trb, tbs, td).numpy(),
           jr.atom_velocities(jrb, jbs, jd))
    ft = torch.as_tensor(f)
    for a, b in zip(tr.force_torque(trb, td, ft),
                    jr.force_torque(jrb, jd, jnp.asarray(f))):
        _close(a.numpy(), b)
    _close(tr.richardson(trb, tbs.q, tbs.L, 0.05).numpy(),
           jr.richardson(jrb, jbs.q, jbs.L, 0.05))
    ji = jr.initial_integrate_rigid(jrb, jbs, jnp.asarray(f), jd, 0.05,
                                    0.025)
    ti = tr.initial_integrate_rigid(trb, tbs, ft, td, 0.05, 0.025)
    for a, b in zip(ti, ji):
        _close(a.numpy(), b)
    jf = jr.final_integrate_rigid(jrb, ji, jnp.asarray(f), jd, 0.025)
    tf = tr.final_integrate_rigid(trb, ti, ft, td, 0.025)
    for a, b in zip(tf, jf):
        _close(a.numpy(), b)
    _close(tr.constraint_virial(trb, tf, td, ft, FTM2V).numpy(),
           jr.constraint_virial(jrb, jf, jd, jnp.asarray(f), FTM2V))
    _close(float(tr.rotational_ke(trb, tf, 2.0)),
           float(jr.rotational_ke(jrb, jf, 2.0)))
    xa, _ = jr.atom_positions(jrb, jf)
    va = jr.atom_velocities(jrb, jf, jr.atom_positions(jrb, jf)[1])
    for a, b in zip(tr.body_state_from_atoms(trb, np.asarray(xa),
                                             np.asarray(va), [L] * 3),
                    jr.body_state_from_atoms(jrb, np.asarray(xa),
                                             np.asarray(va), [L] * 3)):
        _close(a.numpy(), b, 1e-10)


def test_slot_twins_match_atom_order(bodies):
    """K15a-c's plain versions read and write slot planes through the atom
    -> slot map; on a shuffled layout with empty slots they equal the
    atom-order functions."""
    x, _, trb, _ = bodies
    n = len(x)
    rng = np.random.default_rng(23)
    ns = n + 5
    slot_of = torch.as_tensor(rng.permutation(ns)[:n])
    inv = torch.cat([slot_of, torch.tensor([ns - 1])]).to(torch.int32)
    t = trb.tables_on("cpu", torch.float64)
    bs = tr.init_body_state(trb, rng.normal(scale=0.3, size=(n, 3)))
    bs = bs._replace(L=bs.L + torch.tensor([0.3, -0.7, 0.2],
                                           dtype=torch.float64))
    _, d = tr.atom_positions(trb, bs)
    fa_atoms = torch.as_tensor(rng.normal(size=(n, 3)))
    fb_atoms = torch.as_tensor(rng.normal(size=(n, 3)))

    def planes(atoms, fill=7.0):
        out = [torch.full((ns,), fill, dtype=torch.float64) for _ in range(3)]
        for a in range(3):
            out[a][slot_of] = atoms[:, a]
        return tuple(out)

    fa, fb = planes(fa_atoms), planes(fb_atoms)
    f_out = planes(torch.zeros((n, 3), dtype=torch.float64))
    F, T = tr.slot_force_torque_plain(t, d, inv, fa, fb, f_out)
    F0, T0 = tr.force_torque(trb, d, fa_atoms + fb_atoms)
    _close(F.numpy(), F0.numpy(), 1e-13)
    _close(T.numpy(), T0.numpy(), 1e-13)
    assert torch.equal(torch.stack([p[slot_of] for p in f_out], -1),
                       fa_atoms + fb_atoms)
    _close(tr.slot_constraint_virial_plain(t, bs, d, inv, fa, fb, T, FTM2V,
                                           torch.float64).numpy(),
           tr.constraint_virial(trb, bs, d, fa_atoms + fb_atoms,
                                FTM2V).numpy(), 1e-13)
    # offsets, then the initial and final updates
    xa0, _ = tr.atom_positions(trb, bs)
    shift = torch.as_tensor(rng.integers(-1, 2, size=(n, 3)) * 12.0)
    xs = planes(xa0 + shift)
    off = tuple(torch.zeros(ns, dtype=torch.float64) for _ in range(3))
    bs1, d1 = bs.clone(), d.clone()
    tr.rigid_update_plain(t, bs1, d1, inv, xs, off, None, None, 0.0, 0.0,
                          tr.MODE_OFFSETS)
    _close(torch.stack([o[slot_of] for o in off], -1).numpy(),
           shift.numpy(), 1e-13)
    tr.rigid_update_plain(t, bs1, d1, inv, xs, off, F, T, 0.05, 0.025,
                          tr.MODE_INITIAL)
    ref = tr.initial_integrate_rigid_ft(trb, bs, F, T, 0.05, 0.025)
    for a, b in zip(bs1, ref):
        _close(a.numpy(), b.numpy(), 1e-13)
    xa1, dref = tr.atom_positions(trb, ref)
    _close(d1.numpy(), dref.numpy(), 1e-13)
    _close(torch.stack([p[slot_of] for p in xs], -1).numpy(),
           (xa1 + shift).numpy(), 1e-13)
    vs = planes(torch.zeros((n, 3), dtype=torch.float64))
    tr.rigid_update_plain(t, bs1, d1, inv, vs, None, F, T, 0.05, 0.025,
                          tr.MODE_FINAL)
    ref = tr.final_integrate_rigid_ft(trb, ref, F, T, 0.025)
    for a, b in zip(bs1, ref):
        _close(a.numpy(), b.numpy(), 1e-13)
    _close(torch.stack([p[slot_of] for p in vs], -1).numpy(),
           tr.atom_velocities(trb, ref, dref).numpy(), 1e-13)


def _cutout_cfg(tmp_path):
    data = str(tmp_path / "data.hexane_cut")
    gen_hexane.write(data, 4, 4, 4)
    with open(os.path.join(DECKS, "hexane_gen.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(read_data=data, precision="double")
    cfg["pair_style"]["cut"] = 5.0
    cfg["neighbor"]["skin"] = 1.0
    return cfg


def test_hexane_shrunk_simulation_matches_jax(tmp_path):
    cfg = _cutout_cfg(tmp_path)
    js = jbuild(copy.deepcopy(cfg))
    ts = tbuild(copy.deepcopy(cfg), device="cpu")
    assert ts.grid.nc == js.grid.nc and ts.grid.cap == js.grid.cap
    assert ts.kspace.pmd.grid == js.kspace.pmd.grid
    assert ts.dof == 3 * ts.n_atoms - 3 - js.rigid.n_constraints
    jrows = js.run(10, thermo_every=5, log=False)
    trows = ts.run(10, thermo_every=5, log=False)
    assert [r["step"] for r in trows] == [0, 5, 10]
    for a, b in zip(trows, jrows):
        for k in ROW_KEYS:
            assert abs(a[k] - b[k]) <= 1e-9 * max(abs(b[k]), 1.0), (
                a["step"], k, a[k], b[k])
    assert trows[0]["elong"] < 0.0 and trows[0]["evdwl"] != 0.0
    ja, ta = js.get_atoms(), ts.get_atoms()
    L = float(np.max(np.asarray(js.box.lengths)))
    assert np.abs(np.asarray(ja["x"]) - ta["x"]).max() <= 1e-9 * L
    for a, b in zip(ts.body, jax.device_get(js.body)):
        _close(a.numpy(), b, 1e-9)


def test_bound_kspace_on_the_cell_engine(tmp_path):
    """The cell engine's compute_slot route: BoundKSpace over the
    CellPPPMDisp's own mesh, B gathered per slot through the atom ids,
    gives the CellPPPMDisp forces, elong and virial (1e-12)."""
    from lammps_buck_intel_tpu_torch.models.kspace import BoundKSpace

    sim = tbuild(_cutout_cfg(tmp_path), device="cpu")
    st = sim.state
    mol = sim._slot_mol(st)
    cell = sim._forces(st, True, True, mol)
    typ = sim.get_atoms()["typ"].astype(int)
    pmd = sim.kspace.pmd
    sim.kspace = BoundKSpace(pmd, np.asarray(pmd.B)[typ])
    bound = sim._forces(st, True, True, mol)
    for a, b in ((torch.stack(bound[1]), torch.stack(cell[1])),
                 (bound[4], cell[4]), (bound[5], cell[5])):
        _close(a.numpy(), b.numpy())


def test_rigid_refusals(tmp_path):
    cfg = _cutout_cfg(tmp_path)
    nvt = copy.deepcopy(cfg)
    nvt["fixes"].append({"name": "nvt", "t_start": 300.0, "t_damp": 100.0})
    with pytest.raises(NotImplementedError, match="13\\(c\\)"):
        tbuild(nvt, device="cpu")
    nl = copy.deepcopy(cfg)
    nl["engine"] = "nlist"
    with pytest.raises(NotImplementedError, match="13\\(c\\)"):
        tbuild(nl, device="cpu")
    from lammps_buck_intel_tpu_torch.integrate import CellPairSimulation
    with pytest.raises(ValueError, match="exclusive"):
        CellPairSimulation(None, None, rigid=object(), shake=object())
    # molecule ids are needed: a lattice deck has none
    with open(os.path.join(DECKS, "buck.yaml")) as f:
        lat = yaml.safe_load(f)
    lat["lattice"].update(nx=6, ny=6, nz=6)
    lat["exclude_intra"] = True
    with pytest.raises(ValueError, match="molecule ids"):
        tbuild(lat, device="cpu")
