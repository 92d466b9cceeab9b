"""SHAKE/RATTLE of the port against the JAX package (CPU, f64).

(a) ``make_shake`` (m, b and a selections) and ``make_clusters`` give the
    JAX package's arrays exactly, on examples/data.rhodo_class and on
    synthetic water.
(b) The plain solves on slot planes with empty slots (C = 1 C-H bonds,
    C = 3 waters, the C = 12 octahedron, and all three mixed) against
    ``shake_positions_clustered``, ``rattle_velocities_clustered``,
    ``shake_virial_clustered`` and, where one Jacobi sweep is exact
    (C = 1), the scatter-form ``shake_virial``: rel 1e-12.  Constraints
    hold to 1e-9 after a large displacement and r . dv = 0 after RATTLE
    (the checks of tests/test_shake.py).
(c) The literal decks rhodo_class.yaml (NVT + shake) and rhodo_nve.yaml
    (NVE + shake) on one copy of the data file (1,728 atoms), 10 steps in
    double through ``build_simulation(device="cpu")``: thermo rows rel
    1e-10, unwrapped positions 1e-10 A, the chain 1e-10.
(d) Under NVT + shake the chain's second half step reads the kinetic
    energy of the velocities RATTLE left, not the kick's.
(e) Temperature counts 3N - 3 - Nc degrees of freedom; the set-up settle
    puts the data file's C-H bonds on their 1.09 A.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lammps_buck_intel_tpu.integrate import shake as jshake
from lammps_buck_intel_tpu_torch import interop
from lammps_buck_intel_tpu_torch.integrate import cellpair_verlet
from lammps_buck_intel_tpu_torch.integrate import nve
from lammps_buck_intel_tpu_torch.integrate import shake as tshake
from lammps_buck_intel_tpu_torch.io import read_data
from lammps_buck_intel_tpu_torch.run import build_simulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = os.path.join(ROOT, "examples", "decks")
DATA = os.path.join(ROOT, "examples", "data.rhodo_class")
BOND_COEFFS = np.array([[300.0, 1.53], [340.0, 1.09]])
ANGLE_COEFFS = np.array([[40.0, 117.0, 5.0, 2.64], [20.0, 105.0, 0.0, 0.0]])


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)


# ---- (a) host set-up ----

def _water(copies=5):
    """Water molecules: O-H bonds type 0 (r0 1.0), H-O-H angle type 0
    (109.47 degrees), masses O 15.9994 and H 1.008."""
    bonds, angles = [], []
    for w in range(copies):
        o = 3 * w
        bonds += [(0, o, o + 1), (0, o, o + 2)]
        angles += [(0, o + 1, o, o + 2)]
    mass = np.tile([15.9994, 1.008, 1.008], copies)
    return (np.asarray(bonds, np.int32), np.array([[450.0, 1.0]]),
            np.asarray(angles, np.int32), np.array([[55.0, 109.47]]), mass)


def _rhodo_topology():
    d = read_data(DATA)
    return d.bonds, BOND_COEFFS, d.angles, ANGLE_COEFFS, d.mass[d.type]


@pytest.mark.parametrize("system,b,a", [
    ("rhodo", (1,), ()), ("rhodo", (0, 1), ()), ("rhodo", (0, 1), (0, 1)),
    ("water", (0,), (0,))])
def test_make_shake_and_clusters_match_jax(system, b, a):
    topo = _rhodo_topology() if system == "rhodo" else _water()
    js = jshake.make_shake(*topo, bond_types=b, angle_types=a, iters=30)
    ts = tshake.make_shake(*topo, bond_types=b, angle_types=a, iters=30)
    for k in ("pairs", "d2", "invm"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k))
    assert ts.n_constraints == js.n_constraints and ts.iters == 30
    jc, tc = jshake.make_clusters(js), tshake.make_clusters(ts)
    for k in ("atoms", "pi", "pj", "d2", "cmask", "amask", "w_upd",
              "invm_sum", "corig"):
        np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k))
    # the K coupling and WT update tables are the JAX package's, rounded
    # once from f64
    t = tc.tables_on("cpu", torch.float64)
    _, WT, _, _, _, _, K = jshake._lanes_last(jc)
    np.testing.assert_array_equal(t["K"].numpy(), K)
    np.testing.assert_array_equal(t["WT"].numpy(), WT)
    moved = interop.shake_from_numpy(js.pairs, js.d2, js.invm, js.iters,
                                     js.n_independent)
    np.testing.assert_array_equal(moved.pairs, js.pairs)
    assert moved.n_constraints == js.n_constraints
    if system == "rhodo" and b == (1,):
        # fix shake m 1.0: 864 C-H bonds, one per cluster
        assert len(ts.pairs) == 864 and tc.width == 1


def test_rigid_constraints_name_their_item():
    with pytest.raises(NotImplementedError, match="item 13"):
        tshake.make_rigid_from_molecules(np.zeros((2, 3)), np.zeros(2),
                                         np.ones(2), np.ones(3))


# ---- (b) the plain solves ----

def _molecule(kind):
    if kind == "ch":
        return (np.array([[0.0, 0, 0], [1.09, 0, 0]]), [(0, 1)],
                [12.011, 1.008])
    if kind == "water":
        return (np.array([[0.0, 0, 0], [0.96, 0.3, 0], [-0.3, 0.96, 0]]),
                [(0, 1), (0, 2), (1, 2)], [15.999, 1.008, 1.008])
    oct6 = np.array([[1.0, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                     [0, 0, 1], [0, 0, -1]])
    edges = [(i, j) for i in range(6) for j in range(i + 1, 6)
             if abs((oct6[i] * oct6[j]).sum()) < 0.5]
    return oct6, edges, [12.0] * 6


KINDS = {"ch": ["ch"], "water": ["water"], "octahedron": ["octahedron"],
         "mixed": ["ch", "water", "octahedron"]}


def _slot_case(kind, copies=6, L=20.0, seed=7):
    """Clusters, randomly rotated and placed (some straddle the box's
    faces), in slot layout: each atom in a random slot, empty slots
    between, row N of the slot map an empty slot, as after a rebin."""
    rng = np.random.default_rng(seed)
    pairs, d2, masses, xs = [], [], [], []
    for _ in range(copies):
        for k in KINDS[kind]:
            xl, cons, m = _molecule(k)
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            xl = xl @ q.T + rng.uniform(0, L, 3)
            base = sum(len(x) for x in xs)
            for i, j in cons:
                pairs.append((base + i, base + j))
                d2.append(float(((xl[i] - xl[j]) ** 2).sum()))
            xs.append(xl)
            masses += m
    x_old = np.concatenate(xs)
    n = len(x_old)
    ns = n + 23
    slot = rng.permutation(ns)[:n]
    empty = np.setdiff1d(np.arange(ns), slot)
    inv = np.append(slot, empty[-1])

    def planes(a, fill=0.0):
        p = np.full((ns, 3), fill)
        p[slot] = a
        return p

    js = jshake.ShakeConstraints(
        pairs=np.asarray(pairs, np.int32), d2=np.asarray(d2),
        invm=1.0 / np.asarray(masses), iters=30)
    x_new = x_old + 0.08 * rng.normal(size=x_old.shape)
    return dict(js=js, n=n, L=np.full(3, L), inv=inv, slot=slot,
                xo=planes(x_old % L, 7.0), xn=planes(x_new % L, 7.0),
                v=planes(0.1 * rng.normal(size=x_old.shape)),
                f=planes(30.0 * rng.normal(size=x_old.shape)))


def _jt(a):
    return tuple(jnp.asarray(a[:, c]) for c in range(3))


def _tt(a):
    return tuple(torch.from_numpy(a[:, c].copy()) for c in range(3))


def _stack(planes):
    return np.stack([np.asarray(p) for p in planes], -1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_solves_match_jax(kind):
    d = _slot_case(kind)
    js, L, n = d["js"], d["L"], d["n"]
    ts = interop.shake_from_numpy(js.pairs, js.d2, js.invm, js.iters,
                                  js.n_independent)
    jc = jshake.make_clusters(js)
    t = tshake.make_clusters(ts).tables_on("cpu", torch.float64)
    inv = torch.from_numpy(d["inv"].astype(np.int32))
    rows = jnp.asarray(d["inv"])[jnp.asarray(jc.rows_np(n))]
    dt = 0.7
    xf, vf, rn = jshake.shake_positions_clustered(
        js, jc, _jt(d["xo"]), _jt(d["xn"]), _jt(d["v"]), dt, L, rows,
        return_r=True)
    tx, tv = _tt(d["xn"]), _tt(d["v"])
    ro = tshake.shake_ref(t, _tt(d["xo"]), inv, L)
    trn = tshake.shake_positions(t, ro, tx, tv, inv, L, dt, js.iters)
    s = d["slot"]
    assert _rel(_stack(tx)[s], _stack(xf)[s]) <= 1e-12
    assert _rel(_stack(tv)[s], _stack(vf)[s]) <= 1e-12
    assert _rel(trn.numpy(), rn) <= 1e-12
    # empty slots are neither read into a cluster nor written
    empty = np.setdiff1d(np.arange(len(d["xn"])), s)
    np.testing.assert_array_equal(_stack(tx)[empty], d["xn"][empty])
    np.testing.assert_array_equal(_stack(tv)[empty], d["v"][empty])
    # SHAKE from a 0.08 A displacement: constraints exact to 1e-9
    x_at = _stack(tx)[s]
    r = x_at[js.pairs[:, 0]] - x_at[js.pairs[:, 1]]
    r -= np.round(r / L) * L
    assert np.abs((r * r).sum(1) / js.d2 - 1).max() < 1e-9

    vr = jshake.rattle_velocities_clustered(js, jc, xf, vf, L, rows,
                                            r_pre=rn)
    tshake.rattle_velocities(t, tv, inv, L, r=trn)
    assert _rel(_stack(tv)[s], _stack(vr)[s]) <= 1e-12
    v_at = _stack(tv)[s]
    dv = v_at[js.pairs[:, 0]] - v_at[js.pairs[:, 1]]
    proj = np.abs((r * dv).sum(1)) / np.sqrt((r * r).sum(1))
    assert proj.max() < 1e-12
    # RATTLE from the positions (the set-up settle's form)
    vr2 = jshake.rattle_velocities_clustered(js, jc, xf, _jt(d["v"]), L,
                                             rows)
    tv2 = _tt(d["v"])
    tshake.rattle_velocities(t, tv2, inv, L, xs=tx)
    assert _rel(_stack(tv2)[s], _stack(vr2)[s]) <= 1e-12

    ftm2v = 4.184e-4
    for half in (False, True):
        # the force as one plane set, or split into two (pair and k-space)
        fa = _tt(d["f"] * (0.75 if half else 1.0))
        fb = _tt(d["f"] * 0.25) if half else None
        wt = tshake.shake_virial(t, _tt(d["xn"]), _tt(d["v"]), fa, fb, inv,
                                 L, ftm2v, torch.float64).numpy()
        wj = jshake.shake_virial_clustered(js, jc, _jt(d["xn"]), _jt(d["v"]),
                                           _jt(d["f"]), ftm2v, L, rows)
        assert _rel(wt, wj) <= 1e-12 and np.abs(wt).max() > 1e-3
    if kind == "ch":
        # one Jacobi sweep is exact on C = 1: the scatter form agrees
        pairs = jnp.asarray(d["inv"][js.pairs])
        ws = jshake.shake_virial(js, jnp.asarray(d["xn"]),
                                 jnp.asarray(d["v"]), jnp.asarray(d["f"]),
                                 ftm2v, L, pairs=pairs)
        assert _rel(wt, ws) <= 1e-12


def test_positions_only_leave_velocities():
    """vs = None (the set-up settle): positions as with velocities."""
    d = _slot_case("mixed")
    js, L = d["js"], d["L"]
    t = tshake.make_clusters(interop.shake_from_numpy(
        js.pairs, js.d2, js.invm, js.iters, -1)).tables_on("cpu",
                                                           torch.float64)
    inv = torch.from_numpy(d["inv"].astype(np.int32))
    ro = tshake.shake_ref(t, _tt(d["xo"]), inv, L)
    a, b, v = _tt(d["xn"]), _tt(d["xn"]), _tt(d["v"])
    tshake.shake_positions(t, ro, a, None, inv, L, 1.0, 30)
    tshake.shake_positions(t, ro, b, v, inv, L, 1.0, 30)
    np.testing.assert_array_equal(_stack(a), _stack(b))


# ---- (c) the literal decks against the JAX package ----

FIELDS = ("temp", "evdwl", "ecoul", "elong", "emol", "press", "etotal")


def _deck(name, **kw):
    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(read_data=DATA, replicate=[1, 1, 1], run=10, thermo=5,
               precision="double")
    cfg.update(kw)
    return cfg


def _unwrapped(sim):
    a = sim.get_atoms()
    return a["x"] + a["image"] * np.asarray(sim.box.lengths)


@pytest.mark.parametrize("name", ["rhodo_class.yaml", "rhodo_nve.yaml"])
def test_literal_rhodo_deck_matches_jax(name):
    from lammps_buck_intel_tpu.run import run_deck as jax_run_deck

    from lammps_buck_intel_tpu_torch.run import run_deck

    cfg = _deck(name)
    jsim, jrows = jax_run_deck(dict(cfg), log=False)
    # the JAX package's torsion angle (interop.jax_torsion_deck)
    tsim, trows = run_deck(interop.jax_torsion_deck(cfg), device="cpu",
                           log=False)
    assert tsim.n_atoms == 1728 and tsim.shake.n_constraints == 864
    assert tsim.dof == 3 * 1728 - 3 - 864
    # the C-H bond type is constrained, so it leaves the bonded terms
    np.testing.assert_array_equal(tsim.bonded.bonds, jsim.bonded.bonds)
    assert set(np.unique(tsim.bonded.bonds[:, 0])) == {0}
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] \
        == [0, 5, 10]
    for jr, tr in zip(jrows, trows):
        for key in FIELDS:
            assert abs(tr[key] - jr[key]) <= 1e-10 * abs(jr[key]), \
                (jr["step"], key, tr[key], jr[key])
    assert np.abs(_unwrapped(tsim) - _unwrapped(jsim)).max() <= 1e-10
    if name == "rhodo_class.yaml":
        assert tsim.thermostat.dof == jsim.thermostat.dof == tsim.dof
        jt, tt = np.asarray(jsim.state.therm), tsim.state.therm.numpy()
        assert abs(jt[0, 0]) > 1e-5
        assert np.abs(tt - jt).max() <= 1e-10 * np.abs(jt).max()
    else:
        assert tsim.thermostat is None
        assert abs(trows[-1]["etotal"] - trows[0]["etotal"]) < 1.0


# ---- (d) the NVT ordering ----

def test_nvt_chain_reads_post_rattle_kinetic_energy(monkeypatch):
    """Each chain half step gets the kinetic partials of the velocities
    it scales: the second one those RATTLE left, which differ from the
    kicked velocities' (so partials of the kick would fail here)."""
    sim = build_simulation(_deck("rhodo_class.yaml"), device="cpu")
    seen, rattled = [], []
    scale, rattle = cellpair_verlet.nhc_scale, tshake.rattle_velocities

    def ke2(vs):
        st = sim.state
        return float(nve.kinetic_plain(vs, st.typ, st.aid, sim._mass_t,
                                       sim.n_atoms, torch.float64)[:, 0].sum())

    def spy_scale(cfg, therm, vs, partial, t_target):
        seen.append((float(partial[:, 0].sum()), ke2(vs)))
        return scale(cfg, therm, vs, partial, t_target)

    def spy_rattle(t, vs, *args, **kw):
        before = ke2(vs)
        rattle(t, vs, *args, **kw)
        rattled.append((before, ke2(vs)))

    monkeypatch.setattr(cellpair_verlet, "nhc_scale", spy_scale)
    monkeypatch.setattr(tshake, "rattle_velocities", spy_rattle)
    sim.run(1, thermo_every=0, log=False)
    assert len(seen) == 2 and len(rattled) == 1
    for got, want in seen:
        assert abs(got - want) <= 1e-12 * want
    for before, after in rattled:
        assert abs(before - after) > 1e-9 * after


# ---- (e) degrees of freedom and the settle ----

def test_shake_deck_counts_3n_minus_3_minus_nc():
    shake = build_simulation(_deck("rhodo_nve.yaml"), device="cpu")
    flex = build_simulation(_deck("rhodo_flex_nve.yaml"), device="cpu")
    n, nc = shake.n_atoms, shake.shake.n_constraints
    assert (n, nc, flex.dof) == (1728, 864, 3 * n - 3)
    rs, rf = shake.thermo(), flex.thermo()
    # the settle projects the data file's velocities: the kinetic energies
    # differ a little, and the temperatures by the degrees of freedom
    ke = rs["ke"] / rf["ke"]
    assert abs(ke - 1.0) < 1e-2
    want = (3 * n - 3) / (3 * n - 3 - nc) * ke
    assert abs(rs["temp"] / rf["temp"] - want) <= 1e-12 * want


def test_settle_puts_the_bonds_on_their_length():
    """The data file is on the constraints in f64 already; the set-up
    settle is seen on a perturbed state: bonds back at 1.09 A, velocities
    projected, and no cluster left above the deck's tol by the solve
    (what ``shake.unconverged`` counts at a thermo row)."""
    sim = build_simulation(_deck("rhodo_nve.yaml"), device="cpu")
    sc, L = sim.shake, sim.box.lengths
    at = sim.get_atoms()
    assert float(tshake.max_violation(sc, torch.from_numpy(at["x"]),
                                      L)) < 1e-12
    st = sim.state.clone()
    rng = np.random.default_rng(3)
    occ = st.aid < sim.n_atoms
    for p, scale in ((st.x, 0.02), (st.y, 0.02), (st.z, 0.02),
                     (st.vx, 0.01), (st.vy, 0.01), (st.vz, 0.01)):
        p += torch.from_numpy(rng.normal(size=p.shape) * scale) * occ
    rn = tshake.settle(sim._shake_t, sc, (st.x, st.y, st.z),
                       (st.vx, st.vy, st.vz), sim._inv_map(st), L)
    assert int(tshake.unconverged(sim._shake_t, rn, sc.tol)) == 0
    x = cellpair_verlet.cs.to_atoms(sim.grid, st)
    assert float(tshake.max_violation(sc, x["x"], L)) < 1e-12
    r = (x["x"][sc.pairs[:, 0]] - x["x"][sc.pairs[:, 1]]).numpy()
    r -= np.round(r / L) * L
    dv = (x["v"][sc.pairs[:, 0]] - x["v"][sc.pairs[:, 1]]).numpy()
    assert np.abs((r * dv).sum(1)).max() < 1e-12
    assert np.abs(dv).max() > 1e-3
