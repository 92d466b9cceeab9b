"""Pair physics and cell-pair forces of the port against the JAX package.

f64 on the CPU, where the port runs the plain versions of its kernels:
``pair_terms`` to rel 1e-12; ``compute_cellpair`` (full stencil, no
Newton) against the JAX half-stencil Newton kernel to 1e-10 — forces as
max|df| <= 1e-10 max|f| in atom order, evdwl, ecoul and virial relative.
The two differ only in summation order.  Both for buck and for
buck/coul/long on a charged system (Ewald real space, A&S erfc), and for
lj/charmm/coul/long with special bonds (the energy switch on both sides of
the inner cutoff, the subtractive Coulomb special) on the 1,728-atom
rhodo-class box; buck/coul/cut and lj/charmm/coul/cut (the plain Coulomb
term inside its cutoff, the special factor scaling it) the same way;
Ewald dispersion and the lj/cut family raise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.models.pair import cellpair as jcellpair
from lammps_buck_intel_tpu.models.pair import styles as jstyles
from lammps_buck_intel_tpu.neighbor import cell_slots as jcs
from lammps_buck_intel_tpu_torch.interop import (pair_style_from_numpy,
                                                 slot_state_from_numpy)
from lammps_buck_intel_tpu_torch.io import lattice
from lammps_buck_intel_tpu_torch.models.pair import cellpair as tcellpair
from lammps_buck_intel_tpu_torch.models.pair import styles as tstyles
from lammps_buck_intel_tpu_torch.neighbor import cell_slots as tcs

COEFFS_1 = {(0, 0): (1.0, 0.2, -0.8)}
COEFFS_2 = {(0, 0): (1.0, 0.2, -0.8), (0, 1): (0.9, 0.22, -0.7),
            (1, 1): (1.1, 0.18, -0.9)}


def _styles(ntypes, shift):
    coeffs = COEFFS_1 if ntypes == 1 else COEFFS_2
    j = jstyles.build_buck(ntypes, coeffs, cut_global=2.5, shift=shift)
    t = tstyles.build_buck(ntypes, coeffs, cut_global=2.5, shift=shift)
    return j, t


def _to_port(jstyle):
    cfg = jstyle.cfg
    return pair_style_from_numpy(
        jstyle.tables, jstyle.special_lj, jstyle.special_coul, jstyle.qqrd2e,
        jstyle.g_ewald, jstyle.cutsq_max,
        dict(name=cfg.name, vdw=cfg.vdw, coul=cfg.coul, disp=cfg.disp))


@pytest.mark.parametrize("ntypes", [1, 2])
@pytest.mark.parametrize("shift", [False, True])
def test_build_buck_identical(ntypes, shift):
    j, t = _styles(ntypes, shift)
    assert np.array_equal(j.tables, t.tables)
    assert j.cutsq_max == t.cutsq_max
    p = _to_port(j)
    assert np.array_equal(p.tables, t.tables) and p.cfg == t.cfg


@pytest.mark.parametrize("ntypes", [1, 2])
@pytest.mark.parametrize("shift", [False, True])
def test_pair_terms_matches_jax(ntypes, shift):
    j, t = _styles(ntypes, shift)
    rng = np.random.default_rng(7 + ntypes)
    rsq = rng.uniform(0.5, 8.0, size=4000)   # cut^2 = 6.25: both sides
    flat = j.tables.reshape(ntypes * ntypes, -1)
    if ntypes == 1:
        jcoef = tcoef = {n: float(flat[0, c])
                         for c, n in enumerate(jstyles.COEF_NAMES)}
    else:
        tt = rng.integers(0, 4, size=rsq.shape)
        jcoef = {n: jnp.asarray(flat[tt, c])
                 for c, n in enumerate(jstyles.COEF_NAMES)}
        tcoef = {n: torch.as_tensor(flat[tt, c])
                 for c, n in enumerate(tstyles.COEF_NAMES)}
    jf, je, _ = jstyles.pair_terms(j, jnp.asarray(rsq), jcoef, 0.0, 0.0,
                                   1.0, 1.0, eflag=True)
    tf, te, _ = tstyles.pair_terms(t, torch.as_tensor(rsq), tcoef, 0.0, 0.0,
                                   1.0, 1.0, eflag=True)
    for a, b in ((jf, tf), (je, te)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max())


def _jittered(ntypes, reach_z, charged=False):
    """864-atom jittered fcc lattice binned by the JAX package (f64), and
    the same slot state in the port; ``charged`` gives the atoms random
    charges of zero sum."""
    x, lo, hi = lattice.create_atoms("fcc", 0.8442, 6, 6, 6)
    n = len(x)
    rng = np.random.default_rng(11 + ntypes + reach_z)
    x = x + rng.uniform(-0.15, 0.15, x.shape)
    typ = rng.integers(0, ntypes, n).astype(np.int32)
    q = np.zeros(n)
    if charged:
        q = rng.uniform(-1.0, 1.0, n)
        q -= q.mean()
    box = jmake_box(lo, hi)
    grid = jcs.make_grid(n, box.lengths, 2.8, reach_z=reach_z)
    jst = jcs.from_atoms(grid, box, x, np.zeros_like(x),
                         np.zeros((n, 3), np.int32), typ, q,
                         dtype=jnp.float64)
    assert not bool(jst.overflow)
    planes = {k: np.asarray(v) for k, v in
              jax.device_get(jst._asdict()).items() if v is not None}
    tgrid = tcs.CellGrid(nc=grid.nc, cap=grid.cap, n_atoms=n,
                         reach_z=reach_z)
    return box, grid, jst, tgrid, slot_state_from_numpy(planes, device="cpu")


def _atom_order(aid, n, *planes):
    out = np.zeros((n + 1, len(planes)))
    out[np.minimum(aid, n)] = np.stack([np.asarray(p) for p in planes], -1)
    return out[:n]


@pytest.mark.parametrize("ntypes,reach_z", [(1, 1), (2, 1), (1, 2)])
def test_compute_cellpair_matches_jax(ntypes, reach_z):
    box, grid, jst, tgrid, tst = _jittered(ntypes, reach_z)
    jstyle, _ = _styles(ntypes, shift=True)
    tstyle = _to_port(jstyle)
    jr = jcellpair.compute_cellpair(jstyle, grid, box, jst, eflag=True,
                                    vflag=True, acc_dtype=jnp.float64)
    tr = tcellpair.compute_cellpair(tstyle, tgrid, box, tst, eflag=True,
                                    vflag=True, acc_dtype=torch.float64)
    n = grid.n_atoms
    aid = np.asarray(jst.aid)
    fj = _atom_order(aid, n, jr.fx, jr.fy, jr.fz)
    ft = _atom_order(aid, n, tr.fx, tr.fy, tr.fz)
    assert np.abs(ft - fj).max() <= 1e-10 * np.abs(fj).max()
    assert np.abs(fj).max() > 1.0   # the jitter makes real forces
    ej = float(jr.evdwl)
    assert abs(float(tr.evdwl) - ej) <= 1e-10 * abs(ej)
    vj = np.asarray(jr.virial)
    np.testing.assert_allclose(tr.virial.numpy(), vj, rtol=1e-10,
                               atol=1e-10 * np.abs(vj).max())
    # force-only call: same forces, zero energies
    f_only = tcellpair.compute_cellpair(tstyle, tgrid, box, tst,
                                        acc_dtype=torch.float64)
    assert torch.equal(f_only.fx, tr.fx) and float(f_only.evdwl) == 0.0


def test_stencil_tables_match_jax():
    for r in (1, 2, 3):
        assert np.array_equal(tcellpair.half_offsets(r),
                              jcellpair.half_offsets(r))
        nc = (3, 4, 3 * r)
        for a, b in zip(jcellpair.half_stencil_tables(
                            nc, jcellpair.half_offsets(r)),
                        tcellpair.half_stencil_tables(
                            nc, tcellpair.half_offsets(r))):
            assert np.array_equal(a, b)
        # the half stencil and its mirror cover the full stencil once
        half = tcellpair.half_offsets(r)
        both = np.concatenate([half, -half[1:]])
        assert len(both) == 9 * (2 * r + 1) == len(np.unique(both, axis=0))
        assert np.abs(both).max(0).tolist() == [1, 1, r]


# buck/coul/long: a metal-units qqrd2e and a g_ewald that makes erfc
# matter inside the 2.5 cutoff
QQRD2E, G_EWALD = 14.399645, 1.1


def _coul_styles(ntypes):
    coeffs = COEFFS_1 if ntypes == 1 else COEFFS_2
    j = jstyles.build_buck(ntypes, coeffs, cut_global=2.5, coul="long",
                           qqrd2e=QQRD2E, shift=True, dtype=jnp.float64)
    j = j.replace(g_ewald=G_EWALD)
    t = tstyles.build_buck(ntypes, coeffs, cut_global=2.5, coul="long",
                           qqrd2e=QQRD2E, shift=True).replace(
                               g_ewald=G_EWALD)
    return j, t


@pytest.mark.parametrize("ntypes", [1, 2])
def test_build_buck_coul_long_identical(ntypes):
    j, t = _coul_styles(ntypes)
    assert np.array_equal(j.tables, t.tables)
    p = _to_port(j)
    assert np.array_equal(p.tables, t.tables) and p.cfg == t.cfg
    for f in ("cutsq_max", "g_ewald", "qqrd2e"):
        assert getattr(j, f) == getattr(t, f) == getattr(p, f), f


def test_pair_terms_coul_long_matches_jax():
    j, t = _coul_styles(2)
    rng = np.random.default_rng(5)
    rsq = rng.uniform(0.5, 8.0, size=4000)
    qi, qj = rng.uniform(-1.5, 1.5, (2, rsq.size))
    flat = j.tables.reshape(4, -1)
    tt = rng.integers(0, 4, size=rsq.shape)
    jcoef = {n: jnp.asarray(flat[tt, c])
             for c, n in enumerate(jstyles.COEF_NAMES)}
    tcoef = {n: torch.as_tensor(flat[tt, c])
             for c, n in enumerate(tstyles.COEF_NAMES)}
    jout = jstyles.pair_terms(j, jnp.asarray(rsq), jcoef, jnp.asarray(qi),
                              jnp.asarray(qj), 1.0, 1.0, eflag=True)
    tout = tstyles.pair_terms(t, torch.as_tensor(rsq), tcoef,
                              torch.as_tensor(qi), torch.as_tensor(qj), 1.0,
                              1.0, eflag=True)
    assert float(np.abs(np.asarray(jout[2])).max()) > 1.0
    for a, b in zip(jout, tout):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max())


@pytest.mark.parametrize("ntypes,reach_z", [(2, 1), (1, 2)])
def test_compute_cellpair_coul_long_matches_jax(ntypes, reach_z):
    box, grid, jst, tgrid, tst = _jittered(ntypes, reach_z, charged=True)
    jstyle, _ = _coul_styles(ntypes)
    tstyle = _to_port(jstyle)
    jr = jcellpair.compute_cellpair(jstyle, grid, box, jst, eflag=True,
                                    vflag=True, acc_dtype=jnp.float64)
    tr = tcellpair.compute_cellpair(tstyle, tgrid, box, tst, eflag=True,
                                    vflag=True, acc_dtype=torch.float64)
    n = grid.n_atoms
    aid = np.asarray(jst.aid)
    fj = _atom_order(aid, n, jr.fx, jr.fy, jr.fz)
    ft = _atom_order(aid, n, tr.fx, tr.fy, tr.fz)
    assert np.abs(ft - fj).max() <= 1e-10 * np.abs(fj).max()
    for name in ("evdwl", "ecoul"):
        ej = float(getattr(jr, name))
        assert abs(ej) > 1.0, name
        assert abs(float(getattr(tr, name)) - ej) <= 1e-10 * abs(ej), name
    vj = np.asarray(jr.virial)
    np.testing.assert_allclose(tr.virial.numpy(), vj, rtol=1e-10,
                               atol=1e-10 * np.abs(vj).max())


def test_unported_coulomb_raises():
    """The Coulomb and dispersion forms the port does not carry raise:
    lj/charmm without a Coulomb term or with Ewald-split dispersion; an
    unknown Coulomb or dispersion form is refused.  (buck/coul/cut and
    lj/charmm/coul/cut are ported: test_*_coul_cut_* below; the lj/cut
    family and lj/long: tests/test_torch_disp.py; buck/long with coul
    none or long: tests/test_torch_disp_mix.py, and here it builds.)"""
    with pytest.raises(ValueError, match="Coulomb form"):
        tstyles.build_buck(1, COEFFS_1, cut_global=2.5, coul="wolf")
    with pytest.raises(ValueError, match="dispersion form"):
        tstyles.build_buck(1, COEFFS_1, cut_global=2.5, disp="wolf")
    assert tstyles.build_buck(1, COEFFS_1, cut_global=2.5,
                              disp="long").cfg.disp == "long"
    # styles the JAX package has and the port does not
    _, t = _coul_styles(1)
    rsq = torch.full((4,), 2.0, dtype=torch.float64)
    coef = {n: float(t.tables[0, 0, c])
            for c, n in enumerate(tstyles.COEF_NAMES)}
    for vdw, coul, disp in (("buck", "long", "long"),
                            ("buck", "none", "long")):
        ok = t.replace(cfg=tstyles.PairConfig("x", vdw, coul, disp),
                       g_ewald_6=0.37)
        fs, _, _ = tstyles.pair_terms(ok, rsq, coef, 1.0, -1.0, 1.0, 1.0,
                                      eflag=True)
        assert torch.isfinite(fs).all()
    for vdw, coul, disp in (("ljcharmm", "none", "cut"),
                            ("ljcharmm", "long", "long")):
        bad = t.replace(cfg=tstyles.PairConfig("x", vdw, coul, disp))
        with pytest.raises(NotImplementedError):
            tstyles.pair_terms(bad, rsq, coef, 1.0, -1.0, 1.0, 1.0,
                               eflag=True)
    with pytest.raises(NotImplementedError, match="Coulomb term"):
        tstyles.build_lj_charmm(1, {0: (0.1, 3.0)}, 8.0, 10.0, coul="none")
    assert tstyles.build_lj(1, {0: (0.1, 3.0)}, 8.0).cfg.vdw == "lj"


# lj/charmm/coul/long as the rhodo-class decks set it
CHARMM = dict(coeffs={0: (0.08, 3.6, 0.04, 3.4), 1: (0.025, 2.4, 0.02, 2.3)},
              inner=8.0, cut_lj=10.0, cut_coul=10.0,
              special_lj=(1.0, 0.0, 0.5, 0.25),
              special_coul=(1.0, 0.0, 0.3, 0.8), qqrd2e=332.06371)


def _charmm_styles(**kw):
    args = dict(CHARMM, **kw)
    coeffs = args.pop("coeffs")
    inner, cut = args.pop("inner"), args.pop("cut_lj")
    j = jstyles.build_lj_charmm(2, coeffs, inner, cut, **args)
    t = tstyles.build_lj_charmm(2, coeffs, inner, cut, **args)
    return j.replace(g_ewald=0.25), t.replace(g_ewald=0.25)


def _charmm_to_port(j):
    cfg = j.cfg
    return pair_style_from_numpy(
        j.tables, j.special_lj, j.special_coul, j.qqrd2e, j.g_ewald,
        j.cutsq_max, dict(name=cfg.name, vdw=cfg.vdw, coul=cfg.coul,
                          disp=cfg.disp),
        inner_sq=j.inner_sq, denom_lj=j.denom_lj, eps14=j.eps14,
        sig14=j.sig14)


def test_build_lj_charmm_identical():
    j, t = _charmm_styles()
    p = _charmm_to_port(j)
    for s in (t, p):
        assert np.array_equal(j.tables, s.tables) and s.cfg.vdw == "ljcharmm"
        for f in ("cutsq_max", "inner_sq", "denom_lj", "qqrd2e", "g_ewald"):
            assert getattr(j, f) == getattr(s, f), f
        for f in ("eps14", "sig14", "special_lj", "special_coul"):
            assert np.array_equal(getattr(j, f), getattr(s, f)), f
    # eps14 / sig14 default to eps / sigma
    j2, t2 = _charmm_styles(coeffs={0: (0.08, 3.6), 1: (0.025, 2.4)})
    assert np.array_equal(j2.eps14, t2.eps14) and t2.sig14[1] == 2.4


@pytest.mark.parametrize("special", [False, True])
def test_pair_terms_ljcharmm_matches_jax(special):
    j, t = _charmm_styles()
    rng = np.random.default_rng(17)
    # both sides of inner_sq = 64 and of the cutoff 100; short 1-2 distances
    rsq = np.concatenate([rng.uniform(1.0, 120.0, 4000),
                          [63.999, 64.0, 64.001, 99.999, 100.0, 100.001]])
    qi, qj = rng.uniform(-0.5, 0.5, (2, rsq.size))
    tt = rng.integers(0, 4, size=rsq.shape)
    flat = j.tables.reshape(4, -1)
    jcoef = {n: jnp.asarray(flat[tt, c])
             for c, n in enumerate(jstyles.COEF_NAMES)}
    tcoef = {n: torch.as_tensor(flat[tt, c])
             for c, n in enumerate(tstyles.COEF_NAMES)}
    if special:
        code = rng.integers(0, 4, size=rsq.shape)
        jfac = (jnp.asarray(j.special_lj[code]),
                jnp.asarray(j.special_coul[code]))
        tfac = (torch.as_tensor(t.special_lj[code]),
                torch.as_tensor(t.special_coul[code]))
    else:
        jfac = tfac = (1.0, 1.0)
    jout = jstyles.pair_terms(j, jnp.asarray(rsq), jcoef, jnp.asarray(qi),
                              jnp.asarray(qj), *jfac, eflag=True)
    tout = tstyles.pair_terms(t, torch.as_tensor(rsq), tcoef,
                              torch.as_tensor(qi), torch.as_tensor(qj),
                              *tfac, eflag=True)
    assert float(np.abs(np.asarray(jout[1])[-2:]).max()) == 0.0   # cut, strict
    for a, b in zip(jout, tout):
        a = np.asarray(a)
        assert np.abs(a).max() > 1e-3
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max())
    # force-only: no energies
    assert tstyles.pair_terms(t, torch.as_tensor(rsq), tcoef,
                              torch.as_tensor(qi), torch.as_tensor(qj),
                              *tfac, eflag=False)[1:] == (None, None)


def _rhodo_slots():
    """The 1,728-atom rhodo-class box binned by the JAX package."""
    import os

    from lammps_buck_intel_tpu.io import read_data as jread

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = jread(os.path.join(root, "examples", "data.rhodo_class"))
    n = d.n_atoms
    box = jmake_box(d.box_lo, d.box_hi)
    grid = jcs.make_grid(n, box.lengths, 12.0, cap=56)
    jst = jcs.from_atoms(grid, box, d.x, np.zeros_like(d.x), d.image, d.type,
                         d.q, dtype=jnp.float64)
    assert not bool(jst.overflow) and grid.nc == (4, 4, 4)
    aid = np.minimum(np.asarray(jst.aid), n)
    planes = {k: np.asarray(v) for k, v in
              jax.device_get(jst._asdict()).items() if v is not None}
    tst = slot_state_from_numpy(planes, device="cpu")
    tgrid = tcs.CellGrid(nc=grid.nc, cap=grid.cap, n_atoms=n)
    return d, n, box, grid, jst, aid, tst, tgrid


def test_uniform_special_topology_takes_the_partner_table():
    """Molecules whose every intramolecular pair is special with one factor
    pair (SPC/E-class): the JAX package swaps the partner match for a
    molecule-id compare, a faster way to the same numbers; the port keeps
    the partner table."""
    from lammps_buck_intel_tpu.core import build_topology as jbuild

    d, n, box, grid, jst, aid, tst, tgrid = _rhodo_slots()
    mol = np.asarray(d.molecule)
    members = [np.nonzero(mol == m)[0] for m in np.unique(mol)]
    bonds = np.array([[0, i, j] for a in members for k, i in enumerate(a)
                      for j in a[k + 1:]], np.int32)
    topo = jbuild(n, bonds=bonds)
    assert topo.special_idx.shape == (n, 7)
    assert set(np.unique(topo.special_code)) == {1}
    jstyle, _ = _charmm_styles()
    f_lj, f_coul = (float(np.asarray(t)[1])
                    for t in (jstyle.special_lj, jstyle.special_coul))
    jr = jcellpair.compute_cellpair(
        jstyle, grid, box, jst, eflag=True, vflag=True,
        acc_dtype=jnp.float64, uniform_special=(f_lj, f_coul),
        slot_umol=jnp.asarray(np.concatenate([mol, [-1]])[aid], jnp.int32))
    table = tcellpair.make_special_table(topo.special_idx, topo.special_code,
                                         "cpu")
    tr = tcellpair.compute_cellpair(
        _charmm_to_port(jstyle), tgrid, box, tst, eflag=True, vflag=True,
        acc_dtype=torch.float64, special=table)
    fj = _atom_order(aid, n, jr.fx, jr.fy, jr.fz)
    ft = _atom_order(aid, n, tr.fx, tr.fy, tr.fz)
    assert np.abs(ft - fj).max() <= 1e-10 * np.abs(fj).max()
    for name in ("evdwl", "ecoul"):
        ej = float(getattr(jr, name))
        assert abs(float(getattr(tr, name)) - ej) <= 1e-10 * abs(ej), name


def test_compute_cellpair_special_matches_jax():
    """lj/charmm/coul/long with the 1-2/1-3/1-4 partner table on the
    1,728-atom rhodo-class box: the JAX package matches per-slot partner
    ids, the port reads the atom-order table through the slot's atom."""
    from lammps_buck_intel_tpu.core import build_topology as jbuild

    d, n, box, grid, jst, aid, tst, tgrid = _rhodo_slots()
    topo = jbuild(n, bonds=d.bonds, angles=d.angles, dihedrals=d.dihedrals,
                  impropers=d.impropers)
    S = topo.special_idx.shape[1]
    assert S == 7
    sp_idx = np.concatenate([topo.special_idx, np.full((1, S), -1)])[aid]
    sp_code = np.concatenate([topo.special_code, np.zeros((1, S))])[aid]
    jstyle, _ = _charmm_styles()
    jr = jcellpair.compute_cellpair(
        jstyle, grid, box, jst, eflag=True, vflag=True,
        acc_dtype=jnp.float64,
        slot_special_idx=jnp.asarray(sp_idx, jnp.int32),
        slot_special_code=jnp.asarray(sp_code, jnp.int8))
    plain = jcellpair.compute_cellpair(jstyle, grid, box, jst, eflag=True,
                                       acc_dtype=jnp.float64)
    table = tcellpair.make_special_table(topo.special_idx, topo.special_code,
                                         "cpu")
    assert table.width == S and table.idx.shape == (n + 1, S)
    tr = tcellpair.compute_cellpair(
        _charmm_to_port(jstyle), tgrid, box, tst, eflag=True, vflag=True,
        acc_dtype=torch.float64, special=table)
    fj = _atom_order(aid, n, jr.fx, jr.fy, jr.fz)
    ft = _atom_order(aid, n, tr.fx, tr.fy, tr.fz)
    assert np.abs(ft - fj).max() <= 1e-10 * np.abs(fj).max()
    for name in ("evdwl", "ecoul"):
        ej = float(getattr(jr, name))
        # the specials matter: without them the energies are far off
        assert abs(ej - float(getattr(plain, name))) > 1e-2 * abs(ej), name
        assert abs(float(getattr(tr, name)) - ej) <= 1e-10 * abs(ej), name
    vj = np.asarray(jr.virial)
    np.testing.assert_allclose(tr.virial.numpy(), vj, rtol=1e-10,
                               atol=1e-10 * np.abs(vj).max())
    # an empty partner table is no table
    assert tcellpair.make_special_table(np.zeros((n, 0), np.int32),
                                        np.zeros((n, 0), np.int8),
                                        "cpu") is None


# coul/cut: buck with a Coulomb cutoff of its own (the tables' last
# column), and lj/charmm/coul/cut with the special factors scaling it
def _coul_cut_styles(ntypes):
    coeffs = COEFFS_1 if ntypes == 1 else COEFFS_2
    kw = dict(cut_global=2.5, coul="cut", cut_coul=2.2, qqrd2e=QQRD2E,
              shift=True)
    return (jstyles.build_buck(ntypes, coeffs, dtype=jnp.float64, **kw),
            tstyles.build_buck(ntypes, coeffs, **kw))


@pytest.mark.parametrize("ntypes", [1, 2])
def test_build_buck_coul_cut_identical(ntypes):
    j, t = _coul_cut_styles(ntypes)
    assert np.array_equal(j.tables, t.tables)
    assert t.cfg.coul == "cut" and t.cfg.name == "buck/coul/cut"
    p = _to_port(j)
    assert np.array_equal(p.tables, t.tables) and p.cfg == t.cfg
    for f in ("cutsq_max", "qqrd2e"):
        assert getattr(j, f) == getattr(t, f) == getattr(p, f), f
    jc, tc = (m.build_lj_charmm(1, {0: (0.1, 3.0)}, 8.0, 10.0, coul="cut",
                                cut_coul=11.0)
              for m in (jstyles, tstyles))
    assert np.array_equal(jc.tables, tc.tables)
    assert jc.cutsq_max == tc.cutsq_max == 121.0
    assert tc.cfg.name == "lj/charmm/coul/cut"


@pytest.mark.parametrize("vdw,special", [("buck", False), ("ljcharmm", False),
                                         ("ljcharmm", True)])
def test_pair_terms_coul_cut_matches_jax(vdw, special):
    """The plain Coulomb term on both sides of the Coulomb cutoff (strict),
    with and without special factors: forces and both energies to rel
    1e-12 of the JAX pair_terms."""
    if vdw == "buck":
        j, t = _coul_cut_styles(2)
        rsq = np.concatenate([np.random.default_rng(5).uniform(
            0.5, 8.0, 4000), [4.84, 6.25]])
    else:
        j, t = _charmm_styles(coul="cut")
        rsq = np.concatenate([np.random.default_rng(6).uniform(
            1.0, 120.0, 4000), [100.0]])
    rng = np.random.default_rng(9)
    qi, qj = rng.uniform(-1.5, 1.5, (2, rsq.size))
    tt = rng.integers(0, 4, size=rsq.shape)
    flat = j.tables.reshape(4, -1)
    jcoef = {n: jnp.asarray(flat[tt, c])
             for c, n in enumerate(jstyles.COEF_NAMES)}
    tcoef = {n: torch.as_tensor(flat[tt, c])
             for c, n in enumerate(tstyles.COEF_NAMES)}
    if special:
        code = rng.integers(0, 4, size=rsq.shape)
        jfac = (jnp.asarray(j.special_lj[code]),
                jnp.asarray(j.special_coul[code]))
        tfac = (torch.as_tensor(t.special_lj[code]),
                torch.as_tensor(t.special_coul[code]))
    else:
        jfac = tfac = (1.0, 1.0)
    jout = jstyles.pair_terms(j, jnp.asarray(rsq), jcoef, jnp.asarray(qi),
                              jnp.asarray(qj), *jfac, eflag=True)
    tout = tstyles.pair_terms(t, torch.as_tensor(rsq), tcoef,
                              torch.as_tensor(qi), torch.as_tensor(qj),
                              *tfac, eflag=True)
    ecoul = np.asarray(jout[2])
    assert np.abs(ecoul).max() > 1.0 and ecoul[-1] == 0.0   # cut, strict
    for a, b in zip(jout, tout):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max())


@pytest.mark.parametrize("ntypes,reach_z", [(2, 1), (1, 2)])
def test_compute_cellpair_coul_cut_matches_jax(ntypes, reach_z):
    box, grid, jst, tgrid, tst = _jittered(ntypes, reach_z, charged=True)
    jstyle, _ = _coul_cut_styles(ntypes)
    tstyle = _to_port(jstyle)
    jr = jcellpair.compute_cellpair(jstyle, grid, box, jst, eflag=True,
                                    vflag=True, acc_dtype=jnp.float64)
    tr = tcellpair.compute_cellpair(tstyle, tgrid, box, tst, eflag=True,
                                    vflag=True, acc_dtype=torch.float64)
    n = grid.n_atoms
    aid = np.asarray(jst.aid)
    fj = _atom_order(aid, n, jr.fx, jr.fy, jr.fz)
    ft = _atom_order(aid, n, tr.fx, tr.fy, tr.fz)
    assert np.abs(ft - fj).max() <= 1e-10 * np.abs(fj).max()
    for name in ("evdwl", "ecoul"):
        ej = float(getattr(jr, name))
        assert abs(ej) > 1.0, name
        assert abs(float(getattr(tr, name)) - ej) <= 1e-10 * abs(ej), name
    vj = np.asarray(jr.virial)
    np.testing.assert_allclose(tr.virial.numpy(), vj, rtol=1e-10,
                               atol=1e-10 * np.abs(vj).max())


# ---- K1's counters: the plain version counts what the kernel counts ----

def _counter_case(reach_z):
    """A jittered 864-atom fcc box of two types binned by the port (f64)
    with buck/coul/cut whose type pairs have cutoffs of their own, the
    Coulomb one the larger on some pairs and the smaller on others."""
    from lammps_buck_intel_tpu_torch.core import make_box

    x, lo, hi = lattice.create_atoms("fcc", 0.8442, 6, 6, 6)
    n = len(x)
    rng = np.random.default_rng(40 + reach_z)
    x = x + rng.uniform(-0.15, 0.15, x.shape)
    style = tstyles.build_buck(
        2, {(0, 0): (1.0, 0.2, -0.8, 2.5, 2.0),
            (0, 1): (0.9, 0.22, -0.7, 2.0, 2.4),
            (1, 1): (1.1, 0.18, -0.9, 1.8, 1.5)},
        cut_global=2.5, coul="cut", qqrd2e=14.399645)
    box = make_box(lo, hi)
    grid = tcs.make_grid(n, box.lengths, float(np.sqrt(style.cutsq_max))
                         + 0.3, reach_z=reach_z)
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt)  # noqa
    st = tcs.from_atoms(grid, box, t(x), t(np.zeros((n, 3))),
                        t(np.zeros((n, 3)), torch.int32),
                        t(rng.integers(0, 2, n), torch.int32),
                        t(rng.uniform(-1, 1, n)), dtype=torch.float64)
    return style, grid, box, st


def _brute_counts(style, grid, box, st):
    """Candidates tested and pairs in range, cell by cell over the Newton
    half stencil in numpy: the own cell and the lexicographically positive
    offsets of the (3, 3, 2 reach_z + 1) stencil; every slot of those
    cells is a candidate of each slot that holds an atom, in the own cell
    only slot j > slot i; in range are those of another atom within the
    type pair's larger cutoff.  Also the ordered pairs in range over the
    full stencil, which count each pair twice."""
    nc, cap, n = np.asarray(grid.nc), grid.cap, grid.n_atoms
    L = np.asarray(box.lengths, np.float64)
    pos = np.stack([st.x.numpy(), st.y.numpy(), st.z.numpy()], -1)
    aid, typ = st.aid.numpy(), st.typ.numpy()
    col = tstyles.COEF_NAMES.index
    cut = np.maximum(style.tables[..., col("cut_ljsq")],
                     style.tables[..., col("cut_coulsq")])
    r = grid.reach_z
    offsets = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
               for oz in range(-r, r + 1)]
    tested = in_range = ordered = 0
    for c in range(grid.ncell):
        cell = np.array([c // (nc[1] * nc[2]), (c // nc[2]) % nc[1],
                         c % nc[2]])
        si = slice(c * cap, (c + 1) * cap)
        ok_i = aid[si] < n
        for off in offsets:
            tgt = cell + off
            shift = ((tgt >= nc).astype(np.float64) - (tgt < 0)) * L
            w = np.mod(tgt, nc)
            cj = (w[0] * nc[1] + w[1]) * nc[2] + w[2]
            sj = slice(cj * cap, (cj + 1) * cap)
            d = pos[si][:, None, :] - (pos[sj] + shift)[None, :, :]
            rsq = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                   + d[..., 2] * d[..., 2])
            ti = np.where(ok_i, typ[si], 0)[:, None]
            tj = np.where(aid[sj] < n, typ[sj], 0)[None, :]
            hit = (ok_i[:, None] & (aid[sj] < n)[None, :]
                   & (aid[si][:, None] != aid[sj][None, :])
                   & (np.maximum(rsq, 1e-12) < cut[ti, tj]))
            ordered += int(hit.sum())
            if off < (0, 0, 0):
                continue
            if off == (0, 0, 0):
                hit &= np.triu(np.ones((cap, cap), bool), 1)
            tested += int(ok_i.sum()) * cap
            in_range += int(hit.sum())
    return tested, in_range, ordered


@pytest.mark.parametrize("reach_z", [1, 2])
def test_cellpair_plain_counters_match_brute_force(reach_z):
    from lammps_buck_intel_tpu_torch.utils import trace

    style, grid, box, st = _counter_case(reach_z)
    trace.reset()
    trace.enable()
    try:
        r = tcellpair.compute_cellpair(style, grid, box, st,
                                       acc_dtype=torch.float64)
        c = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert float(r.fx.abs().max()) > 1.0
    tested, in_range, ordered = _brute_counts(style, grid, box, st)
    assert tested == grid.n_atoms * (9 * grid.reach_z + 5) * grid.cap
    assert ordered == 2 * in_range
    assert c["cellpair.tested"] == tested
    assert c["cellpair.in_range"] == in_range > 0
    # the evaluate rounds' lane slots are the kernel's alone
    assert c["cellpair.eval_lanes"] == 0


def test_cellpair_counters_stay_zero_while_tracer_off():
    from lammps_buck_intel_tpu_torch.utils import trace

    style, grid, box, st = _counter_case(1)
    trace.disable()
    trace.reset()
    assert trace.device_counts("cellpair", "cpu") is None
    tcellpair.compute_cellpair(style, grid, box, st, acc_dtype=torch.float64)
    c = trace.counters()
    assert (c["cellpair.tested"], c["cellpair.in_range"],
            c["cellpair.eval_lanes"]) == (0, 0, 0)
    # a buffer made while the tracer was on stays as it was once it is off
    trace.enable()
    try:
        buf = trace.device_counts("cellpair", "cpu")
    finally:
        trace.disable()
    tcellpair.compute_cellpair(style, grid, box, st, acc_dtype=torch.float64)
    assert buf.tolist() == [0, 0, 0]
    assert trace.counters()["cellpair.tested"] == 0
    trace.reset()
