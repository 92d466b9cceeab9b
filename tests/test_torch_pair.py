"""Pair physics and cell-pair forces of the port against the JAX package.

f64 on the CPU, where the port runs the plain versions of its kernels:
``pair_terms`` to rel 1e-12; ``compute_cellpair`` (full stencil, no
Newton) against the JAX half-stencil Newton kernel to 1e-10 — forces as
max|df| <= 1e-10 max|f| in atom order, evdwl, ecoul and virial relative.
The two differ only in summation order.  Both for buck and for
buck/coul/long on a charged system (Ewald real space, A&S erfc);
buck/coul/cut and special-bond factors other than 1 raise.
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
        full = tcellpair.full_offsets(r)
        assert len(full) == 9 * (2 * r + 1) == len(np.unique(full, axis=0))


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
    with pytest.raises(NotImplementedError, match="item 10"):
        tstyles.build_buck(1, COEFFS_1, cut_global=2.5, coul="cut")
    with pytest.raises(NotImplementedError, match="item 13"):
        tstyles.build_buck(1, COEFFS_1, cut_global=2.5, disp="long")
    _, t = _coul_styles(1)
    rsq = torch.full((4,), 2.0, dtype=torch.float64)
    coef = {n: float(t.tables[0, 0, c])
            for c, n in enumerate(tstyles.COEF_NAMES)}
    for f_lj, f_coul in ((0.5, 1.0), (1.0, 0.0)):
        with pytest.raises(NotImplementedError, match="item 12"):
            tstyles.pair_terms(t, rsq, coef, 1.0, -1.0, f_lj, f_coul,
                               eflag=True)
