"""Neighbor lists and the list pair pass of the port against the JAX
package (CPU, f64).

(a) ``build_cell`` (the plain version the CUDA build is held to): every
    atom's neighbor set, after sorting, and its special-bond codes equal
    the JAX ``build_cell``'s on one copy of examples/data.rhodo_class
    (1,728 atoms, 4 cells per axis, the 1-2/1-3/1-4 partner table) and on
    a random two-type ionic box; ``nnei`` equal; ``make_spec`` and
    ``grow`` give the JAX sizes.  The columns are in scan order where the
    JAX package sorts them by distance: the sets, not the order, are
    compared.
(b) A K or cell capacity forced too small raises the overflow flag, and
    ``build_with_retry`` grows past it to the JAX spec.
(c) ``build_dense`` (the plain version K9c is held to) keeps the JAX
    dense build's sets, on a random box and on one copy of the cristobalite
    crystal at the deck's cutneigh (N 1,440, K 536, one cell along z);
    ``needs_rebuild`` answers the JAX package's cases.
(d) ``compute_pair`` (plain) on the JAX list: forces, evdwl, ecoul and
    the virial within 1e-12 relative of the JAX ``driver.compute_pair`` for
    lj/charmm/coul/long with specials (rhodo) and buck/coul/long (the ionic
    box), under the data file's box and under a box dilated by (1, 1,
    1.02), where the minimum image takes the lengths from a tensor; and
    the coul/cut forms of both styles under the data file's box.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_buck_intel_tpu.core import build_topology as jbuild_topology
from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.io import read_data as jread
from lammps_buck_intel_tpu.models.pair import driver as jdriver
from lammps_buck_intel_tpu.models.pair import styles as jstyles
from lammps_buck_intel_tpu.neighbor import neighbor_list as jnl
from lammps_buck_intel_tpu_torch.interop import pair_style_from_numpy
from lammps_buck_intel_tpu_torch.models.pair import driver as tdriver
from lammps_buck_intel_tpu_torch.neighbor import neighbor_list as tnl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "examples", "data.rhodo_class")
QQRD2E = 332.06371


def _rhodo():
    """(x, lo, L, typ, q, special_idx, special_code) of one copy."""
    d = jread(DATA)
    topo = jbuild_topology(d.n_atoms, bonds=d.bonds, angles=d.angles,
                           dihedrals=d.dihedrals, impropers=d.impropers)
    return (np.asarray(d.x, np.float64), np.asarray(d.box_lo, np.float64),
            np.asarray(d.box_hi, np.float64) - np.asarray(d.box_lo),
            np.asarray(d.type, np.int32), np.asarray(d.q, np.float64),
            topo.special_idx, topo.special_code)


def _ionic(n=2400, L=32.0, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5 * L, 0.5 * L, (n, 3))
    typ = rng.integers(0, 2, n).astype(np.int32)
    q = np.where(typ == 0, 1.2, -1.2)
    return (x, np.full(3, -0.5 * L), np.full(3, L), typ, q,
            np.zeros((n, 0), np.int32), np.zeros((n, 0), np.int8))


def _systems(name):
    return _rhodo() if name == "rhodo" else _ionic()


def _jax_list(x, lo, L, spec, sp_idx, sp_code):
    box = jmake_box(lo, lo + L)
    return jnl.build(jnp.asarray(x), box, spec, jnp.asarray(sp_idx),
                     jnp.asarray(sp_code))


def _port_list(x, lo, L, spec, sp_idx, sp_code, fn=tnl.build):
    special = None
    if sp_idx.shape[1]:
        special = (torch.as_tensor(np.asarray(sp_idx, np.int32)),
                   torch.as_tensor(np.asarray(sp_code, np.int32)))
    return fn(torch.as_tensor(x.T.copy()), torch.as_tensor(lo),
              torch.as_tensor(L), spec, special)


def _sets(idx, sb, n):
    """Per atom the sorted (neighbor, code) pairs of a list."""
    idx, sb = np.asarray(idx), np.asarray(sb)
    out = []
    for i in range(idx.shape[0]):
        keep = idx[i] < n
        pairs = sorted(zip(idx[i][keep].tolist(), sb[i][keep].tolist()))
        out.append(pairs)
    return out


@pytest.mark.parametrize("system", ["rhodo", "ionic"])
def test_build_cell_matches_jax(system):
    x, lo, L, typ, q, sp_idx, sp_code = _systems(system)
    n = len(x)
    cut = 13.2 if system == "rhodo" else 6.5
    jspec = jnl.make_spec(n, L, cut)
    tspec = tnl.make_spec(n, L, cut)
    assert (tspec.cutneigh, tspec.kmax, tspec.nc, tspec.cell_cap) == \
        (jspec.cutneigh, jspec.kmax, jspec.nc, jspec.cell_cap)
    assert not tspec.dense and min(tspec.nc) >= 3
    # the clustered molecules outgrow the density-sized K: both grow it
    _, jspec = jnl.build_with_retry(jnp.asarray(x), jmake_box(lo, lo + L),
                                    jspec, jnp.asarray(sp_idx),
                                    jnp.asarray(sp_code))
    _, tspec = _port_list(x, lo, L, tspec, sp_idx, sp_code,
                          fn=tnl.build_with_retry)
    assert (tspec.kmax, tspec.cell_cap) == (jspec.kmax, jspec.cell_cap)
    jl = _jax_list(x, lo, L, jspec, sp_idx, sp_code)
    tl = _port_list(x, lo, L, tspec, sp_idx, sp_code)
    assert not bool(jl.overflow) and not bool(tl.overflow)
    # K-major storage behind the (N, K) view
    assert tl.idx.t().is_contiguous() and tl.sb.t().is_contiguous()
    np.testing.assert_array_equal(tl.nnei.numpy(), np.asarray(jl.nnei))
    assert _sets(tl.idx, tl.sb, n) == _sets(jl.idx, jl.sb, n)
    if system == "rhodo":
        codes = np.asarray(tl.sb)
        assert set(np.unique(codes)) == {0, 1, 2, 3}


@pytest.mark.parametrize("what", ["kmax", "cell_cap"])
def test_overflow_is_raised_and_grown(what):
    import dataclasses

    x, lo, L, typ, q, sp_idx, sp_code = _rhodo()
    n = len(x)
    small = dataclasses.replace(tnl.make_spec(n, L, 13.2), **{what: 8})
    jsmall = dataclasses.replace(jnl.make_spec(n, L, 13.2), **{what: 8})
    tl = _port_list(x, lo, L, small, sp_idx, sp_code)
    jl = _jax_list(x, lo, L, jsmall, sp_idx, sp_code)
    assert bool(tl.overflow) and bool(jl.overflow)
    nl, grown = _port_list(x, lo, L, small, sp_idx, sp_code,
                           fn=tnl.build_with_retry)
    _, jgrown = jnl.build_with_retry(jnp.asarray(x), jmake_box(lo, lo + L),
                                     jsmall, jnp.asarray(sp_idx),
                                     jnp.asarray(sp_code))
    assert not bool(nl.overflow)
    assert (grown.kmax, grown.cell_cap) == (jgrown.kmax, jgrown.cell_cap)


def test_build_dense_matches_jax():
    x, lo, L, typ, q, sp_idx, sp_code = _ionic(n=300, L=12.0)
    spec, jspec = tnl.make_spec(300, L, 4.0), jnl.make_spec(300, L, 4.0)
    assert spec.dense and jspec.dense and spec.kmax == jspec.kmax
    jl = _jax_list(x, lo, L, jspec, sp_idx, sp_code)
    tl = _port_list(x, lo, L, spec, sp_idx, sp_code)
    np.testing.assert_array_equal(tl.nnei.numpy(), np.asarray(jl.nnei))
    assert _sets(tl.idx, tl.sb, 300) == _sets(jl.idx, jl.sb, 300)


def test_build_dense_cristobalite_matches_jax():
    """cristobalite_pppm_nlist.yaml's list on one copy of the crystal
    (jittered): cut 10 + skin 1 on a 28.6 x 35.8 x 21.5 A box, 1 cell along
    z, so make_spec picks the dense build with K 536; the columns hold
    ascending j."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import gen_cristobalite

    x, typ, q, hi = gen_cristobalite.build()
    n = len(x)
    x = np.mod(x + gen_cristobalite.jitter(n, 0.1), hi)
    lo, L = np.zeros(3), hi
    spec, jspec = tnl.make_spec(n, L, 11.0), jnl.make_spec(n, L, 11.0)
    assert n == 1440 and spec.dense and jspec.dense
    assert spec.kmax == jspec.kmax == 536
    none_i, none_c = np.zeros((n, 0), np.int32), np.zeros((n, 0), np.int8)
    jl = _jax_list(x, lo, L, jspec, none_i, none_c)
    tl = _port_list(x, lo, L, spec, none_i, none_c)
    assert not bool(jl.overflow) and not bool(tl.overflow)
    assert tl.idx.t().is_contiguous() and tl.sb.t().is_contiguous()
    np.testing.assert_array_equal(tl.nnei.numpy(), np.asarray(jl.nnei))
    assert _sets(tl.idx, tl.sb, n) == _sets(jl.idx, jl.sb, n)
    idx = tl.idx.numpy()
    for i in range(0, n, 97):
        row = idx[i][idx[i] < n]
        assert (np.diff(row) > 0).all()


def test_needs_rebuild_matches_jax():
    """tests/test_neighbor.py's cases: no move, then one atom moved 0.4
    past the skin / 2 bound of 0.3; and a move across the periodic
    boundary that the minimum image keeps small."""
    rng = np.random.RandomState(3)
    x = rng.uniform(0, 10.0, size=(50, 3))
    jbox = jmake_box([0, 0, 0], [10.0] * 3)
    jspec = jnl.make_spec(50, [10.0] * 3, 3.0, dense=True)
    jl = jnl.build(jnp.asarray(x), jbox, jspec)
    half = (0.6 / 2) ** 2
    L = torch.full((3,), 10.0, dtype=torch.float64)
    x0 = torch.as_tensor(x.T.copy())
    moved = x.copy()
    moved[7, 0] += 0.4
    wrapped = x.copy()
    wrapped[11, 1] += 10.0 - 0.1
    for xn in (x, moved, wrapped):
        want = bool(jnl.needs_rebuild(jnp.asarray(xn), jbox, jl, half))
        got = tnl.needs_rebuild(torch.as_tensor(xn.T.copy()), L, x0, half)
        assert bool(got) == want
    assert [bool(tnl.needs_rebuild(torch.as_tensor(xn.T.copy()), L, x0,
                                   half)) for xn in (x, moved, wrapped)] \
        == [False, True, False]


def _styles(system, coul="long"):
    if system == "rhodo":
        j = jstyles.build_lj_charmm(
            2, {0: (0.08, 3.6, 0.04, 3.4), 1: (0.025, 2.4, 0.02, 2.3)},
            8.0, 10.0, coul=coul, cut_coul=10.0,
            special_lj=(1.0, 0.0, 0.5, 0.25),
            special_coul=(1.0, 0.0, 0.3, 0.8), qqrd2e=QQRD2E)
    else:
        coeffs = {(0, 0): (1388.77, 0.3623, 175.0),
                  (0, 1): (18003.8, 0.2052, 133.5),
                  (1, 1): (2000.0, 0.3, 50.0)}
        j = jstyles.build_buck(2, coeffs, cut_global=6.0, coul=coul,
                               qqrd2e=QQRD2E)
    j = j.replace(g_ewald=0.3)
    cfg = j.cfg
    t = pair_style_from_numpy(
        j.tables, j.special_lj, j.special_coul, j.qqrd2e, j.g_ewald,
        j.cutsq_max, dict(name=cfg.name, vdw=cfg.vdw, coul=cfg.coul,
                          disp=cfg.disp),
        inner_sq=j.inner_sq, denom_lj=j.denom_lj, eps14=j.eps14,
        sig14=j.sig14)
    return j, t


def _compute_pair_case(system, dilate, eflag, coul):
    x, lo, L, typ, q, sp_idx, sp_code = _systems(system)
    n = len(x)
    jstyle, tstyle = _styles(system, coul)
    cut = float(np.sqrt(jstyle.cutsq_max)) + 2.0
    jl, spec = jnl.build_with_retry(
        jnp.asarray(x), jmake_box(lo, lo + L), jnl.make_spec(n, L, cut),
        jnp.asarray(sp_idx), jnp.asarray(sp_code))
    boxL = L * (np.array([1.0, 1.0, 1.02]) if dilate else 1.0)
    if dilate:
        # the variable-cell path: traced box lengths about the centre
        from lammps_buck_intel_tpu.core.box import Box as JBox

        c = lo + 0.5 * L
        jbox = JBox(lo=jnp.asarray(c - 0.5 * boxL),
                    hi=jnp.asarray(c + 0.5 * boxL),
                    periodic=np.array([True, True, True]))
    else:
        jbox = jmake_box(lo, lo + L)
    use_special = sp_idx.shape[1] > 0
    jr = jdriver.compute_pair(jstyle, jnp.asarray(x), typ, q, jbox, jl,
                              eflag=eflag, vflag=True,
                              acc_dtype=jnp.float64, use_special=use_special)
    tl = tnl.NeighborList(idx=torch.as_tensor(np.array(jl.idx)),
                          sb=torch.as_tensor(np.array(jl.sb)),
                          nnei=torch.as_tensor(np.array(jl.nnei)),
                          overflow=torch.tensor(False))
    # the port's minimum image takes the lengths the JAX box holds
    Lt = torch.as_tensor(np.asarray(jbox.lengths, np.float64))
    tr = tdriver.compute_pair(
        tstyle, torch.as_tensor(x.T.copy()), torch.as_tensor(typ),
        torch.as_tensor(q), Lt, tl, eflag=eflag, acc_dtype=torch.float64,
        use_special=use_special)
    fj = np.asarray(jr.f)
    ft = torch.stack([tr.fx, tr.fy, tr.fz], -1).numpy()
    assert np.abs(ft - fj).max() <= 1e-12 * np.abs(fj).max()
    vj = np.asarray(jr.virial)
    np.testing.assert_allclose(tr.virial.numpy(), vj, rtol=1e-12,
                               atol=1e-12 * np.abs(vj).max())
    if eflag:
        for name in ("evdwl", "ecoul"):
            ej = float(getattr(jr, name))
            assert abs(float(getattr(tr, name)) - ej) <= 1e-12 * abs(ej), name
    else:
        assert float(tr.evdwl) == 0.0 and float(tr.ecoul) == 0.0


@pytest.mark.parametrize("system", ["rhodo", "ionic"])
@pytest.mark.parametrize("dilate", [False, True])
@pytest.mark.parametrize("eflag", [False, True])
def test_compute_pair_matches_jax(system, dilate, eflag):
    _compute_pair_case(system, dilate, eflag, "long")


@pytest.mark.parametrize("system", ["rhodo", "ionic"])
@pytest.mark.parametrize("eflag", [False, True])
def test_compute_pair_coul_cut_matches_jax(system, eflag):
    _compute_pair_case(system, False, eflag, "cut")
