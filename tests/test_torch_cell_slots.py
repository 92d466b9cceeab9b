"""Rebin of the port (plain versions, CPU) against the JAX package, f64.

Same displaced slot state into both packages: every atom lands in the same
cell, wrapped positions and image flags are identical, every atom appears
exactly once, vacated slots carry q = 0, the forced full-sort fallback
gives the same per-atom result, and a capacity too small sets overflow.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lammps_buck_intel_tpu.core import make_box
from lammps_buck_intel_tpu.neighbor import cell_slots as jcs
from lammps_buck_intel_tpu_torch.interop import (slot_state_from_numpy,
                                                 slot_state_to_numpy)
from lammps_buck_intel_tpu_torch.io import lattice
from lammps_buck_intel_tpu_torch.neighbor import cell_slots as tcs


def _planes(st):
    return {k: np.array(v) for k, v in
            jax.device_get(st._asdict()).items() if v is not None}


def _setup(cap=None, seed=3):
    """A binned 864-atom state, then displaced: some atoms change cell,
    some leave the box and must wrap.  Returns the JAX grid/box/state and
    the port's grid/state (same planes)."""
    x, lo, hi = lattice.create_atoms("fcc", 0.8442, 6, 6, 6)
    n = len(x)
    rng = np.random.default_rng(seed)
    box = make_box(lo, hi)
    grid = jcs.make_grid(n, box.lengths, 2.8, cap=cap)
    q = rng.uniform(-1.0, 1.0, n)
    v = rng.normal(size=(n, 3))
    jst = jcs.from_atoms(grid, box, x, v, np.zeros((n, 3), np.int32),
                         (np.arange(n) % 2).astype(np.int32), q,
                         dtype=jnp.float64)
    planes = _planes(jst)
    valid = planes["aid"] < n
    for k in ("x", "y", "z"):
        planes[k] = planes[k] + np.where(
            valid, rng.uniform(-1.2, 1.2, planes[k].shape), 0.0)
    jst = jst._replace(**{k: jnp.asarray(planes[k]) for k in ("x", "y", "z")})
    tgrid = tcs.CellGrid(nc=grid.nc, cap=grid.cap, n_atoms=n)
    return box, grid, jst, tgrid, slot_state_from_numpy(planes, device="cpu")


def _per_atom(planes, n, cap):
    aid = planes["aid"]
    valid = aid < n
    count = np.bincount(aid[valid], minlength=n)
    cell = np.full(n, -1)
    cell[aid[valid]] = np.nonzero(valid)[0] // cap
    out = {"count": count, "cell": cell}
    for k in ("x", "y", "z", "ix", "iy", "iz", "vx", "typ", "q"):
        a = np.zeros(n, planes[k].dtype)
        a[aid[valid]] = planes[k][valid]
        out[k] = a
    return out


def _compare(jst, tst, n, cap):
    a = _per_atom(_planes(jst), n, cap)
    b = _per_atom(slot_state_to_numpy(tst), n, cap)
    assert (a["count"] == 1).all() and (b["count"] == 1).all()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    tp = slot_state_to_numpy(tst)
    assert (tp["q"][tp["aid"] >= n] == 0).all()
    assert bool(jst.overflow) == bool(tst.overflow)


@pytest.mark.parametrize("bufcap", [None, 8])
def test_rebin_incremental_matches_jax(bufcap):
    box, grid, jst, tgrid, tst = _setup()
    n = grid.n_atoms
    moved = int((jcs._slot_cid(grid, box, jcs.wrap_state(box, jst))
                 != np.repeat(np.arange(grid.ncell), grid.cap))[
                     np.asarray(jst.aid) < n].sum())
    assert moved > 8   # bufcap=8 takes the full-sort fallback
    jr = jcs.rebin_incremental(grid, box, jst, bufcap=bufcap)
    tr = tcs.rebin_incremental(tgrid, box, tst, bufcap=bufcap)
    _compare(jr, tr, n, grid.cap)
    assert not bool(tr.overflow)
    assert (np.abs(slot_state_to_numpy(tr)["ix"]) > 0).any()  # wraps seen


def test_rebin_full_matches_jax():
    box, grid, jst, tgrid, tst = _setup(seed=5)
    _compare(jcs.rebin(grid, box, jst), tcs.rebin(tgrid, box, tst),
             grid.n_atoms, grid.cap)


def test_from_atoms_to_atoms_match_jax():
    x, lo, hi = lattice.create_atoms("fcc", 0.8442, 6, 6, 6)
    n = len(x)
    box = make_box(lo, hi)
    grid = jcs.make_grid(n, box.lengths, 2.8)
    rng = np.random.default_rng(9)
    v = rng.normal(size=(n, 3))
    q = rng.uniform(size=n)
    img = rng.integers(-2, 3, size=(n, 3)).astype(np.int32)
    typ = np.zeros(n, np.int32)
    jst = jcs.from_atoms(grid, box, x, v, img, typ, q, dtype=jnp.float64)
    tgrid = tcs.CellGrid(nc=grid.nc, cap=grid.cap, n_atoms=n)
    tst = tcs.from_atoms(tgrid, box, torch.as_tensor(x), torch.as_tensor(v),
                         torch.as_tensor(img), torch.as_tensor(typ),
                         torch.as_tensor(q), dtype=torch.float64)
    _compare(jst, tst, n, grid.cap)
    ja = jax.device_get(jcs.to_atoms(grid, jst))
    ta = tcs.to_atoms(tgrid, tst)
    for k in ("x", "v", "image", "typ", "q"):
        assert np.array_equal(np.asarray(ja[k]), ta[k].numpy()), k


@pytest.mark.parametrize("incremental", [False, True])
def test_small_capacity_sets_overflow(incremental):
    box, grid, jst, tgrid, tst = _setup()
    if incremental:
        # pile 60 atoms into cell 0: more arrivals than its free slots
        planes = _planes(jst)
        idx = np.nonzero(planes["aid"] < grid.n_atoms)[0][:60]
        for k, l in zip(("x", "y", "z"), box.lo):
            planes[k][idx] = l + 0.01
        jst = jst._replace(**{k: jnp.asarray(planes[k])
                              for k in ("x", "y", "z")})
        tst = slot_state_from_numpy(planes, device="cpu")
        jr = jcs.rebin_incremental(grid, box, jst, bufcap=grid.nslots)
        tr = tcs.rebin_incremental(tgrid, box, tst, bufcap=grid.nslots)
    else:
        small = jcs.CellGrid(nc=grid.nc, cap=24, n_atoms=grid.n_atoms)
        jr = jcs.rebin(small, box, jst)
        tr = tcs.rebin(tcs.CellGrid(nc=grid.nc, cap=24,
                                    n_atoms=grid.n_atoms), box, tst)
    assert bool(jr.overflow) and bool(tr.overflow)


def test_grid_sizing_matches_jax():
    for n, L, cut, reach in ((864, (10.08,) * 3, 2.8, 1),
                             (192000, (50.39, 67.18, 67.18), 5.3, 2)):
        a = jcs.make_grid(n, L, cut, reach_z=reach)
        b = tcs.make_grid(n, L, cut, reach_z=reach)
        assert (a.nc, a.cap, a.reach_z) == (b.nc, b.cap, b.reach_z)
        assert jcs.grow(a).cap == tcs.grow(b).cap
        assert jcs.grow(a, 300).cap == tcs.grow(b, 300).cap
        assert jcs.move_capacity(a) == tcs.move_capacity(b)
    assert tcs.make_grid(100, (5.0,) * 3, 2.8) is None
