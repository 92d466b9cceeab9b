"""PPPM of the port against the JAX package (CPU, f64).

Set-up (host numpy): ``setup_pppm`` gives the same mesh, g_ewald, wave
vectors and Green's function to 1e-12, and the deck runner's mesh rule
(``_patch_aligned_smin``) the same points per cell.  Per step:
``CellPPPM.compute_slots`` (the plain deposit, spectral solve and ik
gather the CUDA kernels are held to) against the JAX ``CellPPPM`` patch
pipeline fed the same solver through ``interop.pppm_from_numpy`` and the
same slot planes, in atom order: elong rel 1e-10, virial rel 1e-9,
forces max|df| <= 1e-8 max|f| (the tolerances of
tests/test_pppm_cells.py).  Cases: atoms inside their cells, atoms
drifted up to skin/2 out of the box, and a z-refined grid (reach_z 2)
that the JAX solver sees through its coarse view.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lammps_buck_intel_tpu import run as jrun
from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.models.kspace import CellPPPM as JCellPPPM
from lammps_buck_intel_tpu.models.kspace import pppm as jpppm
from lammps_buck_intel_tpu.models.kspace import setup_pppm as jsetup
from lammps_buck_intel_tpu.neighbor import cell_slots as jcs
from lammps_buck_intel_tpu_torch import run as trun
from lammps_buck_intel_tpu_torch.core import make_box as tmake_box
from lammps_buck_intel_tpu_torch.interop import (pppm_from_numpy,
                                                 slot_state_from_numpy)
from lammps_buck_intel_tpu_torch.models.kspace import CellPPPM
from lammps_buck_intel_tpu_torch.models.kspace import pppm as tpppm
from lammps_buck_intel_tpu_torch.models.kspace import pppm_cells
from lammps_buck_intel_tpu_torch.models.kspace import setup_pppm as tsetup

QQRD2E = 332.06371
L, N, CUT, SKIN = 12.0, 400, 4.0, 1.0


def _charges(seed, n=N):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, L, (n, 3))
    q = rng.uniform(-1, 1, n)
    q -= q.mean()
    return x, q


@pytest.mark.parametrize("order,aligned", [(5, False), (7, False), (7, True)])
def test_setup_pppm_identical(order, aligned):
    x, q = _charges(0)
    lo, hi = [0.0, 0.0, 0.0], [L, L + 1.5, L - 2.0]
    jbox, tbox = jmake_box(lo, hi), tmake_box(lo, hi)
    kw = dict(cutoff=CUT, accuracy_rel=1e-5, qqrd2e=QQRD2E, order=order)
    if aligned:
        nc = (3, 3, 2)
        smin = jrun._patch_aligned_smin(np.asarray(nc), np.asarray(hi), SKIN,
                                        order)
        assert smin == trun._patch_aligned_smin(np.asarray(nc),
                                                np.asarray(hi), SKIN, order)
        kw.update(multiple_of=nc,
                  grid_min=tuple(s * c for s, c in zip(smin, nc)))
    j = jsetup(jbox, q, acc_dtype=jnp.float64, **kw)
    t = tsetup(tbox, q, acc_dtype=torch.float64, **kw)
    assert tuple(j.grid) == t.grid and j.order == t.order
    assert abs(t.g_ewald - j.g_ewald) <= 1e-12 * j.g_ewald
    assert t.g_ewald == tpppm.pppm_g_ewald(tbox, q, CUT, 1e-5, QQRD2E)
    np.testing.assert_allclose(t.greensfn, np.asarray(j.greensfn),
                               rtol=1e-12,
                               atol=1e-12 * np.abs(j.greensfn).max())
    for name in ("kx", "ky", "kz", "h", "box_lo"):
        np.testing.assert_allclose(getattr(t, name),
                                   np.asarray(getattr(j, name)), rtol=1e-12)
    assert abs(t.elong_self - float(j.elong_self)) <= \
        1e-12 * abs(float(j.elong_self))


def test_unported_pppm_options_raise():
    x, q = _charges(0)
    box = tmake_box([0, 0, 0], [L] * 3)
    kw = dict(cutoff=CUT, accuracy_rel=1e-4, qqrd2e=QQRD2E)
    with pytest.raises(NotImplementedError, match="item 10"):
        tsetup(box, q, diff="ad", **kw)
    with pytest.raises(NotImplementedError, match="item 10"):
        tsetup(box, q, slab=3.0, **kw)
    with pytest.raises(NotImplementedError, match="order"):
        tsetup(box, q, order=8, **kw)


@pytest.mark.parametrize("order", [5, 7])
def test_mspline_horner_matches_jax(order):
    u = np.random.default_rng(1).uniform(-0.5, order + 0.5, 2000)
    j = np.asarray(jpppm.mspline_horner(order, jnp.asarray(u)))
    t = tpppm.mspline_horner(order, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-13, atol=1e-15)


def _slots(seed, reach_z=1, drift=False):
    """JAX and port slot states of one charged system, and both solvers
    on the same cell-aligned order-7 mesh."""
    x, q = _charges(seed)
    box = jmake_box([0, 0, 0], [L] * 3)
    grid = jcs.make_grid(N, [L] * 3, CUT, reach_z=reach_z)
    st = jcs.from_atoms(grid, box, x, np.zeros_like(x),
                        np.zeros((N, 3), np.int32), np.zeros(N, np.int32),
                        q, dtype=jnp.float64)
    planes = {k: np.asarray(v) for k, v in
              jax.device_get(st._asdict()).items() if v is not None}
    if drift:
        # between rebins atoms wander up to skin/2 from where they were
        # binned; pull every atom near a face out of the box
        rng = np.random.default_rng(seed)
        valid = planes["aid"] < N
        for k in ("x", "y", "z"):
            p = planes[k]
            d = rng.uniform(-0.5 * SKIN, 0.5 * SKIN, p.shape)
            d = np.where(p < 1.0, -np.abs(d), np.where(p > L - 1.0,
                                                       np.abs(d), d))
            planes[k] = np.where(valid, p + d, p)
        assert (planes["x"][valid] < 0).any() and \
            (planes["z"][valid] > L).any()
        st = st._replace(**{k: jnp.asarray(planes[k])
                            for k in ("x", "y", "z")})
    kgrid = grid.coarse()
    nc = np.asarray(kgrid.nc)
    smin = jrun._patch_aligned_smin(nc, np.asarray([L] * 3), SKIN, 7)
    pm = jsetup(box, q, cutoff=CUT, accuracy_rel=1e-5, qqrd2e=QQRD2E,
                order=7, multiple_of=kgrid.nc,
                grid_min=tuple(int(s * c) for s, c in zip(smin, nc)),
                acc_dtype=jnp.float64)
    tpm = pppm_from_numpy(pm.grid, pm.g_ewald, pm.order, pm.greensfn, pm.kx,
                          pm.ky, pm.kz, pm.qsum, pm.qsqsum, pm.qqrd2e,
                          pm.volume, pm.box_lo, pm.h)
    return (JCellPPPM(pm, grid, skin=SKIN), st, CellPPPM(tpm, N),
            slot_state_from_numpy(planes, device="cpu"))


def _atom_forces(aid, *planes):
    out = np.zeros((N + 1, 3))
    out[np.minimum(aid, N)] = np.stack([np.asarray(p) for p in planes], -1)
    return out[:N]


@pytest.mark.parametrize("case", ["in_cells", "drift", "reach_z2"])
def test_compute_slots_matches_jax(case):
    jsolver, jst, tsolver, tst = _slots(
        seed=2, reach_z=2 if case == "reach_z2" else 1,
        drift=case == "drift")
    # the JAX solver reads the slots through its coarse view; the port's
    # global-mesh solver takes the same planes as they are
    assert jsolver.grid.nslots == tst.x.shape[0] and tsolver.n_atoms == N
    jfx, jfy, jfz, jel, jvir = jsolver.compute_slots(jst, True, True)
    tfx, tfy, tfz, tel, tvir = tsolver.compute_slots(tst, True, True)
    assert tel.dtype == torch.float64 and tfx.shape == tst.x.shape
    aid = np.asarray(jst.aid)
    fj = _atom_forces(aid, jfx, jfy, jfz)
    ft = _atom_forces(aid, tfx, tfy, tfz)
    assert np.abs(fj).max() > 10.0
    assert np.abs(ft - fj).max() <= 1e-8 * np.abs(fj).max()
    assert abs(float(tel) - float(jel)) <= 1e-10 * abs(float(jel))
    vj = np.asarray(jvir)
    np.testing.assert_allclose(tvir.numpy(), vj, rtol=1e-9,
                               atol=1e-9 * np.abs(vj).max())
    # empty slots carry no force
    empty = tst.aid >= N
    assert bool((tfx[empty] == 0).all())


def test_compute_slots_flags():
    _, _, tsolver, tst = _slots(seed=3)
    full = tsolver.compute_slots(tst, True, True)
    f_only = tsolver.compute_slots(tst, False, False)
    for a, b in zip(full[:3], f_only[:3]):
        assert torch.equal(a, b)
    assert float(f_only[3]) == 0.0 and bool((f_only[4] == 0).all())


def test_plain_deposit_conserves_charge():
    _, _, tsolver, tst = _slots(seed=4, drift=True)
    pm = tsolver.pm
    mesh = pppm_cells.deposit_plain(pm, tst)
    assert tuple(mesh.shape) == pm.grid
    assert abs(float(mesh.sum()) - float(tst.q.sum())) <= 1e-12
    assert abs(float(mesh.abs().sum())) > 1.0


# ---- the variable-cell solver (fix npt): TracedPPPM ----

@pytest.mark.parametrize("order", [5, 7])
@pytest.mark.parametrize("dilate", [(1.0, 1.0, 1.0), (1.0, 1.0, 1.02),
                                    (0.97, 1.01, 1.0)])
def test_traced_pppm_matches_jax(order, dilate):
    """TracedPPPM.tables and compute_traced against the JAX package's on
    the generic mesh of a non-cubic box, at the set-up box and dilated
    about its centre: G rel 1e-10 of its largest entry, forces max|df| <=
    1e-10 max|f|, elong and the virial rel 1e-10.  The port solves on the
    rfft half spectrum with half weights, the JAX package on the full
    spectrum: equal elong and virial show the half-spectrum sums equal the
    full ones (with the Nyquist weights of the off-diagonal terms), equal
    forces the Nyquist handling of the ik fields (the meshes are even)."""
    from lammps_buck_intel_tpu.models.kspace.pppm_npt import (
        TracedPPPM as JTraced)
    from lammps_buck_intel_tpu_torch.models.kspace.pppm_npt import (
        TracedPPPM as TTraced)

    x, q = _charges(4)
    lo, hi = np.array([0.0, -1.0, 0.5]), np.array([L, L + 0.5, L - 1.5])
    jbox, tbox = jmake_box(lo, hi), tmake_box(lo, hi)
    kw = dict(cutoff=CUT, accuracy_rel=1e-5, qqrd2e=QQRD2E, order=order)
    j = jsetup(jbox, q, acc_dtype=jnp.float64, **kw)
    t = tsetup(tbox, q, acc_dtype=torch.float64, **kw)
    assert tuple(j.grid) == t.grid and all(n % 2 == 0 for n in t.grid)
    center = lo + 0.5 * (hi - lo)
    jt, tt = JTraced(j, center), TTraced(t, center)
    boxL = (hi - lo) * np.asarray(dilate)
    x = center + (x - lo - 0.5 * (hi - lo)) * np.asarray(dilate)
    jk = jt.tables(jnp.asarray(boxL))
    tk = tt.tables(torch.as_tensor(boxL))
    Gj = np.asarray(jk["G"])
    assert np.abs(tk["G"].numpy() - Gj).max() <= 1e-10 * np.abs(Gj).max()
    nzh = t.grid[2] // 2 + 1
    assert torch.equal(tk["G_half"], tk["G"][..., :nzh])
    for eflag in (True, False):
        jr = jt.compute_traced(jnp.asarray(x), jnp.asarray(q),
                               jnp.asarray(boxL), eflag=eflag, kc=jk)
        tr = tt.compute_traced(torch.as_tensor(x.T.copy()),
                               torch.as_tensor(q), torch.as_tensor(boxL),
                               eflag=eflag, kc=tk)
        fj = np.asarray(jr.f)
        ft = torch.stack(tr.f, -1).numpy()
        assert np.abs(ft - fj).max() <= 1e-10 * np.abs(fj).max()
        vj = np.asarray(jr.virial)
        np.testing.assert_allclose(tr.virial.numpy(), vj, rtol=1e-10,
                                   atol=1e-10 * np.abs(vj).max())
        if eflag:
            ej = float(jr.elong)
            assert abs(float(tr.elong) - ej) <= 1e-10 * abs(ej)
        else:
            assert float(tr.elong) == 0.0


def test_traced_pppm_unported_raise():
    from lammps_buck_intel_tpu_torch.models.kspace.pppm_npt import (
        make_traced_kspace)

    x, q = _charges(0)
    box = tmake_box([0, 0, 0], [L] * 3)
    pm = tsetup(box, q, cutoff=CUT, accuracy_rel=1e-5, qqrd2e=QQRD2E)
    assert make_traced_kspace(pm, [6.0] * 3).grid == pm.grid
    with pytest.raises(NotImplementedError, match="item 13"):
        make_traced_kspace(object(), [6.0] * 3)
