"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: without a CUDA card every test here skips (a CUDA kernel
has no CPU mode; the CPU tests hold the plain versions to the JAX
package instead).  On a machine with a card:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

Small shapes (a 6^3 / 10^3 lattice, a 400-charge PPPM box);
chip_smoke.py makes the same checks at the decks' full size.
Tolerances: f64 1e-11 relative; f32 forces and meshes max|d| <= 1e-4
max|ref| and energy/virial rel 1e-5 (summation order, atomics and FMA
contraction differ); rebin results identical per atom.
"""
import numpy as np
import pytest
import torch

from lammps_buck_intel_tpu_torch import ops
from lammps_buck_intel_tpu_torch.core import make_box
from lammps_buck_intel_tpu_torch.io import lattice
from lammps_buck_intel_tpu_torch.models.kspace import CellPPPM, setup_pppm
from lammps_buck_intel_tpu_torch.models.kspace import pppm_cells
from lammps_buck_intel_tpu_torch.models.pair import build_buck
from lammps_buck_intel_tpu_torch.models.pair.cellpair import (
    compute_cellpair, compute_cellpair_plain)
from lammps_buck_intel_tpu_torch.neighbor import cell_slots as cs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _state(dev, dtype, nlat=6, cut=2.5, reach_z=1, ntypes=1, seed=0,
           coul=False):
    x, lo, hi = lattice.create_atoms("fcc", 0.8442, nlat, nlat, nlat)
    n = len(x)
    rng = np.random.default_rng(seed)
    x = x + rng.uniform(-0.15, 0.15, x.shape)
    box = make_box(lo, hi)
    grid = cs.make_grid(n, box.lengths, cut + 0.3, reach_z=reach_z)
    t = lambda a, dt=dtype: torch.as_tensor(a).to(dev, dt)  # noqa: E731
    st = cs.from_atoms(grid, box, t(x), t(rng.normal(size=(n, 3))),
                       t(np.zeros((n, 3)), torch.int32),
                       t(rng.integers(0, ntypes, n), torch.int32),
                       t(rng.uniform(-1, 1, n)), dtype=dtype)
    coeffs = {(0, 0): (1.0, 0.2, -0.8), (0, 1): (0.9, 0.22, -0.7),
              (1, 1): (1.1, 0.18, -0.9)}
    coeffs = {k: v for k, v in coeffs.items() if max(k) < ntypes}
    style = build_buck(ntypes, coeffs, cut_global=cut, shift=True,
                       coul="long" if coul else "none", qqrd2e=14.399645)
    return grid, box, st, style.replace(g_ewald=1.1) if coul else style


@pytest.mark.parametrize("flt,acc", [(torch.float32, torch.float32),
                                     (torch.float32, torch.float64),
                                     (torch.float64, torch.float64)])
@pytest.mark.parametrize("ntypes,reach_z,coul", [(1, 1, False),
                                                 (2, 2, False),
                                                 (2, 1, True), (1, 2, True)])
def test_cellpair_kernel_matches_plain(cuda, flt, acc, ntypes, reach_z, coul):
    grid, box, st, style = _state(cuda, flt, ntypes=ntypes, reach_z=reach_z,
                                  coul=coul)
    ftol, etol = (1e-11, 1e-11) if flt == torch.float64 else (1e-4, 1e-5)
    before = ops.LAUNCHES["cellpair"]
    k = compute_cellpair(style, grid, box, st, eflag=True, vflag=True,
                         acc_dtype=acc)
    p = compute_cellpair_plain(style, grid, box, st, eflag=True, vflag=True,
                               acc_dtype=acc)
    assert ops.LAUNCHES["cellpair"] == before + 1
    fk, fp = (torch.stack([r.fx, r.fy, r.fz]) for r in (k, p))
    assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
    assert abs(float(k.evdwl - p.evdwl)) <= etol * abs(float(p.evdwl))
    if coul:
        assert abs(float(p.ecoul)) > 1.0
        assert abs(float(k.ecoul - p.ecoul)) <= etol * abs(float(p.ecoul))
    assert float((k.virial - p.virial).abs().max()) <= \
        etol * float(p.virial.abs().max())


def _cells(grid, s):
    """Per-atom cell id from the slot each atom occupies."""
    valid = s.aid < grid.n_atoms
    cell = torch.arange(grid.nslots, device=s.aid.device) // grid.cap
    out = torch.full((grid.n_atoms,), -1, dtype=torch.long,
                     device=s.aid.device)
    out[s.aid[valid].long()] = cell[valid]
    return out


@pytest.mark.parametrize("bufcap", [None, 1])
def test_rebin_kernel_matches_plain(cuda, bufcap):
    grid, box, st, _ = _state(cuda, torch.float32, nlat=10)
    rng = np.random.default_rng(1)
    for p in (st.x, st.y, st.z):
        p += torch.as_tensor(rng.uniform(-0.6, 0.6, p.shape[0])).to(p)
    B = bufcap or cs.move_capacity(grid)
    k = cs.rebin_incremental(grid, box, st.clone(), bufcap=bufcap)
    p = cs._rebin_incremental_plain(grid, box, st.clone(), B)
    ak, ap = cs.to_atoms(grid, k), cs.to_atoms(grid, p)
    for key in ak:
        assert torch.equal(ak[key], ap[key]), key
    n = grid.n_atoms
    for s in (k, p):
        valid = s.aid < n
        assert torch.equal(torch.sort(s.aid[valid].long()).values,
                           torch.arange(n, device=cuda))
        assert bool((s.q[~valid] == 0).all())
        assert not bool(s.overflow)
    assert torch.equal(_cells(grid, k), _cells(grid, p))


def test_kernel_wrappers_reject_bad_input(cuda):
    grid, box, st, style = _state(cuda, torch.float32)
    with pytest.raises(TypeError):
        compute_cellpair(style, grid, box, st._replace(y=st.y.double()))
    with pytest.raises(ValueError):
        compute_cellpair(style, grid, box, st._replace(aid=st.aid.cpu()))
    with pytest.raises(ValueError):
        compute_cellpair(style, grid, box,
                         st._replace(y=torch.stack([st.y, st.y], 1)[:, 0]))
    with pytest.raises(ValueError):
        cs.rebin_incremental(grid, box, st._replace(q=st.q[:-1]))


def _pppm(dev, flt, acc, reach_z=1, n=400, L=12.0, seed=2):
    """A charged box on the card, binned, with an order-7 solver on a
    mesh aligned to its cells; atoms drifted up to 0.5 out of place."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, L, (n, 3))
    q = rng.uniform(-1, 1, n)
    q -= q.mean()
    box = make_box([0, 0, 0], [L] * 3)
    grid = cs.make_grid(n, box.lengths, 4.0, reach_z=reach_z)
    t = lambda a, dt=flt: torch.as_tensor(a).to(dev, dt)  # noqa: E731
    st = cs.from_atoms(grid, box, t(x), t(np.zeros((n, 3))),
                       t(np.zeros((n, 3)), torch.int32),
                       t(np.zeros(n), torch.int32), t(q), dtype=flt)
    for p in (st.x, st.y, st.z):
        p += t(rng.uniform(-0.5, 0.5, p.shape[0]))
    pm = setup_pppm(box, q, cutoff=4.0, accuracy_rel=1e-5, qqrd2e=332.06371,
                    order=7, multiple_of=grid.coarse().nc, acc_dtype=acc)
    return pm, CellPPPM(pm, n), st


def _close(a, b, tol):
    return float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("flt,acc", [(torch.float32, torch.float32),
                                     (torch.float32, torch.float64),
                                     (torch.float64, torch.float64)])
@pytest.mark.parametrize("reach_z", [1, 2])
def test_pppm_kernels_match_plain(cuda, flt, acc, reach_z):
    from lammps_buck_intel_tpu_torch.ops import pppm as pppm_ops

    pm, solver, st = _pppm(cuda, flt, acc, reach_z=reach_z)
    ftol, etol = (1e-11, 1e-11) if flt == torch.float64 else (1e-4, 1e-5)
    c = solver.consts(cuda, flt, acc)
    n = solver.n_atoms
    before = dict(ops.LAUNCHES)
    mesh_k = pppm_ops.deposit(pm, st, n, c["coef"])
    mesh_p = pppm_cells.deposit_plain(pm, st)
    assert _close(mesh_k, mesh_p, ftol)
    rhat = torch.fft.rfftn(mesh_p.to(acc)).contiguous()
    for ev in (False, True):
        ek, esk, vsk = pppm_ops.spectral(c, rhat, ev)
        ep, esp, vsp = pppm_cells.spectral_plain(c, rhat, ev, ev)
        assert _close(torch.view_as_real(ek), torch.view_as_real(ep), ftol)
        if ev:
            assert abs(float(esk - esp)) <= etol * abs(float(esp))
            assert _close(vsk, vsp, etol)
    e_mesh = torch.fft.irfftn(ep, s=pm.grid, dim=(1, 2, 3)).to(flt)
    fk = pppm_ops.gather(pm, st, e_mesh.contiguous(), n, acc, c["coef"])
    fp = pppm_cells.gather_plain(pm, st, e_mesh, acc)
    assert _close(torch.stack(fk), torch.stack(fp), ftol)
    assert bool((fk[0][st.aid >= n] == 0).all())
    for k in ("pppm_deposit", "pppm_gather"):
        assert ops.LAUNCHES[k] == before[k] + 1
    assert ops.LAUNCHES["pppm_spectral"] == before["pppm_spectral"] + 2


def test_pppm_wrappers_reject_bad_input(cuda):
    from lammps_buck_intel_tpu_torch.ops import pppm as pppm_ops

    pm, solver, st = _pppm(cuda, torch.float32, torch.float32)
    c = solver.consts(cuda, torch.float32, torch.float32)
    with pytest.raises(TypeError):
        pppm_ops.deposit(pm, st._replace(q=st.q.double()), 400, c["coef"])
    with pytest.raises(ValueError):
        pppm_ops.deposit(pm, st._replace(aid=st.aid.cpu()), 400, c["coef"])
    rhat = torch.zeros((2, 2, 2), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):
        pppm_ops.spectral(c, rhat, False)
