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


def _pppm(dev, flt, acc, reach_z=1, n=400, L=12.0, seed=2, cap=None,
          drift=0.5):
    """A charged box on the card, binned, with an order-7 solver on a
    mesh aligned to its cells and their bricks for a skin of 1.0 (K5 by
    cell); atoms drifted up to ``drift`` out of place (0.5: skin/2)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, L, (n, 3))
    q = rng.uniform(-1, 1, n)
    q -= q.mean()
    box = make_box([0, 0, 0], [L] * 3)
    grid = cs.make_grid(n, box.lengths, 4.0, cap=cap, reach_z=reach_z)
    t = lambda a, dt=flt: torch.as_tensor(a).to(dev, dt)  # noqa: E731
    st = cs.from_atoms(grid, box, t(x), t(np.zeros((n, 3))),
                       t(np.zeros((n, 3)), torch.int32),
                       t(np.zeros(n), torch.int32), t(q), dtype=flt)
    assert not bool(st.overflow)
    for p in (st.x, st.y, st.z):
        p += t(rng.uniform(-drift, drift, p.shape[0]))
    pm = setup_pppm(box, q, cutoff=4.0, accuracy_rel=1e-5, qqrd2e=332.06371,
                    order=7, multiple_of=grid.coarse().nc, acc_dtype=acc)
    bricks = pppm_cells.cell_bricks(pm, grid.coarse().nc, 1.0)
    return pm, CellPPPM(pm, n, bricks=bricks), st


def _close(a, b, tol):
    return float((a - b).abs().max()) <= tol * float(b.abs().max())


# K5 by cell's cases: atoms within skin/2 of their cell; cells of 264
# slots, more than a block's 256 threads; atoms drifted past the bricks'
# margin, so that some slots spill to the mesh directly
PPPM_CASES = {"drift": {}, "cap264": dict(n=5000, cap=264),
              "spill": dict(drift=1.5)}


@pytest.mark.parametrize("flt,acc", [(torch.float32, torch.float32),
                                     (torch.float32, torch.float64),
                                     (torch.float64, torch.float64)])
@pytest.mark.parametrize("reach_z", [1, 2])
@pytest.mark.parametrize("case", list(PPPM_CASES))
def test_pppm_kernels_match_plain(cuda, flt, acc, reach_z, case):
    """K5 in slot order and K5 by cell, K7 and K8 against their plain
    versions; K5 by cell's counters: every charged slot deposited, slots
    spilled only where they drifted past the margin."""
    from lammps_buck_intel_tpu_torch.ops import pppm as pppm_ops
    from lammps_buck_intel_tpu_torch.utils import trace

    pm, solver, st = _pppm(cuda, flt, acc, reach_z=reach_z,
                           **PPPM_CASES[case])
    ftol, etol = (1e-11, 1e-11) if flt == torch.float64 else (1e-4, 1e-5)
    c = solver.consts(cuda, flt, acc)
    n = solver.n_atoms
    before = dict(ops.LAUNCHES)
    mesh_k = pppm_ops.deposit(pm, st, n, c["coef"])
    mesh_p = pppm_cells.deposit_plain(pm, st)
    assert _close(mesh_k, mesh_p, ftol)
    ns = st.x.shape[0]
    assert pppm_cells.takes_bricks(solver.bricks, ns, st.x.element_size())
    trace.enable()
    try:
        c0 = trace.counters()
        mesh_c = pppm_cells.deposit(pm, st, n, c, bricks=solver.bricks)
        c1 = trace.counters()
    finally:
        trace.disable()
    assert _close(mesh_c, mesh_p, ftol)
    dep, spill = (c1[f"pppm.{k}"] - c0[f"pppm.{k}"]
                  for k in ("deposited", "spilled"))
    assert dep == int(((st.aid < n) & (st.q != 0)).sum())
    assert (spill > 0) if case == "spill" else (spill == 0)
    if case == "cap264":
        assert ns // int(np.prod(solver.bricks.nc)) >= 264
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
    for k in ("pppm_deposit", "pppm_deposit_cells", "pppm_gather"):
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
    # K5 by cell: the routing's brick limit is the kernel's; a brick
    # above it, or planes that are not whole cells, are refused
    assert pppm_ops._lib().pppm_brick_bytes() == pppm_cells.BRICK_BYTES
    big = solver.bricks._replace(w=(40, 40, 40))
    with pytest.raises(RuntimeError):
        pppm_ops.deposit_cells(pm, st, 400, c["coef"], big)
    part = st._replace(**{k: getattr(st, k)[:-1] for k in
                          ("x", "y", "z", "q", "aid")})
    with pytest.raises(RuntimeError):
        pppm_ops.deposit_cells(pm, part, 400, c["coef"], solver.bricks)


# ---- the molecular path: examples/data.rhodo_class (1,728 atoms) ----

PRECISIONS = [(torch.float32, torch.float32), (torch.float32, torch.float64),
              (torch.float64, torch.float64)]


def _rhodo(dev, flt):
    """The rhodo-class box binned on the card with lj/charmm/coul/long,
    its special table (non-trivial factors, so every code is seen), its
    bonded style and the slot-of-atom map."""
    import os

    from lammps_buck_intel_tpu_torch.core import build_topology
    from lammps_buck_intel_tpu_torch.io import read_data
    from lammps_buck_intel_tpu_torch.models.bonded import (bake_charmm_14,
                                                           make_bonded)
    from lammps_buck_intel_tpu_torch.models.pair import (build_lj_charmm,
                                                         make_special_table)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = read_data(os.path.join(root, "examples", "data.rhodo_class"))
    n = d.n_atoms
    box = make_box(d.box_lo, d.box_hi)
    grid = cs.make_grid(n, box.lengths, 12.0, cap=56)
    t = lambda a, dt=flt: torch.as_tensor(a).to(dev, dt)  # noqa: E731
    st = cs.from_atoms(grid, box, t(d.x), t(d.v), t(d.image, torch.int32),
                       t(d.type, torch.int32), t(d.q), dtype=flt)
    style = build_lj_charmm(
        2, {0: (0.08, 3.6, 0.04, 3.4), 1: (0.025, 2.4, 0.02, 2.3)}, 8.0, 10.0,
        special_lj=(1.0, 0.0, 0.5, 0.25), special_coul=(1.0, 0.0, 0.3, 0.8),
        qqrd2e=332.06371).replace(g_ewald=0.25)
    topo = build_topology(n, bonds=d.bonds, angles=d.angles,
                          dihedrals=d.dihedrals, impropers=d.impropers)
    table = make_special_table(topo.special_idx, topo.special_code, dev)
    dc = np.array([[1.2, 3, 0.0, 0.5], [0.16, 1, 180.0, 1.0]])
    bonded = make_bonded(
        bonds=d.bonds, angles=d.angles, dihedrals=d.dihedrals,
        impropers=d.impropers, bond_coeffs=[[300.0, 1.53], [340.0, 1.09]],
        angle_coeffs=[[40.0, 117.0, 5.0, 2.64], [20.0, 105.0, 0.0, 0.0]],
        angle_style="charmm", dihedral_coeffs=dc,
        improper_coeffs=[[5.0, 158.0]],
        d14=bake_charmm_14(d.dihedrals, dc, d.type, d.q, style.eps14,
                           style.sig14, 332.06371))
    inv = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    inv[st.aid.long()] = torch.arange(grid.nslots, dtype=torch.int32,
                                      device=dev)
    return grid, box, st, style, table, bonded, inv


def _buck_special(style, coul):
    """A 2-type Buckingham style in real units with the lj/charmm style's
    special factors: the kernel's buck and buck/coul/long variants with a
    partner table."""
    buck = build_buck(2, {(0, 0): (9.0e4, 0.28, 600.0),
                          (0, 1): (2.5e4, 0.27, 150.0),
                          (1, 1): (4.0e3, 0.26, 30.0)}, cut_global=10.0,
                      shift=True, coul="long" if coul else "none",
                      qqrd2e=332.06371)
    buck = buck.replace(special_lj=style.special_lj,
                        special_coul=style.special_coul)
    return buck.replace(g_ewald=0.25) if coul else buck


@pytest.mark.parametrize("flt,acc", PRECISIONS)
@pytest.mark.parametrize("vdw,special", [
    ("ljcharmm", False), ("ljcharmm", True), ("buck", True),
    ("buck/coul/long", True)])
def test_cellpair_ljcharmm_special_kernel_matches_plain(cuda, flt, acc, vdw,
                                                        special):
    grid, box, st, style, table, _, _ = _rhodo(cuda, flt)
    table = table if special else None
    if vdw != "ljcharmm":
        style = _buck_special(style, vdw == "buck/coul/long")
    ftol, etol = (1e-11, 1e-11) if flt == torch.float64 else (1e-4, 1e-5)
    before = ops.LAUNCHES["cellpair"]
    k = compute_cellpair(style, grid, box, st, eflag=True, vflag=True,
                         acc_dtype=acc, special=table)
    p = compute_cellpair_plain(style, grid, box, st, eflag=True, vflag=True,
                               acc_dtype=acc, special=table)
    assert ops.LAUNCHES["cellpair"] == before + 1
    fk, fp = (torch.stack([r.fx, r.fy, r.fz]) for r in (k, p))
    assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
    for name in ("evdwl", "ecoul") if vdw != "buck" else ("evdwl",):
        a, b = float(getattr(k, name)), float(getattr(p, name))
        assert abs(b) > 1.0 and abs(a - b) <= etol * abs(b), name
    assert float((k.virial - p.virial).abs().max()) <= \
        etol * float(p.virial.abs().max())
    if special:
        bare = compute_cellpair(style, grid, box, st, acc_dtype=acc)
        assert float((bare.fx - k.fx).abs().max()) > 1.0
    f_only = compute_cellpair(style, grid, box, st, acc_dtype=acc,
                              special=table)
    assert float((f_only.fx - k.fx).abs().max()) <= ftol * float(
        fp.abs().max())


@pytest.mark.parametrize("flt,acc", PRECISIONS)
@pytest.mark.parametrize("kernel", ["bonded_bond_angle", "dihedral_charmm",
                                    "improper_harmonic", "all"])
def test_bonded_kernels_match_plain(cuda, flt, acc, kernel):
    """f64 to 1e-11; f32 forces 1e-4 of max|f| (the atomics' order of
    arrival decides the last bit), energies and virial 1e-5.  The f32
    improper is compared where the data sits: chi0 = 158 degrees keeps
    every term away from the kink of |phi| at planarity."""
    from lammps_buck_intel_tpu_torch.models.bonded import (
        compute_bonded, compute_bonded_plain, make_bonded)

    grid, box, st, _, _, b, inv = _rhodo(cuda, flt)
    style = {
        "bonded_bond_angle": make_bonded(
            bonds=b.bonds, angles=b.angles, bond_coeffs=b.bond_coeffs,
            angle_coeffs=b.angle_coeffs, angle_style="charmm"),
        "dihedral_charmm": make_bonded(
            dihedrals=b.dihedrals, dihedral_coeffs=b.dihedral_coeffs,
            d14=b.d14),
        "improper_harmonic": make_bonded(
            impropers=b.impropers, improper_coeffs=b.improper_coeffs),
        "all": b}[kernel]
    ftol, etol = (1e-11, 1e-11) if flt == torch.float64 else (1e-4, 1e-5)
    xs = (st.x, st.y, st.z)
    names = (("bonded_bond_angle", "dihedral_charmm", "improper_harmonic")
             if kernel == "all" else (kernel,))
    before = {n: ops.LAUNCHES[n] for n in names}
    k = compute_bonded(style, xs, box, eflag=True, acc_dtype=acc, inv=inv)
    p = compute_bonded_plain(style, xs, box, eflag=True, acc_dtype=acc,
                             inv=inv)
    assert all(ops.LAUNCHES[n] == before[n] + 1 for n in names)
    fk, fp = (torch.stack([r.fx, r.fy, r.fz]) for r in (k, p))
    assert float(fp.abs().max()) > 1.0
    assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
    for name in ("ebond", "eangle", "edihed", "eimp", "e14_lj", "e14_coul"):
        a, ref = float(getattr(k, name)), float(getattr(p, name))
        assert abs(a - ref) <= etol * abs(ref), name
    assert float(p.emol) > 1.0
    assert float((k.virial - p.virial).abs().max()) <= \
        etol * float(p.virial.abs().max())
    # force-only into the caller's planes: added, not overwritten
    out = tuple(torch.ones_like(st.x, dtype=acc) for _ in range(3))
    fo = compute_bonded(style, xs, box, eflag=False, acc_dtype=acc, inv=inv,
                        out=out)
    assert fo.fx is out[0] and float(fo.emol) == 0.0
    assert float((torch.stack(out) - 1.0 - fp).abs().max()) <= \
        max(ftol, 1e-6) * float(fp.abs().max())


@pytest.mark.parametrize("flt,acc", [(torch.float32, torch.float32),
                                     (torch.float32, torch.float64),
                                     (torch.float64, torch.float64)])
@pytest.mark.parametrize("kind,phi_deg", [("trans", 180.0), ("cis", 0.0)])
def test_bonded_kernels_take_lammps_angle(cuda, flt, acc, kind, phi_deg):
    """K14b, K14c and K18b on a planar chain 1-2-3-4 give LAMMPS' angle
    (trans 180 degrees, cis 0): with K = 1, n = 1, d = 0 the dihedral
    energy is 1 + cos(phi), and an improper with chi0 = the chain's angle
    has no energy and no force, as their plain versions give."""
    from lammps_buck_intel_tpu_torch.models.bonded import (
        compute_bonded, compute_bonded_peratom, compute_bonded_peratom_plain,
        compute_bonded_plain, make_bonded)

    y4 = 1.0 if kind == "cis" else -1.0
    # a chain per copy, 64 copies 6 A apart, so that each kernel runs
    # more than one warp
    chain = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0],
                      [3.0, y4, 0.0]])
    x = np.concatenate([chain + [6.0 * k, 0.0, 0.0] for k in range(64)])
    box = make_box(np.zeros(3), np.array([384.0, 20.0, 20.0]))
    quads = np.arange(4 * 64).reshape(64, 4)
    style = make_bonded(
        dihedrals=np.concatenate([np.zeros((64, 1), int), quads], 1),
        dihedral_coeffs=[[1.0, 1, 0.0, 0.0]],
        impropers=np.concatenate([np.zeros((64, 1), int), quads], 1),
        improper_coeffs=[[1.0, phi_deg]])
    xs = tuple(torch.as_tensor(x[:, a] + 5.0).to(cuda, flt)
               for a in range(3))
    k = compute_bonded(style, xs, box, eflag=True, acc_dtype=acc)
    p = compute_bonded_plain(style, xs, box, eflag=True, acc_dtype=acc)
    want = 64 * (1.0 + np.cos(np.radians(phi_deg)))
    tol = 1e-9 if flt == torch.float64 else 1e-4
    for r in (k, p):
        assert abs(float(r.edihed) - want) <= tol * 64
        assert abs(float(r.eimp)) <= 64 * 1e-6
        f = torch.stack([r.fx, r.fy, r.fz])
        assert float(f.abs().max()) <= tol
    for include in (("dihedral",), ("dihedral", "improper")):
        ek, _, _, _ = compute_bonded_peratom(style, xs, box, acc_dtype=acc,
                                             include=include)
        ep, _, _, _ = compute_bonded_peratom_plain(
            style, xs, box, acc_dtype=acc, include=include)
        assert float((ek - ep).abs().max()) <= tol
    assert abs(float(ek.sum()) - float(p.edihed + p.eimp)) <= tol * 64



@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_improper_kernels_follow_the_energy_near_planar(cuda, flt, acc):
    """K14c and K18b 2e-4 rad from a planar trans improper, inside the
    JAX package's arccos clip (which gives no force there), against their
    plain versions: the force of K (|phi| - chi0)^2 at the deck's chi0 of
    158 degrees, whose kink at 180 degrees the runs cross."""
    from lammps_buck_intel_tpu_torch.models.bonded import (
        compute_bonded, compute_bonded_peratom, compute_bonded_peratom_plain,
        compute_bonded_plain, make_bonded)

    chain = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0],
                      [3.0, -1.0, 2e-4]])
    x = np.concatenate([chain + [6.0 * k, 0.0, 0.0] for k in range(64)])
    box = make_box(np.zeros(3), np.array([384.0, 20.0, 20.0]))
    quads = np.arange(4 * 64).reshape(64, 4)
    style = make_bonded(
        impropers=np.concatenate([np.zeros((64, 1), int), quads], 1),
        improper_coeffs=[[5.0, 158.0]])
    xs = tuple(torch.as_tensor(x[:, a] + 5.0).to(cuda, flt)
               for a in range(3))
    k = compute_bonded(style, xs, box, eflag=True, acc_dtype=acc)
    p = compute_bonded_plain(style, xs, box, eflag=True, acc_dtype=acc)
    tol = 1e-9 if flt == torch.float64 else 1e-4
    fk, fp = (torch.stack([r.fx, r.fy, r.fz]) for r in (k, p))
    assert float(fp.abs().max()) > 1.0
    assert float((fk - fp).abs().max()) <= tol * float(fp.abs().max())
    assert abs(float(k.eimp) - float(p.eimp)) <= tol * float(p.eimp)
    ek, vk, _, _ = compute_bonded_peratom(style, xs, box, acc_dtype=acc)
    ep, vp, _, _ = compute_bonded_peratom_plain(style, xs, box,
                                                acc_dtype=acc)
    assert float((ek - ep).abs().max()) <= tol * float(ep.abs().max())
    assert float((vk - vp).abs().max()) <= tol * float(vp.abs().max())

def test_bonded_wrapper_rejects_bad_input(cuda):
    from lammps_buck_intel_tpu_torch.models.bonded import compute_bonded

    grid, box, st, _, _, b, inv = _rhodo(cuda, torch.float32)
    xs = (st.x, st.y, st.z)
    with pytest.raises(TypeError):
        compute_bonded(b, xs, box, acc_dtype=torch.float32, inv=inv.long())
    with pytest.raises(TypeError):
        compute_bonded(b, (st.x, st.y.double(), st.z), box,
                       acc_dtype=torch.float32, inv=inv)
    with pytest.raises(TypeError):
        compute_bonded(b, xs, box, acc_dtype=torch.float32, inv=inv,
                       out=tuple(torch.zeros_like(st.x, dtype=torch.float64)
                                 for _ in range(3)))


# ---- the integrator: csrc/verlet.cu ----


def _slot_planes(dev, flt, acc, ns=5000, n=3100, seed=5):
    """Random slot planes with empty slots (zero v, as the engine keeps
    them), three masses, two acc-typed force sets."""
    rng = np.random.default_rng(seed)
    slot = rng.permutation(ns)[:n]
    aid = np.full(ns, n, np.int32)
    aid[slot] = np.arange(n)
    typ = np.where(aid < n, rng.integers(0, 3, ns), 0).astype(np.int32)
    occ = (aid < n)[None]

    def planes(scale, dt, masked=True):
        a = rng.normal(size=(3, ns)) * scale
        a = a * occ if masked else a
        return tuple(torch.as_tensor(a).to(dev, dt).contiguous())

    xs, vs, fs = planes(5.0, flt, False), planes(5e-3, flt), planes(20., flt)
    fa, fb = planes(20.0, acc), planes(3.0, acc)
    mass_t = torch.as_tensor([12.011, 1.008, 15.9994]).to(dev, flt)
    return dict(xs=xs, vs=vs, fs=fs, fa=fa, fb=fb, mass_t=mass_t,
                minv_t=1.0 / mass_t, n=n,
                typ=torch.as_tensor(typ).to(dev),
                aid=torch.as_tensor(aid).to(dev))


def _clone(planes):
    return tuple(p.clone() for p in planes)


@pytest.mark.parametrize("flt,acc", PRECISIONS)
@pytest.mark.parametrize("with_fb", [False, True])
def test_verlet_kernels_match_plain(cuda, flt, acc, with_fb):
    """kick_drift and kick are built without FMA contraction and round
    like the plain version: positions, velocities and forces to 1e-6 of
    their magnitude in f32 (1e-14 in f64); the kinetic partials sum in
    another order: rel 1e-5 in f32 acc, 1e-12 in f64."""
    from lammps_buck_intel_tpu_torch.integrate import nve

    d = _slot_planes(cuda, flt, acc)
    tol = 1e-14 if flt == torch.float64 else 1e-6
    stol = 1e-12 if acc == torch.float64 else 1e-5
    dtf, dtv = 0.5 * 4.184e-4, 1.0
    kx, kv, kf = _clone(d["xs"]), _clone(d["vs"]), _clone(d["fs"])
    px, pv, pf = _clone(d["xs"]), _clone(d["vs"]), _clone(d["fs"])
    tail = (d["typ"], d["aid"], d["minv_t"])
    before = dict(ops.LAUNCHES)
    nve.kick_drift(kx, kv, kf, *tail, d["n"], dtf, dtv)
    nve.kick_drift_plain(px, pv, pf, *tail, d["n"], dtf, dtv)
    fb = d["fb"] if with_fb else None
    kp = nve.kick(kv, kf, d["fa"], fb, *tail, d["mass_t"], d["n"], dtf, acc,
                  ke=True)
    pp = nve.kick_plain(pv, pf, d["fa"], fb, *tail, d["mass_t"], d["n"], dtf,
                        acc, True)
    kk = nve.kinetic(kv, d["typ"], d["aid"], d["mass_t"], d["n"], acc)
    for name in ("verlet_kick_drift", "verlet_kick", "verlet_ke"):
        assert ops.LAUNCHES[name] == before[name] + 1
    for a, b in ((kx, px), (kv, pv), (kf, pf)):
        assert _close(torch.stack(a), torch.stack(b), tol)
    assert not bool(torch.equal(torch.stack(kv), torch.stack(d["vs"])))
    for part in (kp, kk):
        assert part.shape[1] == 2 and part.dtype == acc
        assert abs(float(part[:, 0].sum() - pp[:, 0].sum())) <= \
            stol * float(pp[:, 0].sum())
        assert abs(float(part[:, 1].max() - pp[:, 1].max())) <= \
            tol * float(pp[:, 1].max())
    assert nve.kick(kv, kf, d["fa"], fb, *tail, d["mass_t"], d["n"], 0.0,
                    acc) is None


@pytest.mark.parametrize("flt,acc", PRECISIONS)
@pytest.mark.parametrize("tchain", [1, 3])
def test_nhc_scale_kernel_matches_plain(cuda, flt, acc, tchain):
    """The chain half step and the velocity scale against nhc_half's torch
    ops on the card: chain and velocities rel 1e-5 in f32 (expf against
    torch.exp, the kinetic sum in another order), 1e-11 in f64."""
    from lammps_buck_intel_tpu_torch.integrate import nve, nvt

    d = _slot_planes(cuda, flt, acc)
    tol = 1e-11 if flt == torch.float64 else 1e-5
    cfg = nvt.NVTConfig(t_start=300.0, t_stop=300.0, t_damp=50.0,
                        tchain=tchain, dof=3 * d["n"] - 3,
                        boltz=0.0019872067, mvv2e=2390.0573615334906, dt=1.0)
    therm = torch.zeros((2, tchain), dtype=flt, device=cuda)
    therm[0], therm[1] = 0.02, 1.5e-3
    kv, pv = _clone(d["vs"]), _clone(d["vs"])
    kt, pt = therm.clone(), therm.clone()
    before = ops.LAUNCHES["nhc_scale"]
    for _ in range(3):     # a chain in motion
        args = (d["typ"], d["aid"], d["mass_t"], d["n"], acc)
        kt = nvt.nhc_scale(cfg, kt, kv, nve.kinetic(kv, *args), 310.0)
        pt = nvt.nhc_scale_plain(cfg, pt, pv, nve.kinetic_plain(pv, *args),
                                 310.0)
    assert ops.LAUNCHES["nhc_scale"] == before + 3
    assert torch.equal(therm, torch.stack([torch.full_like(therm[0], 0.02),
                                           torch.full_like(therm[1], 1.5e-3)]))
    assert _close(kt, pt, tol) and not _close(pt, therm, 1e-3)
    assert _close(torch.stack(kv), torch.stack(pv), tol)
    assert not _close(torch.stack(pv), torch.stack(d["vs"]), 1e-4)


def test_verlet_wrappers_reject_bad_input(cuda):
    from lammps_buck_intel_tpu_torch.integrate import nve

    d = _slot_planes(cuda, torch.float32, torch.float32)
    tail = (d["typ"], d["aid"], d["minv_t"])
    with pytest.raises(TypeError):
        nve.kick_drift(d["xs"], d["vs"], d["fs"][:2] + (d["fs"][2].double(),),
                       *tail, d["n"], 1e-4, 1.0)
    with pytest.raises(ValueError):
        nve.kick_drift(d["xs"], d["vs"], d["fs"], d["typ"][:-1], d["aid"],
                       d["minv_t"], d["n"], 1e-4, 1.0)
    with pytest.raises(TypeError):
        nve.kick(d["vs"], d["fs"], d["fa"], None, *tail, d["mass_t"], d["n"],
                 1e-4, torch.float64)


# ---- the constraints: csrc/shake.cu ----


def _molecule(kind):
    """(local positions, constraints, masses) of one synthetic cluster:
    a C-H bond (C = 1), a rigid water (C = 3) or an octahedron held by its
    12 edges (C = 12, A = 6)."""
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


SHAKE_KINDS = {"ch": ["ch"], "water": ["water"], "octahedron": ["octahedron"],
               "mixed": ["ch", "water", "octahedron"]}


def _shake_case(dev, flt, acc, kind, copies=40, L=20.0, seed=11):
    """Synthetic clusters, randomly rotated and placed in a periodic box
    (some straddle its faces), in slot layout with empty slots: the port's
    tables, the slot-of-atom map (row N an empty slot) and slot planes of
    the step's start and end positions, velocities and two acc force
    sets."""
    from lammps_buck_intel_tpu_torch.integrate import shake

    rng = np.random.default_rng(seed)
    pairs, d2, masses, xs = [], [], [], []
    for _ in range(copies):
        for k in SHAKE_KINDS[kind]:
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
    sc = shake.ShakeConstraints(pairs=np.asarray(pairs, np.int32),
                                d2=np.asarray(d2), invm=1.0 / np.asarray(
                                    masses), iters=30)
    cl = shake.make_clusters(sc)
    ns = n + 57
    slot = rng.permutation(ns)[:n]
    empty = np.setdiff1d(np.arange(ns), slot)
    inv = np.append(slot, empty[-1]).astype(np.int32)

    def planes(a, dt, fill=0.0):
        p = np.full((ns, 3), fill)
        p[slot] = a
        return tuple(torch.as_tensor(p[:, c].copy()).to(dev, dt)
                     for c in range(3))

    x_new = x_old + 0.05 * rng.normal(size=x_old.shape)
    return dict(
        sc=sc, cl=cl, t=cl.tables_on(dev, flt), L=np.full(3, L),
        inv=torch.as_tensor(inv).to(dev), slot=slot,
        xo=planes(x_old % L, flt, 7.0), xn=planes(x_new % L, flt, 7.0),
        v=planes(0.1 * rng.normal(size=x_old.shape), flt),
        fa=planes(30.0 * rng.normal(size=x_old.shape), acc),
        fb=planes(3.0 * rng.normal(size=x_old.shape), acc))


@pytest.mark.parametrize("flt,acc", PRECISIONS)
@pytest.mark.parametrize("kind", list(SHAKE_KINDS))
def test_shake_kernels_match_plain(cuda, flt, acc, kind):
    """K13a-d against their plain versions on the card.  The library is
    built without FMA contraction, so the two round alike and differ only
    where a sum runs in another order.  f64: rel 1e-12 of each output's
    magnitude.  f32: the bond vectors and the virial rel 1e-5; positions
    within 4 ulp of the largest coordinate; velocities within 4 ulp of the
    largest coordinate over dt (v += (x_fix - x_new) / dt turns one ulp of
    a position into that much velocity) plus rel 1e-5."""
    from lammps_buck_intel_tpu_torch.integrate import shake

    d = _shake_case(cuda, flt, acc, kind)
    t, inv, L, dt = d["t"], d["inv"], d["L"], 0.7
    f64 = flt == torch.float64
    rtol = 1e-12 if f64 else 1e-5
    ulp = float(torch.finfo(flt).eps) * float(L[0])
    xtol, vtol = (0.0, 0.0) if f64 else (4 * ulp, 4 * ulp / dt)
    before = dict(ops.LAUNCHES)

    def close(a, b, tol, abs_tol=0.0):
        a, b = torch.stack(list(a)), torch.stack(list(b))
        return float((a - b).abs().max()) <= tol * float(b.abs().max()) + \
            abs_tol

    ro_k = shake.shake_ref(t, d["xo"], inv, L)
    ro_p = shake.shake_ref_plain(t, d["xo"], inv, L)
    assert close(ro_k, ro_p, rtol)
    kx, kv = _clone(d["xn"]), _clone(d["v"])
    px, pv = _clone(d["xn"]), _clone(d["v"])
    rn_k = shake.shake_positions(t, ro_k, kx, kv, inv, L, dt, 30)
    rn_p = shake.shake_positions_plain(t, ro_p, px, pv, inv, L, dt, 30)
    assert close(rn_k, rn_p, rtol)
    assert close(kx, px, rtol, xtol) and close(kv, pv, rtol, vtol)
    assert not close(kx, d["xn"], 1e-6)
    # empty slots keep their planes
    occ = torch.zeros(d["xn"][0].shape[0], dtype=torch.bool, device=cuda)
    occ[torch.as_tensor(d["slot"], device=cuda)] = True
    for a, b in ((kx, d["xn"]), (kv, d["v"])):
        assert torch.equal(torch.stack(a)[:, ~occ], torch.stack(b)[:, ~occ])
    # positions only (the set-up settle), then RATTLE along rn and along
    # the positions
    sx = _clone(d["xn"])
    shake.shake_positions(t, ro_k, sx, None, inv, L, dt, 30)
    assert torch.equal(torch.stack(sx), torch.stack(kx))
    shake.rattle_velocities(t, kv, inv, L, r=rn_k)
    shake.rattle_velocities_plain(t, pv, inv, L, r=rn_p)
    assert close(kv, pv, rtol, vtol)
    kv2, pv2 = _clone(d["v"]), _clone(d["v"])
    shake.rattle_velocities(t, kv2, inv, L, xs=kx)
    shake.rattle_velocities_plain(t, pv2, inv, L, xs=px)
    assert close(kv2, pv2, rtol, vtol)
    for fb in (None, d["fb"]):
        wk = shake.shake_virial(t, kx, kv, d["fa"], fb, inv, L, 0.3, acc)
        wp = shake.shake_virial_plain(t, px, pv, d["fa"], fb, inv, L, 0.3,
                                      acc)
        assert wk.dtype == acc and close([wk], [wp], rtol)
        assert float(wp.abs().max()) > 1.0
    for name, k in (("shake_ref", 1), ("shake_positions", 2),
                    ("rattle_velocities", 2), ("shake_virial", 2)):
        assert ops.LAUNCHES[name] == before[name] + k


def test_shake_wrappers_reject_bad_input(cuda):
    from lammps_buck_intel_tpu_torch.integrate import shake
    from lammps_buck_intel_tpu_torch.ops import shake as shake_ops

    d = _shake_case(cuda, torch.float32, torch.float32, "water", copies=4)
    t, inv, L = d["t"], d["inv"], d["L"]
    with pytest.raises(TypeError):
        shake_ops.shake_ref(t, d["xo"], inv.long(), L)
    with pytest.raises(TypeError):
        shake_ops.shake_ref(t, d["xo"][:2] + (d["xo"][2].double(),), inv, L)
    with pytest.raises(ValueError):
        shake_ops.shake_ref(t, tuple(p.cpu() for p in d["xo"]), inv, L)
    wide = dict(t, pi=torch.zeros((13, t["pi"].shape[1]), dtype=torch.int32,
                                  device=cuda))
    with pytest.raises(ValueError, match="at most 12"):
        shake_ops.shake_ref(wide, d["xo"], inv, L)
    with pytest.raises(ValueError):
        shake_ops.shake_positions(t, torch.zeros(3, 1, 1, device=cuda),
                                  d["xn"], d["v"], inv, L, 1.0, 4)
    with pytest.raises(TypeError):
        shake.shake_virial(t, d["xn"], d["v"], d["fa"], None, inv, L, 0.3,
                           torch.float16)


# ---- fix npt: the neighbor list (K9), the variable cell (K16) and the
# ported kernels with the box on the card ----

def _npt_sim(cuda, prec):
    """rhodo_npt.yaml on one copy of the data file, on the card."""
    import os

    import yaml

    from lammps_buck_intel_tpu_torch.run import build_simulation

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "examples", "decks", "rhodo_npt.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(read_data=os.path.join(root, cfg["read_data"]),
               replicate=[1, 1, 1], precision=prec)
    return build_simulation(cfg, device=cuda)


@pytest.mark.parametrize("prec", ["single", "double"])
def test_nlist_kernels_match_plain(cuda, prec):
    from lammps_buck_intel_tpu_torch.core.box import traced_lo
    from lammps_buck_intel_tpu_torch.models.pair import driver
    from lammps_buck_intel_tpu_torch.neighbor import neighbor_list as nlm

    sim = _npt_sim(cuda, prec)
    x, boxL = sim.state.x, sim.state.boxL * torch.tensor(
        [1.0, 1.0, 1.01], device=cuda, dtype=sim.state.boxL.dtype)
    lo = traced_lo(sim._center, boxL)
    before = dict(ops.LAUNCHES)
    nk = nlm.build_cell(x, lo, boxL, sim.spec, sim._special)
    npl = nlm.build_cell_plain(x, lo, boxL, sim.spec, sim._special)
    assert torch.equal(nk.idx, npl.idx) and torch.equal(nk.sb, npl.sb)
    assert torch.equal(nk.nnei, npl.nnei) and not bool(nk.overflow)
    import dataclasses

    small = dataclasses.replace(sim.spec, kmax=16)
    assert bool(nlm.build_cell(x, lo, boxL, small, sim._special).overflow)
    ftol, etol = (1e-4, 1e-5) if prec == "single" else (1e-11, 1e-11)
    for ev in (False, True):
        args = (sim.pair, x, sim.typ, sim.q, boxL, nk)
        kw = dict(eflag=ev, acc_dtype=sim.precision.acc, use_special=True)
        rk = driver.compute_pair(*args, **kw)
        rp = driver.compute_pair_plain(*args, **kw)
        fk, fp = torch.stack(rk[:3]), torch.stack(rp[:3])
        assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
        assert float((rk.virial - rp.virial).abs().max()) <= \
            etol * float(rp.virial.abs().max())
        if ev:
            for e in ("evdwl", "ecoul"):
                assert abs(float(getattr(rk, e) - getattr(rp, e))) <= \
                    etol * abs(float(getattr(rp, e)))
    assert ops.LAUNCHES["nlist_build"] == before["nlist_build"] + 2
    assert ops.LAUNCHES["nlist_pair"] == before["nlist_pair"] + 2


@pytest.mark.parametrize("prec", ["single", "double"])
def test_npt_kernels_match_plain(cuda, prec):
    from lammps_buck_intel_tpu_torch.integrate import npt
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_npt

    sim = _npt_sim(cuda, prec)
    st, acc = sim.state, sim.precision.acc
    rtol = 1e-5 if prec == "single" else 1e-11
    boxL = st.boxL * torch.tensor([1.0, 1.0, 1.02], device=cuda,
                                  dtype=st.boxL.dtype)
    tp = sim.kspace
    Gk = tp.tables(boxL)["G"]
    Gp = pppm_npt.traced_greens_plain(tp.consts(cuda, st.x.dtype), boxL,
                                      tp.g_ewald)
    assert float((Gk - Gp).abs().max()) <= rtol * float(Gp.abs().max())
    vs = tuple(st.v.unbind(0))
    kk = npt.ke3(vs, sim.typ, sim._mass_t, acc).sum(0)
    kp = npt.ke3_plain(vs, sim.typ, sim._mass_t, acc).sum(0)
    assert float((kk - kp).abs().max()) <= rtol * float(kp.abs().max())
    vfac = torch.tensor([0.99, 1.0, 1.01], device=cuda, dtype=st.v.dtype)
    vk, vp = st.v.clone(), st.v.clone()
    npt.vscale_kick(tuple(vk.unbind(0)), tuple(st.f.unbind(0)), sim.typ,
                    sim._minv_t, vfac, sim.dtf)
    npt.vscale_kick_plain(tuple(vp.unbind(0)), tuple(st.f.unbind(0)),
                          sim.typ, sim._minv_t, vfac, sim.dtf)
    assert torch.equal(vk, vp) and not torch.equal(vk, st.v)
    xk, xp = st.x.clone(), st.x.clone()
    npt.drift_dilate(tuple(xk.unbind(0)), vs, vfac, sim._center, 1.0)
    npt.drift_dilate_plain(tuple(xp.unbind(0)), vs, vfac, sim._center, 1.0)
    assert torch.equal(xk, xp)
    # the traced PPPM on the card against the plain version on the CPU
    rk = tp.compute_traced(st.x, sim.q, boxL, kc=tp.tables(boxL))
    Lc = boxL.cpu()
    rp = tp.compute_traced(st.x.cpu(), sim.q.cpu(), Lc, kc=tp.tables(Lc))
    fk, fp = torch.stack(rk.f).cpu(), torch.stack(rp.f)
    ftol = 1e-4 if prec == "single" else 1e-10
    assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
    assert abs(float(rk.elong.cpu() - rp.elong)) <= \
        ftol * abs(float(rp.elong))


@pytest.mark.parametrize("prec", ["single", "double"])
def test_shake_and_bonded_with_box_on_the_card(cuda, prec):
    from lammps_buck_intel_tpu_torch.integrate import shake
    from lammps_buck_intel_tpu_torch.models.bonded import (compute_bonded,
                                                           compute_bonded_plain)

    sim = _npt_sim(cuda, prec)
    st, t, inv = sim.state, sim._shake_t, sim._inv
    rtol = 1e-5 if prec == "single" else 1e-12
    boxL = st.boxL * torch.tensor([1.0, 1.0, 1.01], device=cuda,
                                  dtype=st.boxL.dtype)
    xs = tuple(st.x.unbind(0))
    ro_k = shake.shake_ref(t, xs, inv, boxL)
    ro_p = shake.shake_ref_plain(t, xs, inv, boxL)
    assert float((ro_k - ro_p).abs().max()) <= rtol * float(ro_p.abs().max())
    xn = st.x + sim.dtv * st.v
    pk, pp = xn.clone(), xn.clone()
    vk, vp = st.v.clone(), st.v.clone()
    vf = 1.0 / (sim.dtv * sim.dtf)
    _, wk = shake.shake_positions(t, ro_k, tuple(pk.unbind(0)),
                                  tuple(vk.unbind(0)), inv, boxL, sim.dtv, 4,
                                  virial_factor=vf)
    _, wp = shake.shake_positions_plain(t, ro_p, tuple(pp.unbind(0)),
                                        tuple(vp.unbind(0)), inv, boxL,
                                        sim.dtv, 4, virial_factor=vf)
    assert float((wk - wp).abs().max()) <= 1e-4 * float(wp.abs().max())
    assert float(wp.abs().max()) > 0.0
    acc = sim.precision.acc
    out_k = compute_bonded(sim.bonded, xs, boxL, eflag=True, acc_dtype=acc)
    out_p = compute_bonded_plain(sim.bonded, xs, boxL, eflag=True,
                                 acc_dtype=acc)
    fk = torch.stack([out_k.fx, out_k.fy, out_k.fz])
    fp = torch.stack([out_p.fx, out_p.fy, out_p.fz])
    tol = 1e-4 if prec == "single" else 1e-11
    assert float((fk - fp).abs().max()) <= tol * float(fp.abs().max())
    assert float((out_k.virial - out_p.virial).abs().max()) <= \
        tol * float(out_p.virial.abs().max())


# ---- the neighbor-list Simulation: the dense build (K9c) and the static
# generic-mesh PPPM (K10 through K5 / K7 / K8) ----

def _dense_system(which, dtype, dev):
    """(x (3, N), boxL (3,)) of buck_small.yaml's 5^3 lattice (500 atoms)
    or one jittered copy of the cristobalite crystal (1,440 atoms)."""
    import os
    import sys

    if which == 500:
        x, lo, hi = lattice.create_atoms("fcc", 0.8442, 5, 5, 5)
        x = x + np.random.default_rng(1).uniform(-0.1, 0.1, x.shape)
        cut = 2.8
    else:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        sys.path.insert(0, os.path.join(root, "examples"))
        import gen_cristobalite

        x, _, _, hi = gen_cristobalite.build()
        x = np.mod(x + gen_cristobalite.jitter(len(x), 0.1), hi)
        lo, cut = np.zeros(3), 11.0
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    return t(x.T.copy()), t(lo), t(np.asarray(hi) - lo), cut


@pytest.mark.parametrize("n", [500, 1440])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nlist_dense_kernel_matches_plain(cuda, n, dtype):
    """K9c against build_dense_plain on the card: identical lists (ascending
    j, the same codes, counts and flags), also with K forced too small."""
    import dataclasses

    from lammps_buck_intel_tpu_torch.neighbor import neighbor_list as nlm

    x, lo, L, cut = _dense_system(n, dtype, cuda)
    spec = nlm.make_spec(n, L.cpu().numpy(), cut)
    assert spec.dense
    before = ops.LAUNCHES["nlist_dense"]
    for sp in (spec, dataclasses.replace(spec, kmax=16)):
        nk = nlm.build_dense(x, lo, L, sp)
        npl = nlm.build_dense_plain(x, lo, L, sp)
        assert nk.idx.t().is_contiguous()
        assert torch.equal(nk.idx, npl.idx) and torch.equal(nk.sb, npl.sb)
        assert torch.equal(nk.nnei, npl.nnei)
        assert bool(nk.overflow) == bool(npl.overflow) == (sp is not spec)
    assert ops.LAUNCHES["nlist_dense"] == before + 2


def test_nlist_dense_kernel_special_codes(cuda):
    """K9c writes the partner table's codes as the plain version does."""
    from lammps_buck_intel_tpu_torch.neighbor import neighbor_list as nlm

    x, lo, L, cut = _dense_system(500, torch.float64, cuda)
    n = x.shape[1]
    rng = np.random.default_rng(2)
    sp_i = torch.as_tensor(rng.integers(-1, n, (n, 6)), dtype=torch.int32,
                           device=cuda)
    sp_c = torch.as_tensor(rng.integers(1, 4, (n, 6)), dtype=torch.int32,
                           device=cuda)
    spec = nlm.make_spec(n, L.cpu().numpy(), cut)
    nk = nlm.build_dense(x, lo, L, spec, (sp_i, sp_c))
    npl = nlm.build_dense_plain(x, lo, L, spec, (sp_i, sp_c))
    assert torch.equal(nk.idx, npl.idx) and torch.equal(nk.sb, npl.sb)
    assert int(nk.sb.to(torch.int32).sum()) > 0


@pytest.mark.parametrize("grid", [None, (15, 21, 9)])
@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_pppm_compute_matches_plain(cuda, grid, flt, acc):
    """PPPM.compute on the card (K5 -> rfftn -> K7 with the Nyquist
    conventions -> irfftn -> K8, in atom order) against the plain
    pppm_compute_plain (full spectrum) on the same card, on the even
    generic mesh and an odd one."""
    from lammps_buck_intel_tpu_torch.models.kspace import pppm as tpppm

    rng = np.random.RandomState(4)
    Lb = np.array([12.0, 12.5, 10.5])
    x = rng.uniform(0, 1, (400, 3)) * Lb - 0.3
    q = rng.uniform(-1, 1, 400)
    q -= q.mean()
    box = make_box([0.0, 0.0, 0.0], Lb)
    pm = setup_pppm(box, q, cutoff=4.0, accuracy_rel=1e-5,
                    qqrd2e=332.06371, order=7, acc_dtype=acc)
    if grid is not None:
        import dataclasses

        pm = dataclasses.replace(
            pm, grid=grid,
            greensfn=tpppm._greens_function(grid, Lb, pm.g_ewald, 7),
            kx=2 * np.pi * tpppm._fold_idx(grid[0]) / Lb[0],
            ky=2 * np.pi * tpppm._fold_idx(grid[1]) / Lb[1],
            kz=2 * np.pi * tpppm._fold_idx(grid[2]) / Lb[2],
            h=tuple(Lb / np.asarray(grid)), _consts={})
    xt = torch.as_tensor(x.T.copy()).to(cuda, flt)
    qt = torch.as_tensor(q).to(cuda, flt)
    before = {k: ops.LAUNCHES[k] for k in ("pppm_deposit", "pppm_spectral",
                                           "pppm_gather")}
    cells = ops.LAUNCHES["pppm_deposit_cells"]
    rk = pm.compute(xt, qt, eflag=True, vflag=True)
    rp = tpppm.pppm_compute_plain(pm, xt, qt, True, True)
    for k, v in before.items():
        assert ops.LAUNCHES[k] == v + 1, k
    assert ops.LAUNCHES["pppm_deposit_cells"] == cells
    ftol, etol = (1e-4, 1e-5) if flt == torch.float32 else (1e-11, 1e-11)
    fk, fp = torch.stack(rk.f), torch.stack(rp.f)
    assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
    assert abs(float(rk.elong - rp.elong)) <= etol * abs(float(rp.elong))
    assert float((rk.virial - rp.virial).abs().max()) <= \
        etol * float(rp.virial.abs().max())


def test_simulation_on_card_matches_cpu(cuda):
    """buck_small.yaml (the fallback into Simulation and K9c) in f64 for 10
    steps on the card against the same run on the CPU's plain versions:
    rows within 1e-11 relative, positions within 1e-11 of the box."""
    import os

    import yaml

    from lammps_buck_intel_tpu_torch.run import build_simulation

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "examples", "decks",
                           "buck_small.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["precision"] = "double"
    rows = []
    sims = []
    for dev in (cuda, "cpu"):
        sim = build_simulation(dict(cfg), device=dev)
        rows.append(sim.run(10, thermo_every=5, log=False))
        sims.append(sim)
    for rk, rp in zip(*rows):
        for key in ("temp", "epair", "etotal", "press"):
            assert abs(rk[key] - rp[key]) <= 1e-11 * abs(rp[key]), key
    xk, xp = (s.get_atoms()["x"] for s in sims)
    assert np.abs(xk - xp).max() <= 1e-11 * float(sims[1].box.lengths.max())


# ---- Ewald (K11a, K11b) and the coul/cut branch of K1 and K9b ----

@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_ewald_kernels_match_plain(cuda, flt, acc):
    """Ewald.compute on the card (K11a then K11b) against
    ewald_compute_plain on the same card, on 600 jittered random charges
    in a 14 x 15 x 13 box (a few thousand k vectors): forces, elong and
    the virial; f32 at the PPPM kernels' tolerances, f64 at 1e-12."""
    from lammps_buck_intel_tpu_torch.models.kspace import ewald as tewald

    rng = np.random.RandomState(6)
    Lb = np.array([14.0, 15.0, 13.0])
    x = rng.uniform(0, 1, (600, 3)) * Lb
    q = rng.uniform(-1, 1, 600)
    q -= q.mean()
    ew = tewald.setup_ewald(make_box([0.0, 0.0, 0.0], Lb), q, cutoff=5.0,
                            accuracy_rel=1e-6, qqrd2e=14.399645,
                            acc_dtype=acc)
    xt = torch.as_tensor(x.T.copy()).to(cuda, flt)
    qt = torch.as_tensor(q).to(cuda, flt)
    before = {k: ops.LAUNCHES[k] for k in ("ewald_sk", "ewald_force")}
    rk = ew.compute(xt, qt, eflag=True, vflag=True)
    rp = tewald.ewald_compute_plain(ew, xt, qt, True, True)
    for k, v in before.items():
        assert ops.LAUNCHES[k] == v + 1, k
    ftol, etol = (1e-4, 1e-5) if flt == torch.float32 else (1e-12, 1e-12)
    fk, fp = torch.stack(rk.f), torch.stack(rp.f)
    assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
    assert abs(float(rk.elong - rp.elong)) <= etol * abs(float(rp.elong))
    assert float((rk.virial - rp.virial).abs().max()) <= \
        etol * float(rp.virial.abs().max())


def test_ewald_wrappers_reject_bad_input(cuda):
    from lammps_buck_intel_tpu_torch.models.kspace import ewald as tewald
    from lammps_buck_intel_tpu_torch.ops import ewald as ewald_ops

    q = np.array([1.0, -1.0])
    ew = tewald.setup_ewald(make_box([0.0] * 3, [8.0] * 3), q, cutoff=3.0,
                            accuracy_rel=1e-4, qqrd2e=1.0)
    c = ew.consts(cuda, torch.float32)
    xs = tuple(torch.zeros(2, device=cuda) for _ in range(3))
    with pytest.raises(TypeError):
        ewald_ops.ewald_sk(xs, torch.zeros(2, device=cuda), c, 1.0,
                           torch.float16)
    with pytest.raises(ValueError):
        ewald_ops.ewald_sk(xs, torch.zeros(3, device=cuda), c, 1.0,
                           torch.float32)
    with pytest.raises(ValueError):
        ewald_ops.ewald_force(tuple(p.cpu() for p in xs), torch.zeros(2), c,
                              c["ug"], c["ug"], 1.0, torch.float32)


@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_cellpair_coul_cut_kernel_matches_plain(cuda, flt, acc):
    """K1's coul/cut branch (buck/coul/cut, and lj/charmm/coul/cut with the
    rhodo special table) against compute_cellpair_plain."""
    grid, box, st, style = _state(cuda, flt, ntypes=2, coul=True)
    cut = build_buck(2, {(0, 0): (1.0, 0.2, -0.8), (0, 1): (0.9, 0.22, -0.7),
                         (1, 1): (1.1, 0.18, -0.9)}, cut_global=2.5,
                     coul="cut", cut_coul=2.2, shift=True, qqrd2e=14.399645)
    ftol, etol = (1e-11, 1e-11) if flt == torch.float64 else (1e-4, 1e-5)
    k = compute_cellpair(cut, grid, box, st, eflag=True, vflag=True,
                         acc_dtype=acc)
    p = compute_cellpair_plain(cut, grid, box, st, eflag=True, vflag=True,
                               acc_dtype=acc)
    fk, fp = (torch.stack([r.fx, r.fy, r.fz]) for r in (k, p))
    assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
    assert abs(float(p.ecoul)) > 1.0
    for e in ("evdwl", "ecoul"):
        assert abs(float(getattr(k, e) - getattr(p, e))) <= \
            etol * abs(float(getattr(p, e)))


def _knife_edge_pair(rng, dt, origin, cutsq, inside, wrap=None):
    """Two positions (in ``dt``) whose rsq, rounded product by product and
    sum by sum as the plain version rounds it, lies inside the strict
    cutoff when ``inside`` (outside otherwise), while the exact rsq and
    both FMA contractions of dx^2 + dy^2 + dz^2 lie on the other side.
    With ``wrap`` (the box length along x) the second atom lies past the
    box's upper x face and is returned wrapped to x - wrap; its distance
    is then taken as both versions take it from the first atom's cell,
    to the wrapped position plus the shift dt(wrap)."""
    from fractions import Fraction as Fr

    rc2 = Fr(float(cutsq))

    def side(v):
        return Fr(float(v)) < rc2

    def fma(a, b, c):
        return dt(float(Fr(float(a)) * Fr(float(b)) + Fr(float(c))))

    xi = np.asarray(origin, dt)
    while True:
        u = rng.normal(size=3)
        if wrap is not None:
            u[0] = abs(u[0]) + 1.0       # toward the upper x face
        r = np.sqrt(cutsq) * (1.0 + rng.uniform(-4, 4) * np.finfo(dt).eps)
        xj = (xi + r * u / np.linalg.norm(u)).astype(dt)
        pj = xj
        if wrap is not None:
            if xj[0] < dt(wrap):
                continue
            xj[0] = xj[0] - dt(wrap)
            pj = xj.copy()
            pj[0] = pj[0] + dt(wrap)
        dx, dy, dz = (xi - pj).astype(dt)
        plain = (dx * dx + dy * dy) + dz * dz
        others = (sum(Fr(float(d)) ** 2 for d in (dx, dy, dz)),
                  fma(dz, dz, fma(dy, dy, dx * dx)),
                  fma(dz, dz, fma(dx, dx, dy * dy)))
        if side(plain) == inside and all(side(v) != inside for v in others):
            return xi, xj


@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_cellpair_cut_decision_rounds_like_plain(cuda, flt, acc):
    """K1 takes a pair within an ulp of the strict coul/cut cutoff to the
    side the plain version takes it (the Coulomb force steps by qqrd2e qi
    qj / rc^2 there): one pair the plain rounding puts inside and one it
    puts outside, each the other way round in exact or FMA arithmetic."""
    dt = np.float32 if flt == torch.float32 else np.float64
    rng = np.random.default_rng(3)
    cut_coul = 2.25                        # rc^2 = 5.0625, exact
    pos = []
    # two pairs well inside the box: no periodic shift enters their dx
    for origin, inside in (((3.0, 3.0, 3.0), True),
                           ((8.0, 8.0, 8.0), False)):
        pos += _knife_edge_pair(rng, dt, origin, dt(cut_coul**2), inside)
    x = torch.as_tensor(np.stack(pos)).to(cuda, flt)
    n = x.shape[0]
    box = make_box(np.zeros(3), np.full(3, 11.2))
    grid = cs.make_grid(n, box.lengths, 2.8)
    zeros = torch.zeros((n, 3), device=cuda)
    st = cs.from_atoms(grid, box, x, zeros, zeros.to(torch.int32),
                       torch.zeros(n, dtype=torch.int32, device=cuda),
                       torch.tensor([1.0, -1.0, 1.0, -1.0], device=cuda),
                       dtype=flt)
    assert torch.equal(torch.sort(st.x[st.aid < n]).values,
                       torch.sort(x[:, 0]).values)   # binned unchanged
    style = build_buck(1, {(0, 0): (1.0, 0.2, -0.8)}, cut_global=2.5,
                       coul="cut", cut_coul=cut_coul, qqrd2e=14.399645)
    k = compute_cellpair(style, grid, box, st, eflag=True, vflag=True,
                         acc_dtype=acc)
    p = compute_cellpair_plain(style, grid, box, st, eflag=True, vflag=True,
                               acc_dtype=acc)
    # the plain version holds exactly the first pair's Coulomb term
    assert float(p.ecoul) == pytest.approx(-14.399645 / cut_coul, rel=1e-5)
    fk, fp = (torch.stack([r.fx, r.fy, r.fz]) for r in (k, p))
    ftol, etol = (1e-11, 1e-11) if flt == torch.float64 else (1e-4, 1e-5)
    assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
    for e in ("evdwl", "ecoul"):
        assert abs(float(getattr(k, e) - getattr(p, e))) <= \
            etol * abs(float(getattr(p, e)))


@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_cellpair_cut_decision_across_the_wrap(cuda, flt, acc):
    """A pair on the strict coul/cut cutoff's knife edge across the
    periodic x wrap, decided once from the cell below the upper face, with
    j's position shifted by +L: K1 takes it to the side the plain version
    takes it, one pair inside and one outside."""
    dt = np.float32 if flt == torch.float32 else np.float64
    rng = np.random.default_rng(5)
    cut_coul, L = 2.25, 11.2
    pos = []
    for origin, inside in (((11.0, 3.0, 3.0), True),
                           ((11.0, 8.0, 8.0), False)):
        pos += _knife_edge_pair(rng, dt, origin, dt(cut_coul**2), inside,
                                wrap=L)
    x = torch.as_tensor(np.stack(pos)).to(cuda, flt)
    n = x.shape[0]
    assert bool((x[:, 0] >= 0).all()) and bool((x[:, 0] < L).all())
    box = make_box(np.zeros(3), np.full(3, L))
    grid = cs.make_grid(n, box.lengths, 2.8)
    assert grid.nc == (4, 4, 4)
    zeros = torch.zeros((n, 3), device=cuda)
    st = cs.from_atoms(grid, box, x, zeros, zeros.to(torch.int32),
                       torch.zeros(n, dtype=torch.int32, device=cuda),
                       torch.tensor([1.0, -1.0, 1.0, -1.0], device=cuda),
                       dtype=flt)
    assert torch.equal(torch.sort(st.x[st.aid < n]).values,
                       torch.sort(x[:, 0]).values)   # binned unchanged
    style = build_buck(1, {(0, 0): (1.0, 0.2, -0.8)}, cut_global=2.5,
                       coul="cut", cut_coul=cut_coul, qqrd2e=14.399645)
    k = compute_cellpair(style, grid, box, st, eflag=True, vflag=True,
                         acc_dtype=acc)
    p = compute_cellpair_plain(style, grid, box, st, eflag=True, vflag=True,
                               acc_dtype=acc)
    # the plain version holds exactly the first pair's Coulomb term
    assert float(p.ecoul) == pytest.approx(-14.399645 / cut_coul, rel=1e-5)
    fk, fp = (torch.stack([r.fx, r.fy, r.fz]) for r in (k, p))
    ftol, etol = (1e-11, 1e-11) if flt == torch.float64 else (1e-4, 1e-5)
    assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
    for e in ("evdwl", "ecoul"):
        assert abs(float(getattr(k, e) - getattr(p, e))) <= \
            etol * abs(float(getattr(p, e)))


@pytest.mark.parametrize("prec", ["single", "double"])
def test_nlist_pair_coul_cut_kernel_matches_plain(cuda, prec):
    """K9b's coul/cut branch on the rhodo copy's list: lj/charmm/coul/cut
    with the special codes, and buck/coul/cut (no specials) on the same
    atoms, against compute_pair_plain."""
    from lammps_buck_intel_tpu_torch.models.pair import build_lj_charmm
    from lammps_buck_intel_tpu_torch.models.pair import driver

    sim = _npt_sim(cuda, prec)
    x, boxL = sim.state.x, sim.state.boxL
    from lammps_buck_intel_tpu_torch.core.box import traced_lo
    from lammps_buck_intel_tpu_torch.neighbor import neighbor_list as nlm

    nl = nlm.build_cell(x, traced_lo(sim._center, boxL), boxL, sim.spec,
                        sim._special)
    ntypes = sim.pair.tables.shape[0]
    charmm = build_lj_charmm(
        ntypes, {t: (0.05 + 0.01 * t, 2.5 + 0.1 * t) for t in range(ntypes)},
        8.0, 10.0, coul="cut", special_lj=(1.0, 0.0, 0.0, 0.5),
        special_coul=(1.0, 0.0, 0.0, 0.8), qqrd2e=332.06371)
    coeffs = {(i, j): (1000.0, 0.3, 10.0) for i in range(ntypes)
              for j in range(i, ntypes)}
    buck = build_buck(ntypes, coeffs, cut_global=10.0, coul="cut",
                      qqrd2e=332.06371)
    ftol, etol = (1e-4, 1e-5) if prec == "single" else (1e-11, 1e-11)
    before = ops.LAUNCHES["nlist_pair"]
    for style, use_special in ((charmm, True), (buck, False)):
        args = (style, x, sim.typ, sim.q, boxL, nl)
        kw = dict(eflag=True, acc_dtype=sim.precision.acc,
                  use_special=use_special)
        rk = driver.compute_pair(*args, **kw)
        rp = driver.compute_pair_plain(*args, **kw)
        fk, fp = torch.stack(rk[:3]), torch.stack(rp[:3])
        assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
        assert float((rk.virial - rp.virial).abs().max()) <= \
            etol * float(rp.virial.abs().max())
        for e in ("evdwl", "ecoul"):
            assert abs(float(getattr(rk, e) - getattr(rp, e))) <= \
                etol * abs(float(getattr(rp, e)))
    assert ops.LAUNCHES["nlist_pair"] == before + 2


# ---- the hexane path: K1 lj/long + exclusion, K12a, K15a-c ----

def _hexane_sim(dev, prec, tmp_path):
    """hexane_gen.yaml on a 4 x 4 x 4 lattice of chains (384 atoms, cut
    5.0, skin 1.0) built on ``dev``."""
    import os
    import sys

    import yaml

    from lammps_buck_intel_tpu_torch.run import build_simulation

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "examples"))
    import gen_hexane

    data = str(tmp_path / "data.hexane_cut")
    gen_hexane.write(data, 4, 4, 4)
    with open(os.path.join(root, "examples", "decks", "hexane_gen.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(read_data=data, precision=prec)
    cfg["pair_style"]["cut"] = 5.0
    cfg["neighbor"]["skin"] = 1.0
    return build_simulation(cfg, device=dev)


TOLS = {"single": (1e-4, 1e-5), "mixed": (1e-4, 1e-5),
        "double": (1e-11, 1e-11)}


@pytest.mark.parametrize("prec", ["single", "mixed", "double"])
def test_cellpair_lj_long_exclusion_kernel_matches_plain(cuda, prec,
                                                         tmp_path):
    """K1's lj/long (DISP_LONG) branch with the same-molecule mol plane,
    and the lj/cut branch, against compute_cellpair_plain."""
    from lammps_buck_intel_tpu_torch.models.pair import build_lj

    sim = _hexane_sim(cuda, prec, tmp_path)
    st, acc = sim.state, sim.precision.acc
    mol = sim._slot_mol(st)
    ftol, etol = TOLS[prec]
    lj_cut = build_lj(2, {0: (0.1744742, 3.97), 1: (0.1147228, 3.97)},
                      cut_global=5.0, shift=True)
    before = ops.LAUNCHES["cellpair"]
    for style, m in ((sim.pair, mol), (sim.pair, None), (lj_cut, mol)):
        k = compute_cellpair(style, sim.grid, sim.box, st, eflag=True,
                             vflag=True, acc_dtype=acc, slot_mol=m)
        p = compute_cellpair_plain(style, sim.grid, sim.box, st, eflag=True,
                                   vflag=True, acc_dtype=acc, slot_mol=m)
        fk, fp = (torch.stack([r.fx, r.fy, r.fz]) for r in (k, p))
        assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
        assert abs(float(k.evdwl - p.evdwl)) <= etol * abs(float(p.evdwl))
        assert float((k.virial - p.virial).abs().max()) <= \
            etol * float(p.virial.abs().max())
    assert ops.LAUNCHES["cellpair"] == before + 3


@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
@pytest.mark.parametrize("mix", ["geometric", "arithmetic"])
def test_disp_spectral_kernel_matches_plain(cuda, acc, mix):
    """K12a against disp_spectral_plain: one geometric channel and the
    seven arithmetic ones on random channel spectra."""
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as pd

    eps, sig = np.array([0.30, 0.18]), np.array([1.10, 1.25])
    pmd = pd.setup_pppm_disp(
        make_box([0, 0, 0], [9.0, 8.0, 7.0]), np.sqrt(4 * eps) * sig**3,
        np.array([0, 1]), cutoff=3.2, mix=mix, epsilon=eps, sigma=sig,
        acc_dtype=acc)
    c = pmd.consts(cuda, torch.float32)
    nch = pmd.A.shape[0]
    nx, ny, nzh = c["G"].shape
    g = torch.Generator().manual_seed(4)
    S = torch.complex(torch.randn((nch, nx, ny, nzh), generator=g),
                      torch.randn((nch, nx, ny, nzh), generator=g)).to(
        cuda, {torch.float32: torch.complex64,
               torch.float64: torch.complex128}[acc])
    before = ops.LAUNCHES["disp_spectral"]
    ek, esk, vsk = pd.disp_spectral(c, S, pmd.P, True)
    ep, esp, vsp = pd.disp_spectral_plain(c, S, pmd.P, True)
    assert ops.LAUNCHES["disp_spectral"] == before + 1
    tol = 1e-11 if acc == torch.float64 else 1e-5
    assert float((ek - ep).abs().max()) <= tol * float(ep.abs().max())
    assert abs(float(esk - esp)) <= tol * abs(float(esp))
    assert float((vsk - vsp).abs().max()) <= tol * float(vsp.abs().max())
    e0, es0, vs0 = pd.disp_spectral(c, S, pmd.P, False)
    assert torch.equal(e0, ek) and float(es0) == 0.0 and not vs0.any()


@pytest.mark.parametrize("prec", ["single", "double"])
def test_cell_pppm_disp_kernels_match_plain(cuda, prec, tmp_path):
    """CellPPPMDisp.compute_slots on the card (K5, K12a, K8) against the
    same solve with every stage's plain version (the state copied to the
    CPU)."""
    sim = _hexane_sim(cuda, prec, tmp_path)
    st = sim.state
    cpu = st._replace(**{k: v.cpu() for k, v in st._asdict().items()
                         if v is not None})
    ftol, etol = TOLS[prec]
    before = dict(ops.LAUNCHES)
    fk = sim.kspace.compute_slots(st, True, True)
    fp = sim.kspace.compute_slots(cpu, True, True)
    # K5 by cell: the dispersion mesh's bricks (19^3 points) fit in f32,
    # not in f64, which keeps K5 in slot order
    assert pppm_cells.takes_bricks(sim.kspace.bricks, st.x.shape[0],
                                   st.x.element_size()) == (prec == "single")
    dep = "pppm_deposit_cells" if prec == "single" else "pppm_deposit"
    for k in (dep, "disp_spectral", "pppm_gather"):
        assert ops.LAUNCHES[k] == before[k] + 1, k
    a, b = torch.stack(fk[:3]).cpu(), torch.stack(fp[:3])
    assert float((a - b).abs().max()) <= ftol * float(b.abs().max())
    assert abs(float(fk[3].cpu() - fp[3])) <= etol * abs(float(fp[3]))
    assert float((fk[4].cpu() - fp[4]).abs().max()) <= \
        etol * float(fp[4].abs().max())


@pytest.mark.parametrize("prec", ["single", "mixed", "double"])
@pytest.mark.parametrize("width", [None, 32])
def test_rigid_kernels_match_plain(cuda, prec, width, tmp_path):
    """K15a-c against their plain versions on the cut-out's bodies and
    slot layout: force and torque (with the slot force store), the
    offsets, initial and final updates, the constraint virial."""
    from lammps_buck_intel_tpu_torch.integrate import rigid as rgd

    sim = _hexane_sim(cuda, prec, tmp_path)
    st, t, acc = sim.state, sim._rt, sim.precision.acc
    inv = sim._inv_map(st)
    fa, fb, *_ = sim._forces(st, False, False, sim._slot_mol(st))
    ftol, etol = TOLS[prec]

    def cl(x):
        return tuple(p.clone() for p in x)

    def close(k, p, tol, scale=None):
        scale = float(p.abs().max()) if scale is None else scale
        assert float((k - p).abs().max()) <= tol * max(scale, 1e-30)

    before = dict(ops.LAUNCHES)
    fo_k, fo_p = cl((st.fx, st.fy, st.fz)), cl((st.fx, st.fy, st.fz))
    Fk, Tk = rgd.slot_force_torque(t, sim._d, inv, fa, fb, fo_k, width)
    Fp, Tp = rgd.slot_force_torque_plain(t, sim._d, inv, fa, fb, fo_p)
    close(Fk, Fp, ftol)
    close(Tk, Tp, ftol)
    close(torch.stack(fo_k), torch.stack(fo_p), ftol)
    vk = rgd.slot_constraint_virial(t, sim.body, sim._d, inv, fa, fb, Tp,
                                    sim.units.ftm2v, acc, width)
    vp = rgd.slot_constraint_virial_plain(t, sim.body, sim._d, inv, fa, fb,
                                          Tp, sim.units.ftm2v, acc)
    close(vk, vp, etol)
    # the three update modes, each from the same inputs
    off_k = tuple(torch.zeros_like(st.x) for _ in range(3))
    off_p = tuple(torch.zeros_like(st.x) for _ in range(3))
    for mode in (rgd.MODE_OFFSETS, rgd.MODE_INITIAL, rgd.MODE_FINAL):
        bk, bp = sim.body.clone(), sim.body.clone()
        dk, dp = sim._d.clone(), sim._d.clone()
        pk = cl((st.vx, st.vy, st.vz) if mode == rgd.MODE_FINAL
                else (st.x, st.y, st.z))
        pp = cl(pk)
        rgd.rigid_update(t, bk, dk, inv, pk, off_k, Fp, Tp, sim.dtv,
                         sim.dtf, mode, width)
        rgd.rigid_update_plain(t, bp, dp, inv, pp, off_p, Fp, Tp, sim.dtv,
                               sim.dtf, mode)
        for a, b in zip(bk, bp):
            close(a, b, ftol)
        close(dk, dp, ftol)
        close(torch.stack(pk), torch.stack(pp), ftol)
        if mode == rgd.MODE_OFFSETS:
            # x - (X + d) is zero to rounding here: held to the positions'
            # scale
            close(torch.stack(off_k), torch.stack(off_p), ftol,
                  float(torch.stack(pp).abs().max()))
    for k, n in (("rigid_force_torque", 1), ("rigid_virial", 1),
                 ("rigid_update", 3)):
        assert ops.LAUNCHES[k] == before[k] + n, k


def test_rigid_and_disp_wrappers_reject_bad_input(cuda, tmp_path):
    from lammps_buck_intel_tpu_torch.integrate import rigid as rgd
    from lammps_buck_intel_tpu_torch.ops import pppm_disp as disp_ops
    from lammps_buck_intel_tpu_torch.ops import rigid as rigid_ops

    sim = _hexane_sim(cuda, "single", tmp_path)
    st, t = sim.state, sim._rt
    inv = sim._inv_map(st)
    fs = (st.fx, st.fy, st.fz)
    with pytest.raises(ValueError):
        rigid_ops.force_torque(t, sim._d.cpu(), inv, fs)
    with pytest.raises(ValueError):
        rigid_ops.force_torque(t, sim._d[:-1], inv, fs)
    with pytest.raises(ValueError):
        rigid_ops.update(t, sim.body, sim._d, inv, None, None, None, None,
                         0.0, 0.0, rgd.MODE_INITIAL)
    c = sim.kspace.pmd.consts(cuda, torch.float32)
    nx, ny, nzh = c["G"].shape
    with pytest.raises(TypeError):
        disp_ops.disp_spectral(c, torch.zeros((1, nx, ny, nzh), device=cuda),
                               np.ones((1, 1)), True)
    with pytest.raises(ValueError):
        disp_ops.disp_spectral(
            c, torch.zeros((9, nx, ny, nzh), dtype=torch.complex64,
                           device=cuda), np.eye(9), True)


def _channel_case(dev, flt, n=600, L=14.0, seed=21):
    """Random positions of two types in a cube (some outside it: the
    stencil folds every index), the no-mix channels of a C6 matrix with a
    negative eigenvalue (2 channels) and the arithmetic ones (7), each as
    the (nch, T + 1) table with a zero column for empty entries."""
    from lammps_buck_intel_tpu_torch.models.kspace import setup_pppm_disp

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(-1.0, L + 1.0, (3, n))).to(dev, flt)
    typ = rng.integers(0, 2, n)
    rows = np.where(rng.uniform(size=n) < 0.1, 2, typ)   # ~10% empty
    box = make_box([0.0, 0.0, 0.0], [L] * 3)
    out = []
    for mix in ("none", "arithmetic"):
        pmd = setup_pppm_disp(
            box, np.array([1.0, 1.2]), typ, cutoff=4.0, order=5, mix=mix,
            C6=np.array([[0.0, 1.3], [1.3, 1.75]]),
            epsilon=np.array([0.3, 0.18]), sigma=np.array([1.1, 1.25]))
        A = np.concatenate([pmd.A, np.zeros((pmd.A.shape[0], 1))], 1)
        out.append((pmd, torch.as_tensor(A).to(dev, flt)))
    return x, torch.as_tensor(rows, dtype=torch.int32, device=dev), out


@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_disp_channel_kernels_match_plain(cuda, flt, acc):
    """K12b (disp_deposit) and K12c (disp_gather) against the per-channel
    loops of the plain deposit and gather, at 2 and 7 channels."""
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as pd

    x, rows, cases = _channel_case(cuda, flt)
    tol = 1e-11 if flt == torch.float64 else 1e-4
    for pmd, table in cases:
        pmd.acc_dtype = acc
        c = pmd.consts(cuda, flt)
        shim = c["shim"]
        before = dict(ops.LAUNCHES)
        mk = pd.deposit_multi(shim, x, rows, table, c["coef"])
        mp = pd.deposit_multi_plain(shim, x, rows, table)
        _close(mk, mp, tol)
        S = torch.fft.rfftn(mp.to(acc), dim=(1, 2, 3)).contiguous()
        ehat, _, _ = pd.disp_spectral(c, S, pmd.P, False)
        ef = (torch.fft.irfftn(ehat, s=pmd.grid, dim=(2, 3, 4))
              * (float(np.prod(pmd.grid)) / pmd.volume)).to(flt).contiguous()
        fk = torch.stack(pd.gather_multi(shim, x, rows, table, ef, acc,
                                         c["coef"]))
        fp = torch.stack(pd.gather_multi_plain(shim, x, rows, table, ef,
                                               acc))
        _close(fk, fp, tol)
        assert not fk[:, rows == 2].any()
        assert ops.LAUNCHES["disp_deposit"] == before["disp_deposit"] + 1
        assert ops.LAUNCHES["disp_gather"] == before["disp_gather"] + 1


def test_disp_channel_wrappers_reject_bad_input(cuda):
    from lammps_buck_intel_tpu_torch.ops import pppm_disp as disp_ops

    x, rows, cases = _channel_case(cuda, torch.float32)
    pmd, table = cases[0]
    c = pmd.consts(cuda, torch.float32)
    shim, coef = c["shim"], c["coef"]
    with pytest.raises(ValueError):      # rows of another length
        disp_ops.disp_deposit(shim, x, rows[1:], table, coef)
    with pytest.raises(TypeError):       # table of another dtype
        disp_ops.disp_deposit(shim, x, rows, table.double(), coef)
    with pytest.raises(ValueError):      # more than 8 channels
        disp_ops.disp_deposit(shim, x, rows, table.repeat(5, 1), coef)
    with pytest.raises(ValueError):      # fields of another size
        disp_ops.disp_gather(shim, x, rows, table,
                             torch.zeros(5, device=cuda), torch.float32,
                             coef)


# ---- per-atom energy and virial: K9d, K10pa, K11pa, K18b ----

def _peratom_case(cuda, name, precision, tmp_path):
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "examples"))
    import peratom_cases as rec

    from lammps_buck_intel_tpu_torch.run import build_simulation

    path = str(tmp_path / "data.cris_jitter")
    rec.write_jitter(path)
    hpath = None
    if name.startswith("hexane"):
        hpath = str(tmp_path / "data.hexane_cut")
        rec.write_hexane_cut(hpath)
    cfg = rec.case_config(name, path, hpath)
    cfg["precision"] = precision
    return build_simulation(cfg, device="cuda")


def _peratom_err(k, p):
    return float((k - p).abs().max()) / max(float(p.abs().max()), 1e-300)


@pytest.mark.parametrize("name", ["silica_pppm", "silica_ewald",
                                  "rhodo_class"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_peratom_kernels_match_plain(cuda, name, dtype, tmp_path):
    from lammps_buck_intel_tpu_torch import computes
    from lammps_buck_intel_tpu_torch.models.bonded import (
        compute_bonded_peratom, compute_bonded_peratom_plain)
    from lammps_buck_intel_tpu_torch.models.kspace import ewald, pppm
    from lammps_buck_intel_tpu_torch.models.pair import driver
    from lammps_buck_intel_tpu_torch.neighbor import neighbor_list as tnl

    sim = _peratom_case(cuda, name, "double" if dtype == torch.float64
                        else "single", tmp_path)
    at = sim.atoms_on_device()
    x, q = at["x"].to(dtype), at["q"].to(dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    ops.reset_launches()
    # K9d on the computes' list, against the plain pass on the same list
    box = sim.box
    L = torch.as_tensor(np.asarray(box.lengths, np.float64)).to(cuda, dtype)
    spec = tnl.make_spec(sim.n_atoms, box.lengths,
                         float(np.sqrt(sim.pair.cutsq_max)) * 1.0001)
    sp = at["special"]
    nl, _ = tnl.build_with_retry(
        x, torch.as_tensor(np.asarray(box.lo)).to(cuda, dtype), L, spec, sp)
    kw = dict(acc_dtype=dtype, use_special=sp is not None)
    pk = driver.compute_pair_peratom(sim.pair, x, at["typ"], q, L, nl, **kw)
    pp = driver.compute_pair_peratom_plain(sim.pair, x, at["typ"], q, L, nl,
                                           **kw)
    assert ops.LAUNCHES["nlist_pair_peratom"] == 1
    for a, b in zip(pk, pp):
        assert _peratom_err(a, b) <= tol
    # the k-space term
    s = computes._solvers(sim.kspace)[0]
    if isinstance(s, ewald.Ewald):
        kk = ewald.ewald_compute_peratom(s, x, q)
        kp = ewald.ewald_compute_peratom_plain(s, x, q)
        assert ops.LAUNCHES["ewald_peratom"] == 1
    else:
        pm = getattr(s, "pm", s)
        kk = pppm.compute_peratom(pm, x, q)
        kp = pppm.compute_peratom_plain(pm, x, q)
        assert ops.LAUNCHES["pppm_peratom_spectral"] == 1
        assert ops.LAUNCHES["pppm_peratom_gather"] == 1
    for a, b in zip(kk, kp):
        assert _peratom_err(a, b) <= tol
    if sim.bonded is not None:
        xs = tuple(at["x"].unbind(0))
        bk = compute_bonded_peratom(sim.bonded, xs, box,
                                    acc_dtype=torch.float64)
        bp = compute_bonded_peratom_plain(sim.bonded, xs, box,
                                          acc_dtype=torch.float64)
        assert ops.LAUNCHES["bonded_peratom"] == 1
        for a, b in zip(bk, bp):
            assert _peratom_err(a, b) <= (1e-12 if xs[0].dtype ==
                                          torch.float64 else 1e-5)


def test_peratom_wrappers_reject_bad_input(cuda, tmp_path):
    from lammps_buck_intel_tpu_torch.models.kspace.pppm_cells import (
        AtomPlanes)
    from lammps_buck_intel_tpu_torch.ops import nlist as nlist_ops
    from lammps_buck_intel_tpu_torch.ops import pppm as pppm_ops

    sim = _peratom_case(cuda, "silica_pppm", "single", tmp_path)
    at = sim.atoms_on_device()
    xs = tuple(at["x"].unbind(0))
    nl = sim._build(at["x"])
    L = sim._boxL
    with pytest.raises(TypeError):      # the per-atom pass has no mixed
        nlist_ops.compute_pair_peratom(sim.pair, xs, at["typ"], at["q"], L,
                                       nl, acc_dtype=torch.float64,
                                       use_special=False)
    pm = sim.kspace
    c = pm.consts(cuda, torch.float32)
    n = sim.n_atoms
    planes = AtomPlanes(*xs, at["q"], torch.arange(n, dtype=torch.int32,
                                                   device=cuda))
    meshes = torch.zeros((7,) + pm.grid, device=cuda)
    with pytest.raises(ValueError):     # a non-contiguous view
        pppm_ops.peratom_gather(pm, planes, meshes.transpose(2, 3),
                                c["coef"], 1.0)
    with pytest.raises(ValueError):     # six meshes
        pppm_ops.peratom_gather(pm, planes, meshes[:6].contiguous(),
                                c["coef"], 1.0)
    with pytest.raises(TypeError):      # rhat of another dtype
        pppm_ops.peratom_spectral(pm, c, torch.zeros(
            c["G_half"].shape, dtype=torch.complex128, device=cuda), True)


# ---- per-atom dispersion PPPM (K12pa) and the slot forms (K18 slots) ----

def _disp_solver(ks):
    from lammps_buck_intel_tpu_torch import computes
    from lammps_buck_intel_tpu_torch.models.kspace import (BoundKSpace,
                                                           CellPPPMDisp)

    return [s for s in computes._solvers(ks)
            if isinstance(s, (BoundKSpace, CellPPPMDisp))][0]


@pytest.mark.parametrize("name", ["silica_buck_long", "hexane_cut",
                                  "hexane_cut_arith"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_disp_peratom_kernels_match_plain(cuda, name, dtype, tmp_path):
    """K12pa (PPPMDisp.compute_peratom: K12b, K12pa spectral, K12pa
    gather) against disp_peratom_plain on the dispersion cases of the
    per-atom record, 1, 2 and 7 channels."""
    from lammps_buck_intel_tpu_torch.models.kspace import (CellPPPMDisp,
                                                           pppm_disp)

    sim = _peratom_case(cuda, name, "double" if dtype == torch.float64
                        else "single", tmp_path)
    at = sim.atoms_on_device()
    x = at["x"].to(dtype)
    s = _disp_solver(sim.kspace)
    pmd = s.pmd if isinstance(s, CellPPPMDisp) else s.solver
    if isinstance(s, CellPPPMDisp) or not s.typed:
        B = torch.as_tensor(np.asarray(pmd.B, np.float64)).to(cuda, dtype)
        a, kw = B[at["typ"].long()][None], dict(b_per_atom=B[at["typ"]
                                                               .long()])
        P = np.ones((1, 1))
    else:
        A = torch.as_tensor(np.asarray(pmd.A, np.float64)).to(cuda, dtype)
        a, kw, P = A[:, at["typ"].long()], dict(typ=at["typ"]), pmd.P
    ops.reset_launches()
    kk = pmd.compute_peratom(x, **kw)
    assert ops.LAUNCHES["disp_deposit"] == 1
    assert ops.LAUNCHES["disp_peratom_spectral"] == 1
    assert ops.LAUNCHES["disp_peratom_gather"] == 1
    kp = pppm_disp.disp_peratom_plain(pmd, x, a, P)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    for u, v in zip(kk, kp):
        assert _peratom_err(u, v) <= tol


@pytest.mark.parametrize("name", ["rhodo_class", "hexane_cut"])
@pytest.mark.parametrize("prec", ["single", "double"])
def test_peratom_slots_kernels_match_plain(cuda, name, prec, tmp_path):
    """K18 slots: CellPPPM.compute_peratom_slots (K5, K10pa spectral, the
    K10pa gather over the slots) and CellPPPMDisp.compute_peratom_slots
    (K5, K12pa spectral, the K12pa gather over the slots) against the same
    solve with every stage's plain version on the card; empty slots
    exactly 0."""
    sim = _peratom_case(cuda, name, prec, tmp_path)
    st = sim.state
    ops.reset_launches()
    ek, vk = sim.kspace.compute_peratom_slots(st)
    key = "pppm_peratom_slots" if name == "rhodo_class" \
        else "disp_peratom_slots"
    assert ops.LAUNCHES[key] == 1
    # K5 by cell where the brick fits: not the hexane cut-out's in f64
    cells = name == "rhodo_class" or prec == "single"
    assert ops.LAUNCHES["pppm_deposit_cells"] == int(cells)
    assert ops.LAUNCHES["pppm_deposit"] == int(not cells)
    ep, vp = sim.kspace.compute_peratom_slots(st, plain=True)
    tol = 1e-12 if prec == "double" else 1e-4
    assert _peratom_err(ek, ep) <= tol
    assert _peratom_err(vk, vp) <= tol
    empty = st.aid >= sim.n_atoms
    assert bool(empty.any())
    assert not ek[empty].any() and not vk[empty].any()


def test_disp_peratom_wrappers_reject_bad_input(cuda, tmp_path):
    from lammps_buck_intel_tpu_torch.ops import pppm_disp as disp_ops

    sim = _peratom_case(cuda, "hexane_cut", "single", tmp_path)
    solver = sim.kspace
    pmd = solver.pmd
    c = pmd.consts(cuda, torch.float32)
    nx, ny, nzh = c["G"].shape
    S = torch.zeros((1, nx, ny, nzh), dtype=torch.complex64, device=cuda)
    with pytest.raises(TypeError):      # S of another dtype
        disp_ops.disp_peratom_spectral(c, S.to(torch.complex128), pmd.P)
    with pytest.raises(ValueError):     # a pairing of another size
        disp_ops.disp_peratom_spectral(c, S, np.ones((2, 2)))
    at = sim.atoms_on_device()
    n = sim.n_atoms
    row = torch.arange(n, dtype=torch.int32, device=cuda)
    table = torch.ones((1, n), device=cuda)
    meshes = torch.zeros((1, 7) + pmd.grid, device=cuda)
    Pm = torch.ones((1, 1), device=cuda)
    args = (Pm, torch.ones(1, device=cuda), 1.0, 1.0, 1.0)
    with pytest.raises(ValueError):     # six meshes
        disp_ops.disp_peratom_gather(solver.pm, at["x"], row, table,
                                     meshes[:, :6].contiguous(), c["coef"],
                                     *args)
    with pytest.raises(TypeError):      # aid of another dtype
        disp_ops.disp_peratom_gather(solver.pm, at["x"], row, table, meshes,
                                     c["coef"], *args, aid=row.long(),
                                     n_atoms=n)
    with pytest.raises(TypeError):      # meshes of another dtype
        disp_ops.disp_peratom_gather(solver.pm, at["x"], row, table,
                                     meshes.double(), c["coef"], *args)


# ---- the rest of the Coulomb k-space: K10 ad spectral, K10 ad gather,
# K10 slab, K11 traced ----

def _kspace_rest_box(dev, flt, n=400, seed=5, neutral=True):
    """n random charges in a 12 x 12.5 x 10.5 box, their mean subtracted
    unless ``neutral`` is False (then Q = sum q is about 0.1 n)."""
    rng = np.random.RandomState(seed)
    Lb = np.array([12.0, 12.5, 10.5])
    x = rng.uniform(0, 1, (n, 3)) * Lb - 0.3
    q = rng.uniform(-1, 1, n)
    q -= q.mean() if neutral else q.mean() - 0.1
    t = lambda a: torch.as_tensor(a).to(dev, flt)  # noqa: E731
    return Lb, q, t(x.T.copy()), t(q)


def _elong_close(ek, ep, elong_self: float, etol: float) -> bool:
    """elong on the card against the plain version's, relative to the part
    the kernels compute (elong less the constant self and background
    terms): on these random boxes the two nearly cancel (elong 131 of a
    reciprocal part of 17,924 with ad and slab in f64), and the f32 sum's
    own rounding exceeds 1e-5 of what is left."""
    scale = max(abs(float(ep)), abs(float(ep) - elong_self))
    return abs(float(ek) - float(ep)) <= etol * scale


@pytest.mark.parametrize("diff,slab,neutral", [
    ("ad", None, True), ("ik", 3.0, True), ("ad", 3.0, True),
    ("ik", 3.0, False)])
@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_pppm_ad_slab_kernels_match_plain(cuda, diff, slab, neutral, flt,
                                          acc):
    """PPPM.compute on the card with ad and / or slab (K5, K10 ad spectral
    or K7, K10 ad gather or K8, K10 slab) against pppm_compute_plain on
    the same card; the ad stages alone against their plain versions.  The
    charged case (``neutral`` False) holds K10 slab's Q terms."""
    from lammps_buck_intel_tpu_torch.models.kspace import pppm as tpppm
    from lammps_buck_intel_tpu_torch.ops import pppm as pppm_ops

    Lb, q, xt, qt = _kspace_rest_box(cuda, flt, neutral=neutral)
    assert neutral or abs(q.sum()) > 10.0
    pm = setup_pppm(make_box([0.0, 0.0, 0.0], Lb), q, cutoff=4.0,
                    accuracy_rel=1e-5, qqrd2e=332.06371, order=7,
                    acc_dtype=acc, diff=diff, slab=slab)
    keys = ("pppm_ad_spectral", "pppm_gather_ad", "pppm_slab")
    before = {k: ops.LAUNCHES[k] for k in keys}
    rk = pm.compute(xt, qt, eflag=True, vflag=True)
    rp = tpppm.pppm_compute_plain(pm, xt, qt, True, True)
    want = {"pppm_ad_spectral": diff == "ad", "pppm_gather_ad": diff == "ad",
            "pppm_slab": slab is not None}
    for k in keys:
        assert ops.LAUNCHES[k] == before[k] + int(want[k]), k
    ftol, etol = (1e-4, 1e-5) if flt == torch.float32 else (1e-11, 1e-11)
    assert _close(torch.stack(rk.f), torch.stack(rp.f), ftol)
    assert _elong_close(rk.elong, rp.elong, pm.elong_self, etol)
    assert _close(rk.virial, rp.virial, etol)
    if diff == "ad":
        c = pm.consts(cuda, flt)
        planes = pppm_cells.AtomPlanes(xt[0], xt[1], xt[2], qt,
                                       torch.arange(400, dtype=torch.int32,
                                                    device=cuda))
        mesh = pppm_cells.deposit_plain(pm, planes)
        rhat = torch.fft.rfftn(mesh.to(acc)).contiguous()
        sc = dict(G=c["G_half"], k3=c["k3"], wz=c["wz"],
                  g_ewald=pm.g_ewald, nyquist=True)
        kk = c["k3"]
        ksq = kk[0] * kk[0] + kk[1] * kk[1] + kk[2] * kk[2]
        sc["pref"] = 2.0 * (1.0 / torch.where(ksq == 0, torch.ones_like(
            ksq), ksq) + 0.25 / pm.g_ewald ** 2)
        pk, esk, vsk = pppm_ops.spectral(sc, rhat, True, ad=True)
        pp, esp, vsp = pppm_cells.spectral_plain(sc, rhat, True, True, True)
        assert _close(torch.view_as_real(pk), torch.view_as_real(pp), ftol)
        assert abs(float(esk - esp)) <= etol * abs(float(esp))
        assert _close(vsk, vsp, etol)
        u = torch.fft.irfftn(pp, s=pm.grid).to(flt).contiguous()
        fk = pppm_ops.gather_ad(pm, planes, u, 400, acc, c["coef"],
                                c["dcoef"], c["sf"])
        fp = pppm_cells.gather_ad_plain(pm, planes, u, acc, c["sf"])
        assert _close(torch.stack(fk), torch.stack(fp), ftol)


@pytest.mark.parametrize("prec", ["single", "double"])
def test_cell_pppm_ad_kernels_match_plain(cuda, prec):
    """CellPPPM ad on the slot planes (K10 ad gather with the slots' aid,
    empty slots 0) against the same solver on CPU copies (plain)."""
    flt = acc = torch.float32 if prec == "single" else torch.float64
    pm, solver, st = _pppm(cuda, flt, acc)
    import dataclasses

    from lammps_buck_intel_tpu_torch.models.kspace import pppm as tpppm

    pm = dataclasses.replace(
        pm, diff="ad", _consts={},
        sf_sine=tpppm._sf_sine_fit(pm.grid, np.asarray([12.0] * 3),
                                   pm.greensfn, pm.order))
    solver = CellPPPM(pm, solver.n_atoms, bricks=solver.bricks)
    before = dict(ops.LAUNCHES)
    rk = solver.compute_slots(st, True, True)
    for k in ("pppm_gather_ad", "pppm_deposit_cells"):
        assert ops.LAUNCHES[k] == before[k] + 1, k
    cpu = st._replace(**{k: getattr(st, k).cpu() for k in st._fields
                         if getattr(st, k) is not None})
    rp = CellPPPM(pm, solver.n_atoms).compute_slots(cpu, True, True)
    ftol, etol = (1e-4, 1e-5) if flt == torch.float32 else (1e-11, 1e-11)
    assert _close(torch.stack(rk[:3]).cpu(), torch.stack(rp[:3]), ftol)
    assert abs(float(rk[3]) - float(rp[3])) <= etol * abs(float(rp[3]))
    assert bool((rk[0][st.aid >= solver.n_atoms] == 0).all())


@pytest.mark.parametrize("diff,slab", [("ad", None), ("ik", 3.0),
                                       ("ad", 3.0)])
@pytest.mark.parametrize("prec", ["single", "double"])
def test_traced_pppm_ad_slab_kernels_match_plain(cuda, diff, slab, prec):
    """TracedPPPM ad / slab with the box on the card (K10 ad gather and
    K10 slab reading boxL) against the same solver on the CPU."""
    from lammps_buck_intel_tpu_torch.models.kspace.pppm_npt import TracedPPPM

    flt = acc = torch.float32 if prec == "single" else torch.float64
    Lb, q, xt, qt = _kspace_rest_box(cuda, flt)
    pm = setup_pppm(make_box([0.0, 0.0, 0.0], Lb), q, cutoff=4.0,
                    accuracy_rel=1e-4, qqrd2e=332.06371, order=5,
                    acc_dtype=acc, diff=diff, slab=slab)
    tp = TracedPPPM(pm, 0.5 * Lb)
    L1 = torch.as_tensor(Lb * np.array([1.03, 0.99, 1.02])).to(cuda, flt)
    before = {k: ops.LAUNCHES[k] for k in ("pppm_gather_ad", "pppm_slab")}
    rk = tp.compute_traced(xt, qt, L1)
    assert ops.LAUNCHES["pppm_gather_ad"] == before["pppm_gather_ad"] + \
        int(diff == "ad")
    assert ops.LAUNCHES["pppm_slab"] == before["pppm_slab"] + \
        int(slab is not None)
    rp = tp.compute_traced(xt.cpu(), qt.cpu(), L1.cpu())
    ftol, etol = (1e-4, 1e-5) if flt == torch.float32 else (1e-11, 1e-11)
    assert _close(torch.stack(rk.f).cpu(), torch.stack(rp.f), ftol)
    assert _elong_close(rk.elong, rp.elong, pm.elong_self, etol)


@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_ewald_traced_kernel_matches_plain(cuda, flt, acc):
    """K11 traced (the tables of a box on the card) against
    traced_tables_plain, and compute_traced on the card (K11 traced, K11a,
    K11b) against ewald_compute_traced_plain on the same card."""
    from lammps_buck_intel_tpu_torch.models.kspace import setup_ewald
    from lammps_buck_intel_tpu_torch.models.kspace import ewald as tewald
    from lammps_buck_intel_tpu_torch.ops import ewald as ewald_ops

    Lb, q, xt, qt = _kspace_rest_box(cuda, flt, n=300)
    ew = setup_ewald(make_box([0.0, 0.0, 0.0], Lb), q, cutoff=4.0,
                     accuracy_rel=1e-4, qqrd2e=332.06371, acc_dtype=acc)
    L1 = torch.as_tensor(Lb * np.array([1.03, 0.99, 1.02])).to(cuda, flt)
    m = ew.m_rows(cuda, flt)
    before = ops.LAUNCHES["ewald_traced"]
    tk = ewald_ops.ewald_traced(m, L1, ew.g_ewald, acc)
    tp = tewald.traced_tables_plain(m, L1, ew.g_ewald, acc)
    assert ops.LAUNCHES["ewald_traced"] == before + 1
    tol = 1e-5 if flt == torch.float32 else 1e-12
    for k in ("kv_rows", "ug", "ug_acc", "vfac"):
        assert _close(tk[k], tp[k], tol), k
    rk = ew.compute_traced(xt, qt, L1)
    rp = tewald.ewald_compute_traced_plain(ew, xt, qt, L1)
    ftol, etol = (3e-4, 1e-5) if flt == torch.float32 else (1e-11, 1e-11)
    assert _close(torch.stack(rk.f), torch.stack(rp.f), ftol)
    assert _elong_close(rk.elong, rp.elong, ew.elong_self, etol)
    assert _close(rk.virial, rp.virial, etol)


def test_kspace_rest_wrappers_reject_bad_input(cuda):
    from lammps_buck_intel_tpu_torch.ops import ewald as ewald_ops
    from lammps_buck_intel_tpu_torch.ops import pppm as pppm_ops

    Lb, q, xt, qt = _kspace_rest_box(cuda, torch.float32)
    pm = setup_pppm(make_box([0.0, 0.0, 0.0], Lb), q, cutoff=4.0,
                    accuracy_rel=1e-4, qqrd2e=332.06371, diff="ad",
                    slab=3.0)
    c = pm.consts(cuda, torch.float32)
    planes = pppm_cells.AtomPlanes(xt[0], xt[1], xt[2], qt,
                                   torch.arange(400, dtype=torch.int32,
                                                device=cuda))
    u = torch.zeros(pm.grid, device=cuda)
    with pytest.raises(ValueError):
        pppm_ops.gather_ad(pm, planes, u, 400, torch.float32, c["coef"],
                           c["dcoef"], c["sf"].t())
    with pytest.raises(TypeError):
        pppm_ops.gather_ad(pm, planes, u.double(), 400, torch.float32,
                           c["coef"], c["dcoef"], c["sf"])
    fz = torch.zeros(400, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        pppm_ops.slab(pm, xt[2], qt, fz, True)
    with pytest.raises(ValueError):
        ewald_ops.ewald_traced(torch.zeros((4, 3), device=cuda),
                               torch.ones(3, device=cuda), 0.3,
                               torch.float32)


# ---- K1's two phases: determinism, the queue's flush, edge cells, counters

def _full_lattice(dev, flt, drop_cell=None, cut=2.5, seed=4, style="fcc",
                  rho=0.8442, nlat=6, cap=32, qlo=-1.0):
    """A lattice shifted a quarter site off the cell walls and jittered
    by 0.15 on 3 x 3 x 3 cells: by default fcc 6^3, cells of exactly 32
    atoms, so cap 32 fills every slot; ``drop_cell`` (cx, cy, cz)
    removes that cell's atoms.  Charges are uniform on [qlo, 1)."""
    x, lo, hi = lattice.create_atoms(style, rho, nlat, nlat, nlat)
    L = np.asarray(hi) - np.asarray(lo)
    x = x + 0.25 * L / nlat
    rng = np.random.default_rng(seed)
    x = x + rng.uniform(-0.15, 0.15, x.shape)
    cell = np.floor((x - lo) / (L / 3)).astype(int)
    if drop_cell is not None:
        x = x[~(cell == np.asarray(drop_cell)).all(1)]
    n = len(x)
    box = make_box(lo, hi)
    grid = cs.CellGrid(nc=(3, 3, 3), cap=cap, n_atoms=n)
    t = lambda a, dt=flt: torch.as_tensor(a).to(dev, dt)  # noqa: E731
    st = cs.from_atoms(grid, box, t(x), t(np.zeros((n, 3))),
                       t(np.zeros((n, 3)), torch.int32),
                       t(rng.integers(0, 2, n), torch.int32),
                       t(rng.uniform(qlo, 1, n)), dtype=flt)
    assert not bool(st.overflow)
    style = build_buck(2, {(0, 0): (1.0, 0.2, -0.8), (0, 1): (0.9, 0.22, -0.7),
                           (1, 1): (1.1, 0.18, -0.9)}, cut_global=cut,
                       shift=True, coul="long", qqrd2e=14.399645)
    return grid, box, st, style.replace(g_ewald=0.3)


def _assert_matches_plain(k, p, flt):
    ftol, etol = (1e-11, 1e-11) if flt == torch.float64 else (1e-4, 1e-5)
    fk, fp = (torch.stack([r.fx, r.fy, r.fz]) for r in (k, p))
    assert float((fk - fp).abs().max()) <= ftol * float(fp.abs().max())
    for e in ("evdwl", "ecoul"):
        a, b = float(getattr(k, e)), float(getattr(p, e))
        assert abs(a - b) <= etol * abs(b), e
    assert float((k.virial - p.virial).abs().max()) <= \
        etol * float(p.virial.abs().max())


@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_cellpair_kernel_is_deterministic(cuda, flt, acc):
    """Two launches on one state give bitwise-equal forces, energies and
    virial: the owners sum in queue order, and nothing is atomic."""
    cases = [_state(cuda, flt, ntypes=2, reach_z=2, coul=True)]
    grid, box, st, style, table, _, _ = _rhodo(cuda, flt)
    cases.append((grid, box, st, style, table))
    for case in cases:
        grid, box, st, style = case[:4]
        special = case[4] if len(case) > 4 else None
        a, b = (compute_cellpair(style, grid, box, st, eflag=True,
                                 vflag=True, acc_dtype=acc, special=special)
                for _ in range(2))
        for name, u, v in zip(a._fields, a, b):
            assert torch.equal(u, v), name


@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_cellpair_kernel_keeps_newtons_third_law(cuda, flt, acc):
    """Each pair's force and reaction are one rounded product with two
    signs, so on the rhodo state with specials the kernel's forces sum to
    zero to the rounding of their acc sums (a lost or doubled reaction of
    a typical pair, ~50 kcal/mol/A, shows in f64)."""
    grid, box, st, style, table, _, _ = _rhodo(cuda, flt)
    k = compute_cellpair(style, grid, box, st, acc_dtype=acc, special=table)
    f = torch.stack([k.fx, k.fy, k.fz]).double()
    assert bool((f[:, st.aid >= grid.n_atoms] == 0).all())
    tol = 16 * torch.finfo(acc).eps * float(f.abs().sum())
    assert float(f.sum(1).abs().max()) <= tol


@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_cellpair_dense_tile_flushes_the_queue(cuda, flt, acc):
    """Every candidate in range: cap 32 holds 32 atoms in every cell, and
    the cutoff (2 box lengths) exceeds every stencil distance, so each
    chunk of the 13 positive tiles queues 32 x 32 entries, the own cell's
    the 496 of slot j > slot i, and the warp flushes after each chunk."""
    from lammps_buck_intel_tpu_torch.utils import trace

    grid, box, st, style = _full_lattice(cuda, flt, cut=20.0)
    trace.reset()
    trace.enable()
    try:
        k = compute_cellpair(style, grid, box, st, eflag=True, vflag=True,
                             acc_dtype=acc)
        c = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    p = compute_cellpair_plain(style, grid, box, st, eflag=True, vflag=True,
                               acc_dtype=acc)
    _assert_matches_plain(k, p, flt)
    n, K = grid.n_atoms, 14
    assert c["cellpair.tested"] == n * K * 32
    assert c["cellpair.in_range"] == grid.ncell * ((K - 1) * 1024 + 496)
    # 32 full rounds in each positive tile; the own cell's 496 entries
    # take 16 rounds
    assert c["cellpair.eval_lanes"] == grid.ncell * ((K - 1) * 1024 + 512)


@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_cellpair_empty_cell_and_full_cap(cuda, flt, acc):
    """One cell empty, the other 26 at exactly cap (no empty slot, no
    tail chunk): the kernel against its plain version."""
    grid, box, st, style = _full_lattice(cuda, flt, drop_cell=(1, 1, 1))
    per_cell = (st.aid < grid.n_atoms).view(grid.ncell, grid.cap).sum(1)
    assert int(per_cell.min()) == 0 and int(per_cell.max()) == grid.cap
    assert int((per_cell == grid.cap).sum()) == grid.ncell - 1
    k = compute_cellpair(style, grid, box, st, eflag=True, vflag=True,
                         acc_dtype=acc)
    p = compute_cellpair_plain(style, grid, box, st, eflag=True, vflag=True,
                               acc_dtype=acc)
    _assert_matches_plain(k, p, flt)
    f_only = compute_cellpair(style, grid, box, st, acc_dtype=acc)
    _assert_matches_plain(f_only._replace(evdwl=k.evdwl, ecoul=k.ecoul,
                                          virial=k.virial), p, flt)


@pytest.mark.parametrize("flt,acc", PRECISIONS)
def test_cellpair_cap_over_one_slot_group(cuda, flt, acc):
    """cap 352, over the kernel's 256 threads a block: each block walks
    the half stencil once for slots 0-255 and again for 256-351, which hold
    up to 87 atoms in most cells and none in two (sc 20^3 at density 1,
    cells of 248 to 343 atoms).  Force-only and EV against the plain
    version, and the counters against the plain version's.  Charges of
    one sign, so that ecoul is not a small sum of large terms of both
    signs."""
    from lammps_buck_intel_tpu_torch.utils import trace

    grid, box, st, style = _full_lattice(cuda, flt, style="sc", rho=1.0,
                                         nlat=20, cap=352, qlo=0.5)
    per_cell = (st.aid < grid.n_atoms).view(grid.ncell, grid.cap).sum(1)
    assert int(per_cell.max()) > 256 > int(per_cell.min())
    got = {}
    trace.reset()
    for fn in (compute_cellpair, compute_cellpair_plain):
        trace.enable()
        try:
            got[fn] = fn(style, grid, box, st, eflag=True, vflag=True,
                         acc_dtype=acc), trace.counters()
        finally:
            trace.disable()
            trace.reset()
    (k, ck), (p, cp) = got[compute_cellpair], got[compute_cellpair_plain]
    _assert_matches_plain(k, p, flt)
    f_only = compute_cellpair(style, grid, box, st, acc_dtype=acc)
    _assert_matches_plain(f_only._replace(evdwl=k.evdwl, ecoul=k.ecoul,
                                          virial=k.virial), p, flt)
    assert ck["cellpair.tested"] == cp["cellpair.tested"] == \
        grid.n_atoms * 14 * grid.cap
    assert ck["cellpair.in_range"] == cp["cellpair.in_range"] > 0
    lanes = ck["cellpair.eval_lanes"]
    assert ck["cellpair.in_range"] <= lanes and lanes % 32 == 0


def test_cellpair_counters_match_plain_on_cristobalite(cuda):
    """The kernel's candidates tested and pairs in range equal the plain
    version's on a jittered copy of cristobalite_pppm.yaml (6 x 7.5 x 5.6
    nm, 51,840 atoms); its evaluate lane slots, the kernel's alone, are
    whole rounds of 32 and at least 85% busy; with the tracer off the
    wrapper passes no buffer and nothing counts."""
    import os

    import yaml

    from lammps_buck_intel_tpu_torch.run import build_simulation
    from lammps_buck_intel_tpu_torch.utils import trace

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "examples", "decks",
                           "cristobalite_pppm.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(read_data=os.path.join(root, cfg["read_data"]),
               replicate=[3, 3, 4])
    sim = build_simulation(cfg, device=cuda)
    st = sim.state
    rng = np.random.default_rng(9)
    for plane in (st.x, st.y, st.z):
        plane += torch.as_tensor(rng.uniform(-0.1, 0.1, plane.shape[0])).to(
            plane)
    st = cs.rebin(sim.grid, sim.box, st)
    names = ("tested", "in_range", "eval_lanes")
    got = {}
    trace.reset()
    for fn in (compute_cellpair, compute_cellpair_plain):
        trace.enable()
        try:
            fn(sim.pair, sim.grid, sim.box, st, acc_dtype=torch.float32)
            c = trace.counters()
        finally:
            trace.disable()
            trace.reset()
        got[fn.__name__] = [c[f"cellpair.{k}"] for k in names]
    tested, in_range, lanes = got["compute_cellpair"]
    assert got["compute_cellpair_plain"] == [tested, in_range, 0]
    assert lanes % 32 == 0
    assert tested == sim.n_atoms * (9 * sim.grid.reach_z + 5) * \
        sim.grid.cap
    assert 0.05 < in_range / tested < 0.12
    assert in_range / lanes >= 0.85
    compute_cellpair(sim.pair, sim.grid, sim.box, st,
                     acc_dtype=torch.float32)
    assert all(trace.counters()[f"cellpair.{k}"] == 0 for k in names)
