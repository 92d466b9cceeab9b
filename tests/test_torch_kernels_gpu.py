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
    every term away from the arccos clip."""
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
