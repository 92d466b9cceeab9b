"""SHAKE/RATTLE holonomic distance constraints (``fix shake``).

Counterpart of ``lammps_buck_intel_tpu.integrate.shake`` in the form the
cell-pair engine runs: the constraints are grouped into disjoint clusters
(``make_clusters``, a union-find) and each cluster's (C, C) system in
constraint space is solved exactly, per cluster, with unpivoted, guarded
Gaussian elimination (``_solve_small``):

* ``shake_ref``: the reference bond vectors ro = x_i - x_j (minimum
  image) at the start of a step, before the drift moves the positions;
* ``shake_positions``: after the drift, exactly min(iters, 4) Newton
  iterations in constraint space move x along ro until |r|^2 = d^2, and
  v += (x_fix - x_new) / dt; returns the corrected bond vectors rn;
* ``rattle_velocities``: after the second kick, the one-shot (C, C)
  solve that projects the velocity along every constraint out, reusing
  SHAKE's rn;
* ``shake_virial``: the constraint virial at a thermo row, from the
  instantaneous multipliers on the TOTAL force (the fix_shake.cpp
  pressure tally), in the exact per-cluster form.

Every engine sets up with ``shake_tables`` (the clusters' tables, checked
against the kernels' width) and ``settle`` (the state put on the
constraints before the first force).

The box ``L``: host lengths (the cell engine), or a (3,) tensor of
lengths on the card (the NPT engine, whose box changes every step and is
read by the kernels where it lives); in atom order ``inv`` is the
identity.

Layout.  The engine's positions are slot planes; the cluster tables hold
ATOM ids, and every function reads a cluster's atoms through the
slot-of-atom map ``inv`` (rebuilt after each rebin), so no rebin has to
gather anything.  The per-cluster tables are lanes-last, (A, M) and
(C, M) with the cluster index M minor, as the JAX package's
``_lanes_last`` keeps them; pad atoms and pad constraints (clusters
smaller than the widest) are masked and never read or written through
``inv``.  The bond vectors ro and rn are (3, C, M).

On CUDA planes each function launches its kernel of csrc/shake.cu through
``ops.shake``; on CPU planes it runs the ``*_plain`` version below, the
JAX package's arithmetic in torch ops.  Positions and velocities are
updated in place.  The scatter (Jacobi) forms of the JAX package
(``shake_positions``, ``rattle_velocities`` and ``shake_virial`` without
clusters) are not ported: the engine runs the clustered forms, which
agree with them where both converge.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils import trace

# widest cluster the kernels of csrc/shake.cu take (constraints per
# cluster): C-H bonds need 1, rigid water and CH3 groups 3, the octahedron
# of 12 edge constraints of the JAX package's tests 12
MAX_C = 12


@dataclasses.dataclass(frozen=True)
class ShakeConstraints:
    """pairs: (Nc, 2) int32 atom indices; d2: (Nc,) squared target
    lengths; invm: (N,) 1/mass per atom (host numpy).  iters: the deck's
    iteration count (the Newton solve takes min(iters, 4)).
    n_independent: independent constraint count for the degrees of
    freedom (-1: all of ``pairs``).  tol: the deck's tolerance on
    |r^2 - d^2| / d^2, which ``unconverged`` counts clusters against."""

    pairs: np.ndarray
    d2: np.ndarray
    invm: np.ndarray
    iters: int = 20
    n_independent: int = -1
    tol: float = 1e-4

    @property
    def n_constraints(self) -> int:
        return (self.n_independent if self.n_independent >= 0
                else len(self.pairs))


def make_shake(bonds: np.ndarray, bond_coeffs: np.ndarray,
               angles: np.ndarray, angle_coeffs: np.ndarray,
               mass_per_atom: np.ndarray, bond_types=(0,), angle_types=(0,),
               iters: int = 20, tol: float = 1e-4) -> ShakeConstraints:
    """The constraint list from the topology (``b ... a ...``).

    An angle constraint i-j-k (j central) becomes the fixed i..k distance
    by the law of cosines over the wing bonds' rest lengths,
    r_ij^2 + r_jk^2 - 2 r_ij r_jk cos theta0."""
    pairs, d2 = [], []
    r0_of_bond_type = {int(t): float(bond_coeffs[int(t), 1])
                       for t in range(len(bond_coeffs))}
    bond_arr = np.asarray(bonds, np.int64)
    type_of_pair = {(min(int(i), int(j)), max(int(i), int(j))): int(bt)
                    for bt, i, j in bond_arr}

    def _wing_r0(a: int, b: int) -> float:
        bt = type_of_pair.get((min(a, b), max(a, b)))
        if bt is None or bt not in r0_of_bond_type:
            raise ValueError(
                f"shake angle constraint references wing bond ({a},{b}) "
                "with no bond entry/coefficients in the topology")
        return r0_of_bond_type[bt]

    for bt, i, j in bond_arr:
        if int(bt) in bond_types:
            pairs.append((i, j))
            d2.append(r0_of_bond_type[int(bt)] ** 2)
    for at, i, j, k in np.asarray(angles, np.int64):
        if int(at) in angle_types:
            th0 = math.radians(float(angle_coeffs[int(at), 1]))
            ri = _wing_r0(int(j), int(i))
            rk = _wing_r0(int(j), int(k))
            pairs.append((i, k))
            d2.append(ri * ri + rk * rk - 2.0 * ri * rk * math.cos(th0))
    if not pairs:
        raise ValueError(
            "fix shake selected no constraints: check the b/a type lists "
            "or the m mass list against the topology")
    return ShakeConstraints(
        pairs=np.asarray(pairs, np.int32), d2=np.asarray(d2, np.float64),
        invm=1.0 / np.asarray(mass_per_atom, np.float64), iters=iters,
        tol=float(tol))


def make_rigid_from_molecules(*args, **kwargs):
    """``fix rigid/small`` by redundant distance constraints: not ported."""
    raise NotImplementedError(
        "make_rigid_from_molecules (fix rigid/small style constraints) is "
        "not ported (fix rigid/small runs as quaternion rigid bodies, "
        "integrate/rigid.py): ROADMAP queue 1 item 13(c)")


@dataclasses.dataclass
class ShakeClusters:
    """Constraints regrouped into disjoint clusters (host numpy, the JAX
    package's fields).

    atoms: (M, A) atom ids, -1 pad.  pi/pj: (M, C) local indices of each
    constraint's atoms.  d2: (M, C) targets (pad 1).  cmask/amask:
    validity.  w_upd: (M, C, A) update matrix (-invm_i at pi, +invm_j at
    pj).  invm_sum: (M, C) invm_i + invm_j (pad 1).  corig: (M, C) index
    of each constraint in the ShakeConstraints list (pad 0).  Constraints
    and atoms fill each cluster's leading entries; pads follow."""

    atoms: np.ndarray
    pi: np.ndarray
    pj: np.ndarray
    d2: np.ndarray
    cmask: np.ndarray
    amask: np.ndarray
    w_upd: np.ndarray
    invm_sum: np.ndarray
    corig: np.ndarray
    # (device, dtype) -> the tables as tensors, copied to a device once
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def width(self) -> int:
        """C, the constraints of the widest cluster."""
        return self.pi.shape[1]

    def tables_on(self, device, flt) -> dict:
        """The lanes-last tables on ``device``, as the kernels and the
        plain versions read them (M minor, contiguous):

        atoms (A, M) int32, -1 pad; pi, pj (C, M) int32 local indices, -1
        on a pad constraint; ci, cj (C, M) int64 atom ids of each
        constraint's ends (0 on a pad); cmask (C, M), amask (A, M), d2
        (C, M), invm (A, M) per-local-atom 1/mass (0 pad); K (C, C, M) the
        constraint-space coupling sum_a D[c, a] W[d, a] (D the +-1
        difference, W the update matrix) and WT (C, A, M) the update
        matrix, both formed in f64 and rounded once to ``flt``, as the
        JAX package bakes them."""
        key = (torch.device(device), flt)
        t = self._on_device.get(key)
        if t is not None:
            return t
        M, C = self.pi.shape
        A = self.atoms.shape[1]
        D = np.zeros((C, A, M))
        m_idx = np.arange(M)
        for c in range(C):
            np.add.at(D[c], (self.pi[:, c], m_idx), self.cmask[:, c])
            np.add.at(D[c], (self.pj[:, c], m_idx), -self.cmask[:, c])
        WT = self.w_upd.transpose(1, 2, 0)
        K = np.einsum("cam,dam->cdm", D, WT)
        invm_a = np.zeros((M, A))
        for c in range(C):
            ok = self.cmask[:, c] > 0
            invm_a[m_idx[ok], self.pi[ok, c]] = -self.w_upd[m_idx[ok], c,
                                                            self.pi[ok, c]]
            invm_a[m_idx[ok], self.pj[ok, c]] = self.w_upd[m_idx[ok], c,
                                                           self.pj[ok, c]]
        valid = self.cmask > 0
        atoms = self.atoms.astype(np.int64)
        ci = np.take_along_axis(atoms, self.pi.astype(np.int64), 1)
        cj = np.take_along_axis(atoms, self.pj.astype(np.int64), 1)

        def ints(a, dt=torch.int32):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device, dt)

        def real(a):
            return torch.as_tensor(np.ascontiguousarray(
                a, np.float64)).to(device, flt)

        t = dict(
            atoms=ints(self.atoms.T),
            pi=ints(np.where(valid, self.pi, -1).T),
            pj=ints(np.where(valid, self.pj, -1).T),
            ci=ints(np.where(valid, ci, 0).T, torch.int64),
            cj=ints(np.where(valid, cj, 0).T, torch.int64),
            cmask=real(self.cmask.T), amask=real(self.amask.T),
            d2=real(self.d2.T), invm=real(invm_a.T), K=real(K), WT=real(WT))
        self._on_device[key] = t
        return t


def make_clusters(sc: ShakeConstraints) -> ShakeClusters:
    """Group constraints into connected components (union-find)."""
    pairs = np.asarray(sc.pairs, np.int64)
    parent: dict = {}

    def find(a):
        r = a
        while parent.setdefault(r, r) != r:
            r = parent[r]
        while parent[a] != r:
            parent[a], a = r, parent[a]
        return r

    for i, j in pairs:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[rj] = ri
    comp: dict = {}
    for c, (i, j) in enumerate(pairs):
        comp.setdefault(find(int(i)), []).append(c)
    clusters = list(comp.values())
    M = len(clusters)
    A = max(len({int(a) for c in cl for a in pairs[c]}) for cl in clusters)
    C = max(len(cl) for cl in clusters)
    atoms = np.full((M, A), -1, np.int32)
    pi = np.zeros((M, C), np.int32)
    pj = np.zeros((M, C), np.int32)
    d2 = np.ones((M, C), np.float64)
    cmask = np.zeros((M, C), np.float64)
    amask = np.zeros((M, A), np.float64)
    w_upd = np.zeros((M, C, A), np.float64)
    invm_sum = np.ones((M, C), np.float64)
    corig = np.zeros((M, C), np.int64)
    d2_all = np.asarray(sc.d2, np.float64)
    invm = np.asarray(sc.invm, np.float64)
    for m, cl in enumerate(clusters):
        local: dict = {}
        for c in cl:
            for a in (int(pairs[c, 0]), int(pairs[c, 1])):
                if a not in local:
                    local[a] = len(local)
        for a, la in local.items():
            atoms[m, la] = a
            amask[m, la] = 1.0
        for k, c in enumerate(cl):
            ia, ja = int(pairs[c, 0]), int(pairs[c, 1])
            li, lj = local[ia], local[ja]
            pi[m, k] = li
            pj[m, k] = lj
            d2[m, k] = d2_all[c]
            cmask[m, k] = 1.0
            corig[m, k] = c
            w_upd[m, k, li] = -invm[ia]
            w_upd[m, k, lj] = invm[ja]
            invm_sum[m, k] = invm[ia] + invm[ja]
    return ShakeClusters(atoms=atoms, pi=pi, pj=pj, d2=d2, cmask=cmask,
                         amask=amask, w_upd=w_upd, invm_sum=invm_sum,
                         corig=corig)


def _minimg_planes(dx, dy, dz, L):
    """Per-axis minimum image d - round(d * (1 / L)) L (round half to
    even): host lengths with the reciprocal taken in f64, or a (3,) tensor
    of lengths on the planes' device (the variable cell), its reciprocal
    taken in its dtype."""
    from ..core.box import minimum_image_planes

    return minimum_image_planes(dx, dy, dz, L)


def max_violation(sc: ShakeConstraints, x: torch.Tensor, L) -> torch.Tensor:
    """Diagnostic: max |r^2/d^2 - 1| over the constraints; x: (N, 3)
    positions in atom order."""
    i = torch.as_tensor(sc.pairs[:, 0], dtype=torch.long, device=x.device)
    j = torch.as_tensor(sc.pairs[:, 1], dtype=torch.long, device=x.device)
    d = x[i] - x[j]
    r = torch.stack(_minimg_planes(d[:, 0], d[:, 1], d[:, 2],
                                   np.asarray(L, np.float64)), -1)
    rsq = (r * r).sum(1)
    d2 = torch.as_tensor(sc.d2, device=x.device).to(x.dtype)
    return (rsq / d2 - 1.0).abs().max()


# ---------- plain torch versions (the kernels' arithmetic) ----------

def _differences(t: dict, planes, inv) -> torch.Tensor:
    """(3, C, M) p_i - p_j of every constraint (no image), 0 on pads."""
    si, sj = inv.long()[t["ci"]], inv.long()[t["cj"]]
    return torch.stack([p[si] - p[sj] for p in planes]) * t["cmask"]


def _bond_vectors(t: dict, planes, inv, L) -> torch.Tensor:
    """(3, C, M) minimum-imaged x_i - x_j of every constraint, 0 on pads."""
    return torch.stack(_minimg_planes(*_differences(t, planes, inv), L))


def _local_slots(t: dict, inv):
    """Boolean (A, M) mask of the real local atoms and their slots."""
    ok = t["amask"] > 0
    return ok, inv.long()[t["atoms"].long()[ok]]


def _solve_small(J, F, cmask):
    """Batched exact solve of the (C, C) system per cluster on the lanes.

    J: (C, C, M), F: (C, M); unrolled, unpivoted Gaussian elimination (C
    is small and J has a dominant diagonal); pad constraints get identity
    rows and columns so their solution is 0; a pivot below 1e-12 in
    magnitude is replaced by +-1e-12."""
    C = F.shape[0]
    A = [[J[i, d] * (cmask[i] * cmask[d]) for d in range(C)]
         for i in range(C)]
    for i in range(C):
        A[i][i] = torch.where(cmask[i] > 0, A[i][i],
                              torch.ones_like(A[i][i]))
    b = [F[i] * cmask[i] for i in range(C)]
    for k in range(C):
        piv = A[k][k]
        piv = torch.where(piv.abs() > 1e-12, piv,
                          torch.where(piv < 0, torch.full_like(piv, -1e-12),
                                      torch.full_like(piv, 1e-12)))
        inv = 1.0 / piv
        A[k][k] = piv
        for i in range(k + 1, C):
            f = A[i][k] * inv
            for j in range(k + 1, C):
                A[i][j] = A[i][j] - f * A[k][j]
            b[i] = b[i] - f * b[k]
    x = [None] * C
    for k in reversed(range(C)):
        s = b[k]
        for j in range(k + 1, C):
            s = s - A[k][j] * x[j]
        x[k] = s / A[k][k]
    return torch.stack(x)


def _apply(t: dict, inv, planes, coef, r):
    """planes[slot of a] += sum_c WT[c, a] (coef_c r_c) for every real
    local atom a, in place; returns the (3, A, M) update."""
    d = (t["WT"][None] * (coef[None] * r)[:, :, None, :]).sum(1) * t["amask"]
    ok, slots = _local_slots(t, inv)
    for p, dp in zip(planes, d):
        p.index_add_(0, slots, dp[ok])
    return d


def shake_ref_plain(t, xs, inv, L):
    return _bond_vectors(t, xs, inv, L)


def shake_positions_plain(t, ro, xs, vs, inv, L, dt, iters,
                          virial_factor=None):
    rn = _bond_vectors(t, xs, inv, L)
    cmask, K = t["cmask"], t["K"]
    lam = torch.zeros_like(t["d2"])
    for _ in range(min(int(iters), 4)):
        F = ((rn * rn).sum(0) - t["d2"]) * cmask
        B = (rn[:, :, None, :] * ro[:, None, :, :]).sum(0)
        dlam = _solve_small(2.0 * B * K, -F, cmask)
        lam = lam + dlam
        rn = rn + (K[None] * (dlam * ro)[:, None, :, :]).sum(2)
    ok, slots = _local_slots(t, inv)
    x_new = [p[slots] for p in xs]
    _apply(t, inv, xs, lam, ro)
    if vs is not None:
        for v, x, xn in zip(vs, xs, x_new):
            v.index_add_(0, slots, (x[slots] - xn) / dt)
    if virial_factor is None:
        return rn
    w = (-lam * virial_factor)[None] * ro
    return rn, torch.stack([(ro[i] * w[j]).sum()
                            for i, j in ((0, 0), (1, 1), (2, 2), (0, 1),
                                         (0, 2), (1, 2))])


def rattle_velocities_plain(t, vs, inv, L, r=None, xs=None):
    if r is None:
        r = _bond_vectors(t, xs, inv, L)
    dv0 = _differences(t, vs, inv)
    B = (r[:, :, None, :] * r[:, None, :, :]).sum(0)
    mu = _solve_small(B * t["K"], -(r * dv0).sum(0), t["cmask"])
    _apply(t, inv, vs, mu, r)


def shake_virial_plain(t, xs, vs, fa, fb, inv, L, ftm2v, acc_dtype):
    flt = xs[0].dtype
    r = _bond_vectors(t, xs, inv, L)
    dv = _differences(t, vs, inv)
    f = tuple((a if b is None else a + b).to(flt)
              for a, b in zip(fa, fb or (None,) * 3))
    # (ftm2v / m) f per local atom, then the difference along each
    # constraint
    ok, slots = _local_slots(t, inv)
    pi, pj = t["pi"].long().clamp(min=0), t["pj"].long().clamp(min=0)
    da0 = []
    for p in f:
        a = torch.zeros_like(t["invm"])
        a[ok] = p[slots]
        a = ftm2v * t["invm"] * a
        da0.append(a.gather(0, pi) - a.gather(0, pj))
    da0 = torch.stack(da0) * t["cmask"]
    base = (dv * dv + r * da0).sum(0)
    B = (r[:, :, None, :] * r[:, None, :, :]).sum(0)
    lam = _solve_small(ftm2v * B * t["K"], -base, t["cmask"])
    w = (-lam * t["cmask"])[None] * r
    return torch.stack([(r[i] * w[j]).to(acc_dtype).sum()
                        for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                                     (1, 2))])


def unconverged(t: dict, rn: torch.Tensor, tol: float) -> torch.Tensor:
    """0-d int64 tensor on rn's device: the clusters that the SHAKE solve
    which returned the corrected bond vectors ``rn`` (3, C, M) left with a
    constraint's relative residual |rn^2 - d^2| / d^2 above ``tol`` (torch
    ops, no wait for the device).  It tests the solve's convergence, as
    LAMMPS' SHAKE tests its iterations, and not the stored positions
    against ``tol``: the bond vectors taken again from f32 positions carry
    the positions' own rounding, up to ~1e-4 at 300 A from the origin."""
    rel = ((rn * rn).sum(0) - t["d2"]).abs() / t["d2"] * t["cmask"]
    return (rel > tol).any(0).sum()


def count_unconverged(row: dict):
    """Move a read-back row's ``shake_unconverged`` into the tracer's
    ``shake.unconverged`` counter (a row without SHAKE has none)."""
    n = row.pop("shake_unconverged", None)
    if n is not None:
        trace.count("shake.unconverged", int(n))


# ---------- entry points: the kernel on CUDA planes, plain on CPU ----------

def _route(plane, name: str):
    if plane.is_cuda:
        from ..ops import shake as shake_ops

        return getattr(shake_ops, name)
    if plane.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {plane.device}")
    return globals()[f"{name}_plain"]


def shake_ref(t: dict, xs, inv, L) -> torch.Tensor:
    """(3, C, M) reference bond vectors of the positions ``xs``."""
    with trace.span("shake"):
        return _route(xs[0], "shake_ref")(t, xs, inv, L)


def shake_positions(t: dict, ro, xs, vs, inv, L, dt: float, iters: int,
                    virial_factor=None):
    """Move the positions onto the constraints along ``ro``; with ``vs``
    (None: positions only) v += (x_fix - x_new) / dt.  In place; returns
    the corrected (3, C, M) bond vectors rn, and with ``virial_factor``
    (1 / (dt dtf) under fix npt) the pair (rn, virial): the (6,) flt
    constraint virial sum_c ro_c (x) (-lam_c virial_factor ro_c) of the
    step (the JAX package's shake_positions_clustered :525-529)."""
    with trace.span("shake"):
        return _route(xs[0], "shake_positions")(t, ro, xs, vs, inv, L, dt,
                                                iters, virial_factor)


def rattle_velocities(t: dict, vs, inv, L, r=None, xs=None):
    """Project the velocities along the constraints out, in place; the
    bond vectors are ``r`` (SHAKE's rn), or computed from ``xs``."""
    with trace.span("shake"):
        _route(vs[0], "rattle_velocities")(t, vs, inv, L, r, xs)


def shake_virial(t: dict, xs, vs, fa, fb, inv, L, ftm2v: float,
                 acc_dtype) -> torch.Tensor:
    """(6,) constraint virial (xx, yy, zz, xy, xz, yz) in ``acc_dtype`` on
    the total force (flt)(fa + fb): ``fa`` the acc-typed pair + bonded
    planes, ``fb`` the k-space planes or None."""
    with trace.span("shake"):
        return _route(xs[0], "shake_virial")(t, xs, vs, fa, fb, inv, L,
                                             ftm2v, acc_dtype)


# ---------- an engine's set-up ----------

def shake_tables(sc: ShakeConstraints, device, flt) -> dict:
    """The constraint kernels' tables of ``sc`` on ``device``; a cluster
    wider than the kernels take raises."""
    cl = make_clusters(sc)
    if cl.width > MAX_C:
        raise NotImplementedError(
            f"fix shake: a cluster of {cl.width} constraints; the ROADMAP "
            f"queue 1 item 12 constraint kernels (K13) take clusters of at "
            f"most {MAX_C}")
    return cl.tables_on(device, flt)


def settle(t: dict, sc: ShakeConstraints, xs, vs, inv, L) -> torch.Tensor:
    """Put the positions on the constraints (x_old = x_new, dt = 1,
    velocities untouched), then project the velocities along the settled
    bond vectors, in place, as the JAX package does before the first
    force.  Returns the corrected bond vectors rn, which the first thermo
    row's ``unconverged`` reads."""
    ro = shake_ref(t, xs, inv, L)
    rn = shake_positions(t, ro, xs, None, inv, L, 1.0, sc.iters)
    rattle_velocities(t, vs, inv, L, xs=xs)
    return rn
