"""Bonded interactions of a molecular deck: harmonic bonds, harmonic and
CHARMM angles (with Urey-Bradley), then the CHARMM dihedrals and harmonic
impropers of ``charmm.py``.

Counterpart of ``lammps_buck_intel_tpu.models.bonded.harmonic``:
  E_bond  = K (r - r0)^2
  E_angle = K (theta - theta0)^2  (+ K_ub (r13 - r_ub)^2, angle charmm)

The engine keeps positions as slot planes, so ``compute_bonded`` takes the
three planes and the slot-of-atom map ``inv`` (rebuilt after each rebin)
where the JAX package takes an (N, 3) array and per-class slot-index
overrides; the term tables stay in atom indices.  Without ``eflag`` the
energies AND the virial are zeros (the kernels reduce both or neither).  On CUDA planes it
launches the kernels of csrc/bonded.cu through ``ops.bonded``; on CPU
planes it runs ``compute_bonded_plain``, the same arithmetic in torch ops.
Forces are ADDED to ``out`` (acc-typed planes) when given.  The per-term
energy/virial weights of the multi-device engine (``eweights``) are not
ported (ROADMAP queue 1 item 16).

``compute_bonded_peratom`` (compute pe/atom and stress/atom) splits each
term's energy and 6-virial evenly among its atoms and keeps the CHARMM
1-4 pair terms apart; CUDA planes launch csrc/bonded.cu's
``bonded_peratom`` (K18b), CPU planes run ``compute_bonded_peratom_plain``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...core.box import Box


@dataclasses.dataclass
class BondedStyle:
    """Static topology + host-numpy coefficients.

    bonds:  (Nb, 3) int32 [type, i, j]
    angles: (Na, 4) int32 [type, i, j, k]  (j = central atom)
    bond_coeffs:  (Tb, 2) [K, r0]
    angle_coeffs: (Ta, 2) [K, theta0_degrees], or (Ta, 4)
                  [K, theta0, K_ub, r_ub] when angle_style == "charmm"
    dihedrals/impropers: (Nd, 5) int32 [type, i, j, k, l]
    dihedral_coeffs: (Td, 4) [K, n, d_degrees, weight] (charmm)
    improper_coeffs: (Ti, 2) [K, chi0_degrees] (harmonic), or (Ti, 3) with
                     the JAX package's arccos clip (charmm.improper_energy)
    d14: (Nd, 3) [a12, a6, qq] baked per-dihedral 1-4 pair coefficients
         (see charmm.bake_charmm_14); zero-length => no 1-4 terms
    """

    bonds: np.ndarray
    angles: np.ndarray
    bond_coeffs: np.ndarray
    angle_coeffs: np.ndarray
    angle_style: str = "harmonic"
    dihedrals: np.ndarray = None
    impropers: np.ndarray = None
    dihedral_coeffs: np.ndarray = None
    improper_coeffs: np.ndarray = None
    d14: np.ndarray = None
    # (device, dtype) -> the tables as tensors, copied to a device once
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def has_terms(self) -> bool:
        return (len(self.bonds) > 0 or len(self.angles) > 0
                or len(self.dihedrals) > 0 or len(self.impropers) > 0)

    def tables_on(self, device, flt) -> dict:
        """Term tables (int32) and per-type coefficients (``flt``) on
        ``device``, in the layout the kernels read: angle_coef (Ta, 4)
        [K, theta0 rad, K_ub, r_ub], dihedral_coef (Td, 2) [K, cos d],
        dihedral_mult (Td,) int32, improper_coef (Ti, 3) [K, chi0 rad,
        clip (0: none)],
        d14 (Nd, 3) or None.  Angles are converted in f64 and rounded
        once, as the JAX package does."""
        key = (torch.device(device), flt)
        t = self._on_device.get(key)
        if t is not None:
            return t

        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32)).to(
                device)

        def real(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
                device, flt)

        ac = np.zeros((len(self.angle_coeffs), 4))
        ac[:, :self.angle_coeffs.shape[1]] = self.angle_coeffs[:, :4]
        ac[:, 1] = np.deg2rad(ac[:, 1])
        if self.angle_style != "charmm":
            ac[:, 2:] = 0.0
        dc, ic = self.dihedral_coeffs, self.improper_coeffs
        t = dict(
            bonds=ints(self.bonds), angles=ints(self.angles),
            dihedrals=ints(self.dihedrals), impropers=ints(self.impropers),
            bond_coef=real(self.bond_coeffs), angle_coef=real(ac),
            dihedral_coef=real(np.stack(
                [dc[:, 0], np.cos(np.deg2rad(dc[:, 2]))], -1)),
            dihedral_mult=ints(dc[:, 1]),
            improper_coef=real(np.stack(
                [ic[:, 0], np.deg2rad(ic[:, 1]),
                 ic[:, 2] if ic.shape[1] > 2 else np.zeros(len(ic))], -1)),
            d14=real(self.d14) if len(self.d14) else None,
        )
        self._on_device[key] = t
        return t


def make_bonded(bonds=None, angles=None, bond_coeffs=None, angle_coeffs=None,
                angle_style="harmonic", dihedrals=None, impropers=None,
                dihedral_coeffs=None, improper_coeffs=None, d14=None):
    def arr(a, cols, dt=np.int32):
        return (np.zeros((0, cols), dt) if a is None
                else np.asarray(a, dt))

    return BondedStyle(
        bonds=arr(bonds, 3), angles=arr(angles, 4),
        bond_coeffs=arr(bond_coeffs, 2, np.float64),
        angle_coeffs=arr(angle_coeffs, 4 if angle_style == "charmm" else 2,
                         np.float64),
        angle_style=angle_style, dihedrals=arr(dihedrals, 5),
        impropers=arr(impropers, 5),
        dihedral_coeffs=arr(dihedral_coeffs, 4, np.float64),
        improper_coeffs=arr(improper_coeffs, 2, np.float64),
        d14=arr(d14, 3, np.float64))


class BondedResult(NamedTuple):
    fx: torch.Tensor      # (M,) acc force planes (slot or atom order)
    fy: torch.Tensor
    fz: torch.Tensor
    ebond: torch.Tensor
    eangle: torch.Tensor
    virial: torch.Tensor  # (6,)
    edihed: torch.Tensor
    eimp: torch.Tensor
    e14_lj: torch.Tensor    # dihedral 1-4 LJ  (tallied to evdwl)
    e14_coul: torch.Tensor  # dihedral 1-4 Coulomb (-> ecoul)

    @property
    def emol(self):
        """Total bonded (molecular) energy: bond+angle+dihedral+improper.
        The 1-4 pair terms are PAIR energies (LAMMPS tallies them into
        E_vdwl/E_coul) and are excluded here."""
        return self.ebond + self.eangle + self.edihed + self.eimp


def minimg(d: torch.Tensor, L) -> torch.Tensor:
    """Per-axis minimum image of (M, 3) differences: d - round(d / L) L
    (half to even), the reciprocal taken in f64 for host lengths, in the
    dtype of a (3,) tensor of lengths (the variable cell)."""
    from ...core.box import minimum_image_planes

    return torch.stack(minimum_image_planes(d[:, 0], d[:, 1], d[:, 2], L),
                       -1)


def slots_of(table: torch.Tensor, inv: Optional[torch.Tensor]):
    """Slot indices (Nterm, k) int64 of a term table's atom columns."""
    atoms = table[:, 1:].long()
    return atoms if inv is None else inv.long()[atoms]


def add_forces(out, idx: torch.Tensor, f: torch.Tensor):
    """out[axis][idx] += f[:, axis] for the three acc planes."""
    for ax in range(3):
        out[ax].index_add_(0, idx, f[:, ax].to(out[ax].dtype))


def virial6(acc, *pairs) -> torch.Tensor:
    """sum over terms of sum_k a_k (x) b_k as (xx, yy, zz, xy, xz, yz),
    each term rounded to acc once."""
    return torch.stack([
        sum(a[:, i] * b[:, j] for a, b in pairs).to(acc).sum()
        for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])


def compute_bonded_plain(style: BondedStyle, xs, box: Box, *, eflag=True,
                         acc_dtype=torch.float32, inv=None,
                         out=None) -> BondedResult:
    """Plain torch version of ``compute_bonded`` (any device)."""
    from .charmm import dihedral_charmm_forces, improper_harmonic_forces

    flt, dev = xs[0].dtype, xs[0].device
    x = torch.stack(tuple(xs), -1)
    L = (box if isinstance(box, torch.Tensor)
         else [float(v) for v in np.asarray(box.lengths)])
    t = style.tables_on(dev, flt)
    if out is None:
        out = tuple(torch.zeros(x.shape[0], dtype=acc_dtype, device=dev)
                    for _ in range(3))
    zero = torch.zeros((), dtype=acc_dtype, device=dev)
    ebond = eangle = zero
    virial = torch.zeros(6, dtype=acc_dtype, device=dev)

    if len(style.bonds):
        idx = slots_of(t["bonds"], inv)
        bt = t["bonds"][:, 0].long()
        K, r0 = t["bond_coef"][bt, 0], t["bond_coef"][bt, 1]
        d = minimg(x[idx[:, 0]] - x[idx[:, 1]], L)
        r = torch.sqrt((d * d).sum(1))
        dr = r - r0
        rk = K * dr
        fbond = torch.where(r > 0, -2.0 * rk / r, torch.zeros_like(r))
        fv = fbond[:, None] * d
        add_forces(out, idx[:, 0], fv)
        add_forces(out, idx[:, 1], -fv)
        if eflag:
            ebond = (rk * dr).to(acc_dtype).sum()
            virial = virial + virial6(acc_dtype, (fbond[:, None] * d, d))

    if len(style.angles):
        idx = slots_of(t["angles"], inv)
        at = t["angles"][:, 0].long()
        K, th0 = t["angle_coef"][at, 0], t["angle_coef"][at, 1]
        d1 = minimg(x[idx[:, 0]] - x[idx[:, 1]], L)
        d2 = minimg(x[idx[:, 2]] - x[idx[:, 1]], L)
        r1sq, r2sq = (d1 * d1).sum(1), (d2 * d2).sum(1)
        r1, r2 = torch.sqrt(r1sq), torch.sqrt(r2sq)
        c = torch.clamp((d1 * d2).sum(1) / (r1 * r2), -1.0, 1.0)
        s = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-8))
        dtheta = torch.acos(c) - th0
        tk = K * dtheta
        a = -2.0 * tk / s
        a11, a12, a22 = a * c / r1sq, -a / (r1 * r2), a * c / r2sq
        f1 = a11[:, None] * d1 + a12[:, None] * d2
        f3 = a22[:, None] * d2 + a12[:, None] * d1
        add_forces(out, idx[:, 0], f1)
        add_forces(out, idx[:, 2], f3)
        add_forces(out, idx[:, 1], -(f1 + f3))
        if eflag:
            eangle = (tk * dtheta).to(acc_dtype).sum()
            virial = virial + virial6(acc_dtype, (d1, f1), (d2, f3))

        kub, rub = t["angle_coef"][at, 2], t["angle_coef"][at, 3]
        if bool((kub != 0).any()):
            # Urey-Bradley 1-3 harmonic term of angle charmm
            d = minimg(x[idx[:, 0]] - x[idx[:, 2]], L)
            r = torch.sqrt(torch.clamp((d * d).sum(1), min=1e-12))
            dr = r - rub
            rk = kub * dr
            fub = -2.0 * rk / r
            fv = fub[:, None] * d
            add_forces(out, idx[:, 0], fv)
            add_forces(out, idx[:, 2], -fv)
            if eflag:
                eangle = eangle + (rk * dr).to(acc_dtype).sum()
                virial = virial + virial6(acc_dtype, (fub[:, None] * d, d))

    edihed = eimp = e14_lj = e14_coul = zero
    if len(style.dihedrals):
        terms = dihedral_charmm_forces(
            x, L, t["dihedrals"], t["dihedral_coef"], t["dihedral_mult"],
            t["d14"], slots_of(t["dihedrals"], inv), out, acc_dtype)
        if eflag:
            edihed, e14_lj, e14_coul = terms[:3]
            virial = virial + terms[3]
    if len(style.impropers):
        terms = improper_harmonic_forces(
            x, L, t["impropers"], t["improper_coef"],
            slots_of(t["impropers"], inv), out, acc_dtype)
        if eflag:
            eimp, virial = terms[0], virial + terms[1]
    return BondedResult(fx=out[0], fy=out[1], fz=out[2], ebond=ebond,
                        eangle=eangle, virial=virial, edihed=edihed,
                        eimp=eimp, e14_lj=e14_lj, e14_coul=e14_coul)


def compute_bonded(style: BondedStyle, xs, box: Box, *, eflag=True,
                   acc_dtype=torch.float32, inv=None,
                   out=None) -> BondedResult:
    """Bonded forces, energies and virial.

    xs: the (x, y, z) position planes, (M,) each, slot or atom order.
    box: a host ``Box``, or a (3,) tensor of box lengths on the planes'
      device (the NPT engine's variable cell, read by the kernels there).
    inv: (N + 1,) int32 slot of each atom, or None when the planes are in
      atom order.
    out: three acc-typed (M,) planes the forces are added to (in place);
      zeros when None.
    CUDA planes launch the kernels; CPU planes run the plain version."""
    if xs[0].is_cuda:
        from ...ops import bonded as bonded_ops

        return bonded_ops.compute_bonded(style, xs, box, eflag=eflag,
                                         acc_dtype=acc_dtype, inv=inv,
                                         out=out)
    if xs[0].device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {xs[0].device}")
    return compute_bonded_plain(style, xs, box, eflag=eflag,
                                acc_dtype=acc_dtype, inv=inv, out=out)


BONDED_KINDS = ("bond", "angle", "dihedral", "improper")


def _virial6_terms(acc, *pairs) -> torch.Tensor:
    """Per-term (M, 6) virial sum over pairs of a_k (x) b_k, each component
    rounded to acc once."""
    return torch.stack([
        sum(a[:, i] * b[:, j] for a, b in pairs)
        for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))],
        -1).to(acc)


def compute_bonded_peratom_plain(style: BondedStyle, xs, box: Box, *,
                                 acc_dtype=torch.float64,
                                 include=BONDED_KINDS):
    """Plain torch version of ``compute_bonded_peratom`` (any device), the
    JAX ``compute_bonded_peratom`` with the dihedral and improper virials
    from the written-out gradients of ``charmm.py`` (the JAX package takes
    them from jax.grad of the same energies)."""
    from .charmm import (_bond_vectors, dihedral_energy_terms,
                         improper_energy, phi_gradient)

    acc, flt, dev = acc_dtype, xs[0].dtype, xs[0].device
    x = torch.stack(tuple(xs), -1)
    n = x.shape[0]
    L = (box if isinstance(box, torch.Tensor)
         else [float(v) for v in np.asarray(box.lengths)])
    t = style.tables_on(dev, flt)
    eatom = torch.zeros(n, dtype=acc, device=dev)
    vatom = torch.zeros((n, 6), dtype=acc, device=dev)
    e14 = torch.zeros(n, dtype=acc, device=dev)
    v14 = torch.zeros((n, 6), dtype=acc, device=dev)

    def share(ea, va, e_t, v_t, idx):
        m = float(idx.shape[1])
        for col in range(idx.shape[1]):
            ea.index_add_(0, idx[:, col], e_t.to(acc) / m)
            va.index_add_(0, idx[:, col], v_t / m)

    if "bond" in include and len(style.bonds):
        idx = t["bonds"][:, 1:].long()
        bt = t["bonds"][:, 0].long()
        K, r0 = t["bond_coef"][bt, 0], t["bond_coef"][bt, 1]
        d = minimg(x[idx[:, 0]] - x[idx[:, 1]], L)
        r = torch.sqrt((d * d).sum(1))
        dr = r - r0
        rk = K * dr
        fbond = torch.where(r > 0, -2.0 * rk / r, torch.zeros_like(r))
        share(eatom, vatom, rk * dr,
              _virial6_terms(acc, (fbond[:, None] * d, d)), idx)

    if "angle" in include and len(style.angles):
        idx = t["angles"][:, 1:].long()
        at = t["angles"][:, 0].long()
        K, th0 = t["angle_coef"][at, 0], t["angle_coef"][at, 1]
        d1 = minimg(x[idx[:, 0]] - x[idx[:, 1]], L)
        d2 = minimg(x[idx[:, 2]] - x[idx[:, 1]], L)
        r1sq, r2sq = (d1 * d1).sum(1), (d2 * d2).sum(1)
        r1, r2 = torch.sqrt(r1sq), torch.sqrt(r2sq)
        c = torch.clamp((d1 * d2).sum(1) / (r1 * r2), -1.0, 1.0)
        s = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-8))
        dtheta = torch.acos(c) - th0
        tk = K * dtheta
        a = -2.0 * tk / s
        a11, a12, a22 = a * c / r1sq, -a / (r1 * r2), a * c / r2sq
        f1 = a11[:, None] * d1 + a12[:, None] * d2
        f3 = a22[:, None] * d2 + a12[:, None] * d1
        share(eatom, vatom, tk * dtheta,
              _virial6_terms(acc, (d1, f1), (d2, f3)), idx)
        kub, rub = t["angle_coef"][at, 2], t["angle_coef"][at, 3]
        if bool((kub != 0).any()):
            # the Urey-Bradley 1-3 term, shared by the outer atoms
            d = minimg(x[idx[:, 0]] - x[idx[:, 2]], L)
            r = torch.sqrt(torch.clamp((d * d).sum(1), min=1e-12))
            dr = r - rub
            rk = kub * dr
            fub = -2.0 * rk / r
            share(eatom, vatom, rk * dr,
                  _virial6_terms(acc, (fub[:, None] * d, d)),
                  idx[:, [0, 2]])

    def grad_virial(b, g):
        # -sum_k b_k (x) g_k, in the JAX package's order of terms
        return torch.stack([
            -b[0][:, i] * g[0][:, j] - b[1][:, i] * g[1][:, j]
            - b[2][:, i] * g[2][:, j]
            for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))],
            -1).to(acc)

    if "dihedral" in include and len(style.dihedrals):
        idx = t["dihedrals"][:, 1:].long()
        dt = t["dihedrals"][:, 0].long()
        coef, mult = t["dihedral_coef"], t["dihedral_mult"]
        K, d_cos, n_i = coef[dt, 0], coef[dt, 1], mult[dt]
        zero = torch.zeros_like(K)
        b = _bond_vectors(x, L, idx)
        ed, _, _, sin_n = dihedral_energy_terms(*b, K, n_i, d_cos, zero,
                                                zero, zero)
        g = phi_gradient(-K * n_i.to(K.dtype) * sin_n * d_cos, *b)
        share(eatom, vatom, ed, grad_virial(b, g), idx)
        if t["d14"] is not None:
            # the 1-4 pair terms: the pair-style tally (halves on atoms 1
            # and 4), kept apart for the pair channel
            a12, a6, qq = t["d14"][:, 0], t["d14"][:, 1], t["d14"][:, 2]
            r14 = b[0] - b[1] - b[2]
            rsq = torch.clamp((r14 * r14).sum(-1), min=1e-12)
            r6inv = 1.0 / (rsq * rsq * rsq)
            elj = r6inv * (a12 * r6inv - a6)
            ec = qq / torch.sqrt(rsq)
            fpair = (r6inv * (12.0 * a12 * r6inv - 6.0 * a6) + ec) / rsq
            share(e14, v14, elj + ec,
                  _virial6_terms(acc, (fpair[:, None] * r14, r14)),
                  idx[:, [0, 3]])

    if "improper" in include and len(style.impropers):
        idx = t["impropers"][:, 1:].long()
        it = t["impropers"][:, 0].long()
        K, chi0, clip = (t["improper_coef"][it, k] for k in range(3))
        b = _bond_vectors(x, L, idx)
        e, dchi, side = improper_energy(*b, K, chi0, clip)
        share(eatom, vatom, e,
              grad_virial(b, phi_gradient(2.0 * K * dchi * side, *b)), idx)
    return eatom, vatom, e14, v14


def compute_bonded_peratom(style: BondedStyle, xs, box: Box, *,
                           acc_dtype=torch.float64, include=BONDED_KINDS):
    """Per-atom bonded energy and virial (the ev_tally2/3/4 equal-division
    convention: each term's energy and virial split evenly among its
    atoms, so the sums equal ``compute_bonded``'s).  xs: the (x, y, z)
    planes in atom order; box: a host ``Box`` or a (3,) tensor of lengths;
    include: the kinds tallied.  Returns (eatom (N,), vatom (N, 6), e14
    (N,), v14 (N, 6)) in acc: the CHARMM 1-4 pair terms (halves on atoms 1
    and 4, with the dihedrals) apart, for the pair channel.  CUDA planes
    launch K18b, CPU planes run ``compute_bonded_peratom_plain``."""
    bad = set(include) - set(BONDED_KINDS)
    if bad:
        raise ValueError(f"unknown bonded kinds {sorted(bad)}")
    if xs[0].is_cuda:
        from ...ops import bonded as bonded_ops

        return bonded_ops.compute_bonded_peratom(style, xs, box,
                                                 acc_dtype=acc_dtype,
                                                 include=include)
    if xs[0].device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {xs[0].device}")
    return compute_bonded_peratom_plain(style, xs, box, acc_dtype=acc_dtype,
                                        include=include)
