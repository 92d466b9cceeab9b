"""Bonded energies of the CHARMM decks, with forces by autograd.

Written from the LAMMPS documentation of each style (angles in degrees
in the deck, radians here):

- ``bond_style harmonic``: K (r - r0)^2;
- ``angle_style charmm``: K (theta - theta0)^2 + K_ub (r_13 - r_ub)^2;
- ``dihedral_style charmm``: K [1 + cos(n phi - d)], d = 0 or 180, and
  with weight w the 1-4 pair w {4 eps14 [(s14/r)^12 - (s14/r)^6]
  + qqrd2e q_1 q_4 / r} (eps14 = sqrt(eps14_i eps14_j),
  s14 = (s14_i + s14_j) / 2);
- ``improper_style harmonic``: K (chi - chi0)^2, chi the angle between
  the planes (1, 2, 3) and (2, 3, 4), 180 degrees for a trans chain.

The dihedral angle is LAMMPS' (dihedral_charmm.cpp, improper_harmonic.cpp):
a planar trans chain 1-2-3-4 has phi = 180 degrees, a cis chain 0.

Bonds of the types ``fix shake`` constrains are left out.  Each term
reads the minimum-image bond vectors; the forces are minus the gradient
of the total energy with respect to the positions.
"""
from __future__ import annotations

import numpy as np
import torch

from .neighbors import minimg


def _vec(x, L, a, b):
    return minimg(x[a] - x[b], L)


def _dot(a, b):
    return (a * b).sum(-1)


def _torsion(b1, b2, b3):
    """The dihedral angle of LAMMPS' dihedral and improper styles, 180
    degrees for a planar trans chain (b1 = x1 - x2, b2 = x3 - x2,
    b3 = x4 - x3): with a = b1 x (-b2) and b = b3 x (-b2), cos = a.b and
    sin = |b2| a.b3 over |a| |b|."""
    a = torch.linalg.cross(b1, -b2)
    b = torch.linalg.cross(b3, -b2)
    s = torch.linalg.norm(b2, dim=-1) * _dot(a, b3)
    return torch.atan2(s, _dot(a, b))


def energies(deck: dict, d: dict, x: torch.Tensor, L, pair_style,
             shaken_types=()):
    """(ebond + eangle + edihed + eimp, e14 (lj + coul)) as 0-d tensors
    differentiable in x."""
    dev, dt = x.device, x.dtype
    Lt = torch.as_tensor(np.asarray(L, np.float64), dtype=dt, device=dev)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype or dt, device=dev)

    e = torch.zeros((), dtype=dt, device=dev)
    b = d["bonds"]
    b = b[~np.isin(b[:, 0], np.asarray(shaken_types, np.int64))]
    if len(b):
        c = np.asarray(deck["bond_style"]["coeffs"], np.float64)[b[:, 0]]
        r = torch.linalg.norm(_vec(x, Lt, t(b[:, 1], torch.long),
                                   t(b[:, 2], torch.long)), dim=-1)
        e = e + (t(c[:, 0]) * (r - t(c[:, 1])) ** 2).sum()
    a = d["angles"]
    if len(a):
        c = np.asarray(deck["angle_style"]["coeffs"], np.float64)[a[:, 0]]
        i, j, k = (t(a[:, m], torch.long) for m in (1, 2, 3))
        r1, r2 = _vec(x, Lt, i, j), _vec(x, Lt, k, j)
        th = torch.atan2(torch.linalg.norm(torch.linalg.cross(r1, r2),
                                           dim=-1), _dot(r1, r2))
        e = e + (t(c[:, 0]) * (th - t(np.radians(c[:, 1]))) ** 2).sum()
        if deck["angle_style"]["name"] == "charmm":
            r13 = torch.linalg.norm(_vec(x, Lt, i, k), dim=-1)
            e = e + (t(c[:, 2]) * (r13 - t(c[:, 3])) ** 2).sum()
    e14 = torch.zeros((), dtype=dt, device=dev)
    dh = d["dihedrals"]
    if len(dh):
        c = np.asarray(deck["dihedral_style"]["coeffs"], np.float64)[dh[:, 0]]
        i1, i2, i3, i4 = (t(dh[:, m], torch.long) for m in (1, 2, 3, 4))
        b1, b2, b3 = (_vec(x, Lt, i1, i2), _vec(x, Lt, i3, i2),
                      _vec(x, Lt, i4, i3))
        phi = _torsion(b1, b2, b3)
        e = e + (t(c[:, 0]) * (1.0 + torch.cos(t(c[:, 1]) * phi)
                               * t(np.cos(np.radians(c[:, 2]))))).sum()
        w = c[:, 3]
        on = w > 0
        if on.any():
            ty = d["typ"]
            ti, tl = ty[dh[on, 1]], ty[dh[on, 4]]
            eps = np.sqrt(pair_style.eps14[ti] * pair_style.eps14[tl])
            sig = 0.5 * (pair_style.sig14[ti] + pair_style.sig14[tl])
            r14 = torch.linalg.norm(_vec(x, Lt, i1[t(on, torch.bool)],
                                         i4[t(on, torch.bool)]), dim=-1)
            sr6 = (t(sig) / r14) ** 6
            qq = pair_style.qqrd2e * d["q"][dh[on, 1]] * d["q"][dh[on, 4]]
            e14 = (t(w[on]) * (4.0 * t(eps) * (sr6 * sr6 - sr6)
                               + t(qq) / r14)).sum()
    im = d["impropers"]
    if len(im):
        c = np.asarray(deck["improper_style"]["coeffs"],
                       np.float64)[im[:, 0]]
        i1, i2, i3, i4 = (t(im[:, m], torch.long) for m in (1, 2, 3, 4))
        b1, b2, b3 = (_vec(x, Lt, i1, i2), _vec(x, Lt, i3, i2),
                      _vec(x, Lt, i4, i3))
        chi = _torsion(b1, b2, b3).abs()
        e = e + (t(c[:, 0]) * (chi - t(np.radians(c[:, 1]))) ** 2).sum()
    return e, e14


def compute(deck: dict, d: dict, x: torch.Tensor, L, pair_style,
            shaken_types=()):
    """(forces (N, 3), emol, e14) at positions x."""
    with torch.enable_grad():
        xg = x.detach().clone().requires_grad_(True)
        e, e14 = energies(deck, d, xg, L, pair_style, shaken_types)
        (g,) = torch.autograd.grad(e + e14, xg)
    return -g.detach(), e.detach(), e14.detach()

