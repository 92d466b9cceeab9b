"""Real-space pair forces, energies and virial of the decks' pair styles.

Written from the LAMMPS documentation of each style, with the exact
erfc:

- ``buck/coul/long``: E = A exp(-r/rho) - C / r^6 inside ``cut``, plus
  qqrd2e q_i q_j erfc(g r) / r inside the Coulomb cutoff;
- ``buck/long/coul/long`` (with ``kspace_style pppm/disp``): the same but
  for the Ewald split of the r^-6 term, -C exp(-a^2) (1 + a^2 + a^4 / 2)
  / r^6 with a = g6 r inside ``cut`` (its reciprocal part is
  ``reference.ewald_disp``);
- ``lj/charmm/coul/long``: 4 eps [(s/r)^12 - (s/r)^6] (arithmetic mixing,
  eps_ij = sqrt(eps_i eps_j), s_ij = (s_i + s_j) / 2) times the CHARMM
  energy switch S(r) = (rc^2 - r^2)^2 (rc^2 + 2 r^2 - 3 ri^2) /
  (rc^2 - ri^2)^3 between ``inner`` and ``cut``, plus the same Coulomb.

A special pair (1-2, 1-3, 1-4 through the bonds) weighs the Van der Waals
term by its factor and keeps qqrd2e q_i q_j (erfc(g r) - (1 - f)) / r,
since the k-space sum holds every pair; for the same reason a special
buck/long pair weighs its exp(-r/rho) term by f and adds (1 - f) C / r^6
to the split r^-6 term.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import neighbors

_SPECIAL_SETS = {"charmm": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
                 "amber": ((0.0, 0.0, 0.5), (0.0, 0.0, 5.0 / 6.0))}


class PairStyle:
    """The per-type-pair coefficients of a deck's pair style."""

    def __init__(self, deck: dict, ntypes: int, qqrd2e: float,
                 g_ewald: float, g6: float = 0.0):
        ps = deck["pair_style"]
        self.name = ps["name"]
        self.qqrd2e, self.g, self.g6 = qqrd2e, g_ewald, g6
        self.cut = float(ps["cut"])
        self.cut_coul = float(ps.get("cut_coul", ps["cut"]))
        self.rc = max(self.cut, self.cut_coul)
        T = ntypes
        co = {tuple(int(s) - 1 for s in k.split()): v
              for k, v in ps["coeffs"].items()}
        if self.name in ("buck/coul/long", "buck/long/coul/long"):
            self.kind = "buck" if self.name == "buck/coul/long" else \
                "buck_long"
            self.A, self.rho, self.C = (np.zeros((T, T)) for _ in range(3))
            self.rho[:] = 1.0
            for (i, j), (a, r, c) in co.items():
                for p, q in ((i, j), (j, i)):
                    self.A[p, q], self.rho[p, q], self.C[p, q] = a, r, c
        elif self.name == "lj/charmm/coul/long":
            self.kind = "charmm"
            eps, sig = np.zeros(T), np.zeros(T)
            self.eps14, self.sig14 = np.zeros(T), np.zeros(T)
            for (i, _), c in co.items():
                eps[i], sig[i] = c[0], c[1]
                self.eps14[i] = c[2] if len(c) > 2 else c[0]
                self.sig14[i] = c[3] if len(c) > 3 else c[1]
            self.eps = np.sqrt(eps[:, None] * eps[None, :])
            self.sig = 0.5 * (sig[:, None] + sig[None, :])
            self.inner = float(ps["inner"])
        else:
            raise NotImplementedError(f"pair style {self.name}")
        sb = deck.get("special_bonds")
        if sb is None:
            self.special = None
        elif isinstance(sb, str):
            self.special = _SPECIAL_SETS[sb]
        else:
            raise NotImplementedError(f"special_bonds {sb!r}")


def special_keys(bonds, n0: int, nrep: int, device) -> torch.Tensor:
    """Sorted keys of the pairs within three bonds of each other:
    (min(i, j) * N + max(i, j)) * 4 + the shortest path (1 = 1-2, 2 = 1-3,
    3 = 1-4), N = n0 * nrep.  bonds: (type, i, j) rows of one copy of n0
    atoms; the copies of a replicated box repeat them."""
    nb = [set() for _ in range(n0)]
    for _, i, j in bonds:
        nb[i].add(j)
        nb[j].add(i)
    ii, jj, lv = [], [], []
    for a in range(n0):
        seen = {a: 0}
        front = [a]
        for lev in (1, 2, 3):
            nxt = []
            for u in front:
                for w in nb[u]:
                    if w not in seen:
                        seen[w] = lev
                        nxt.append(w)
            front = nxt
        for w, lev in seen.items():
            if w > a:
                ii.append(a)
                jj.append(w)
                lv.append(lev)
    ii, jj, lv = (np.asarray(v, np.int64) for v in (ii, jj, lv))
    N = n0 * nrep
    off = (np.arange(nrep, dtype=np.int64) * n0)[:, None]
    keys = (((ii + off) * N + (jj + off)) * 4 + lv).ravel()
    return torch.as_tensor(np.sort(keys), device=device)


def _special_factors(style: PairStyle, i, j, n: int, keys, dtype):
    """(f_lj, f_coul) per pair: 1, or the special factor of its level."""
    one = torch.ones(len(i), dtype=dtype, device=i.device)
    if keys is None or not len(keys):
        return one, one
    k = torch.minimum(i, j) * n + torch.maximum(i, j)
    pos = torch.clamp(torch.searchsorted(keys // 4, k), max=len(keys) - 1)
    hit = (keys[pos] // 4) == k
    lev = (keys[pos] % 4).clamp(min=1) - 1
    flj = torch.tensor(style.special[0], dtype=dtype, device=i.device)[lev]
    fco = torch.tensor(style.special[1], dtype=dtype, device=i.device)[lev]
    return torch.where(hit, flj, one), torch.where(hit, fco, one)


def compute(style: PairStyle, x: torch.Tensor, typ: torch.Tensor,
            q: torch.Tensor, L, special_keys=None, peratom: bool = False):
    """(forces (N, 3), evdwl, ecoul, virial (3, 3)) in x's dtype, the
    energies and virial summed in f64 unless x is of lower precision; with
    ``peratom`` also each atom's energy (N,) and virial (N, 6: xx, yy, zz,
    xy, xz, yz), half of each pair's to each of its atoms."""
    dt, dev, n = x.dtype, x.device, len(x)
    acc = torch.float64 if dt == torch.float64 else dt
    f = torch.zeros_like(x)
    evdwl = torch.zeros((), dtype=acc, device=dev)
    ecoul = torch.zeros((), dtype=acc, device=dev)
    vir = torch.zeros((3, 3), dtype=acc, device=dev)
    eatom = torch.zeros(n, dtype=dt, device=dev)
    vatom = torch.zeros((n, 6), dtype=dt, device=dev)
    tab = {k: torch.as_tensor(getattr(style, k), dtype=dt, device=dev)
           for k in ("A", "rho", "C", "eps", "sig")
           if hasattr(style, k)}
    g, qqrd2e = style.g, style.qqrd2e
    ewald_f = 2.0 / math.sqrt(math.pi)
    for i, j, d in neighbors.pairs(x, L, style.rc):
        rsq = (d * d).sum(-1)
        r = torch.sqrt(rsq)
        r2inv = 1.0 / rsq
        r6inv = r2inv * r2inv * r2inv
        ti, tj = typ[i], typ[j]
        flj, fco = _special_factors(style, i, j, n, special_keys, dt)
        if style.kind == "buck":
            A, rho, C = (tab[k][ti, tj] for k in ("A", "rho", "C"))
            rexp = torch.exp(-r / rho)
            fv = (A / rho * r * rexp - 6.0 * C * r6inv) * flj
            ev = (A * rexp - C * r6inv) * flj
        elif style.kind == "buck_long":
            A, rho, C = (tab[k][ti, tj] for k in ("A", "rho", "C"))
            rexp = torch.exp(-r / rho)
            a2 = style.g6 ** 2 * rsq
            ea = torch.exp(-a2)
            kept = (1.0 + a2 + 0.5 * a2 * a2) * ea
            kept_f = kept + a2 * a2 * a2 / 6.0 * ea
            fv = flj * A / rho * r * rexp \
                - 6.0 * C * r6inv * (kept_f - (1.0 - flj))
            ev = flj * A * rexp - C * r6inv * (kept - (1.0 - flj))
        else:
            eps, sig = tab["eps"][ti, tj], tab["sig"][ti, tj]
            s6 = sig ** 6
            forcelj = 24.0 * eps * s6 * (2.0 * s6 * r6inv - 1.0) * r6inv
            philj = 4.0 * eps * s6 * (s6 * r6inv - 1.0) * r6inv
            rc2, ri2 = style.cut ** 2, style.inner ** 2
            denom = (rc2 - ri2) ** 3
            tt = rc2 - rsq
            sw1 = tt * tt * (rc2 + 2.0 * rsq - 3.0 * ri2) / denom
            sw2 = 12.0 * rsq * tt * (rsq - ri2) / denom
            sw = rsq > ri2
            fv = torch.where(sw, forcelj * sw1 + philj * sw2, forcelj) * flj
            ev = torch.where(sw, philj * sw1, philj) * flj
        inlj = rsq < style.cut ** 2
        fv = torch.where(inlj, fv, torch.zeros_like(fv))
        ev = torch.where(inlj, ev, torch.zeros_like(ev))
        qq = qqrd2e * q[i] * q[j]
        erfc = torch.special.erfc(g * r)
        ec = qq / r * (erfc - (1.0 - fco))
        fc = qq / r * (erfc + ewald_f * g * r * torch.exp(-g * g * rsq)
                       - (1.0 - fco))
        inc = rsq < style.cut_coul ** 2
        ec = torch.where(inc, ec, torch.zeros_like(ec))
        fc = torch.where(inc, fc, torch.zeros_like(fc))
        fpair = (fv + fc) * r2inv
        fij = fpair[:, None] * d
        f.index_add_(0, i, fij)
        f.index_add_(0, j, -fij)
        evdwl = evdwl + ev.to(acc).sum()
        ecoul = ecoul + ec.to(acc).sum()
        vir = vir + (d[:, :, None] * fij[:, None, :]).to(acc).sum(0)
        if peratom:
            eh = 0.5 * (ev + ec)
            eatom.index_add_(0, i, eh)
            eatom.index_add_(0, j, eh)
            vh = 0.5 * torch.stack([d[:, a] * fij[:, b] for a, b in (
                (0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))], -1)
            vatom.index_add_(0, i, vh)
            vatom.index_add_(0, j, vh)
    if peratom:
        return f, evdwl, ecoul, vir, eatom, vatom
    return f, evdwl, ecoul, vir
