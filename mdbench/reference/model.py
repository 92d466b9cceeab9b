"""The reference's forces, energies, virial and one velocity-Verlet step
of a deck, in any dtype, from the deck and positions alone.

The pair style, the k-space splitting, the topology and the constraints
are worked out here from the deck's files (``reference.system``);
nothing is taken from the program under test.  The k-space styles:
``pppm`` (ik) with ``buck/coul/long`` or ``lj/charmm/coul/long``, and
``pppm/disp`` (ik, ``mix none``) with ``buck/long/coul/long``; ``ewald``,
``diff ad``, ``kspace_modify slab``, the other pppm/disp mixes and rigid
bodies are refused by name.  The splittings g_ewald and g6 are set once,
in the deck's box, as LAMMPS sets them in ``init``; ``in_box`` gives the
same physics in the box a barostat has moved to.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import bonded, ewald, ewald_disp, pair, system

_VOIGT = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


class Reference:
    """A deck's physics on ``device`` in ``dtype``."""

    def __init__(self, deck: dict, d: dict, device, dtype=torch.float64):
        self.deck, self.d, self.dev, self.dt = deck, d, device, dtype
        self.units = d["units"]
        self.L = np.asarray(d["L"], np.float64)
        self.n = n = len(d["x"])
        self.timestep = float(deck["timestep"])
        ks, ps = deck.get("kspace_style"), deck["pair_style"]
        self.disp = _kspace(ks, ps)
        fixes = {fx["name"]: fx for fx in deck.get("fixes", [])}
        rigid = sorted(k for k in fixes if k.startswith("rigid"))
        if rigid:
            raise NotImplementedError(f"fix {rigid[0]} (rigid bodies)")
        self.accuracy = float(ks.get("accuracy", 1e-4))
        self.g = ewald.g_ewald(self.accuracy,
                               float(ps.get("cut_coul", ps["cut"])), d["q"],
                               float(np.prod(self.L)), self.units["qqrd2e"])
        self.g6 = (ewald_disp.g6(float(ks.get("force_disp_real", 1e-4)),
                                 float(ps["cut"])) if self.disp else 0.0)
        self.style = pair.PairStyle(deck, len(d["mass"]),
                                    self.units["qqrd2e"], self.g, self.g6)
        self.nve = set(fixes) == {"nve"}
        self.constraints, self.shaken, nc = None, (), 0
        self.Lt = torch.as_tensor(self.L, dtype=dtype, device=device)
        self.minv = self.tensor(1.0 / d["mass_atom"])
        self.mass = self.tensor(d["mass_atom"])
        if "shake" in fixes:
            b = system.shake_bonds(d, fixes["shake"]["m"])
            self.shaken = tuple(int(t) for t in np.unique(b[:, 0]))
            r0 = np.asarray(deck["bond_style"]["coeffs"], np.float64)[b[:, 0],
                                                                       1]
            self.constraints = (
                torch.as_tensor(b[:, 1], device=device),
                torch.as_tensor(b[:, 2], device=device), self.tensor(r0))
            nc = len(b)
        self.dof = max(3 * n - 3 - nc, 1)
        self.special = None
        if self.style.special is not None:
            base = d["base"]
            self.special = pair.special_keys(
                base["bonds"], len(base["x"]), n // len(base["x"]), device)
        self.typ = torch.as_tensor(d["typ"], device=device)
        self.q = self.tensor(d["q"])
        self.has_bonded = any(deck.get(k) for k in (
            "bond_style", "angle_style", "dihedral_style", "improper_style"))
        self._low = {}

    def tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dt, device=self.dev)

    def in_box(self, L):
        """The same reference in the box of lengths ``L`` (a box that fix
        npt moved), the splittings kept at their set-up values."""
        if L is None:
            return self
        r = copy.copy(self)
        r.L = np.asarray(L, np.float64)
        r.Lt = torch.as_tensor(r.L, dtype=self.dt, device=self.dev)
        r._low = {}
        return r

    def as_dtype(self, dt):
        """The same reference computing in ``dt``."""
        if dt == self.dt:
            return self
        if dt not in self._low:
            r = copy.copy(self)
            r.dt, r._low = dt, {}
            r.Lt, r.minv, r.mass, r.q = (t.to(dt) for t in (
                self.Lt, self.minv, self.mass, self.q))
            self._low[dt] = r
        return self._low[dt]

    def forces(self, x: torch.Tensor, peratom: bool = False) -> dict:
        """f (N, 3), evdwl, ecoul, elong, emol, e14, epot (their sum) and
        the virial trace at positions x (the bonded terms' virial left
        out); with ``peratom`` the pair and k-space per-atom energy and
        virial too."""
        pr = pair.compute(self.style, x, self.typ, self.q, self.L,
                          self.special, peratom=peratom)
        kr = ewald.compute(x, self.q, self.L, self.g, self.units["qqrd2e"],
                           peratom=peratom)
        if self.disp:
            if peratom:
                raise NotImplementedError(
                    "per-atom dispersion k-space (no dump cell needs it)")
            kd = ewald_disp.compute(x, self.typ, self.style.C, self.L,
                                    self.g6)
            kr = (kr[0] + kd[0], kr[1] + kd[1], kr[2] + kd[2])
        f = pr[0] + kr[0]
        out = dict(evdwl=float(pr[1]), ecoul=float(pr[2]), elong=kr[1],
                   emol=0.0, e14=0.0,
                   vir=float(pr[3][0, 0] + pr[3][1, 1] + pr[3][2, 2]) + kr[2])
        if peratom:
            out["eatom"] = pr[4] + kr[3]
            out["vatom"] = pr[5] + kr[4]
        if self.has_bonded:
            fb, emol, e14 = bonded.compute(self.deck, self.d, x, self.L,
                                           self.style, self.shaken)
            f = f + fb
            out["emol"], out["e14"] = float(emol), float(e14)
        out["f"] = f
        out["epot"] = (out["evdwl"] + out["ecoul"] + out["elong"]
                       + out["emol"] + out["e14"])
        return out

    def peratom(self, r: dict, v: torch.Tensor):
        """(compute pe/atom, compute stress/atom) of a ``forces`` dict
        with per-atom parts: the energy, and -(m v_a v_b mvv2e + W_ab)
        nktv2p in pressure * volume units."""
        u = self.units
        ke = torch.stack([self.mass * v[:, a] * v[:, b] for a, b in _VOIGT],
                         -1) * u["mvv2e"]
        return r["eatom"], -(ke + r["vatom"]) * u["nktv2p"]

    def kinetic(self, v: torch.Tensor, dof: int):
        """(temperature over ``dof``, sum m v^2 mvv2e) of velocities v."""
        s = float((self.mass[:, None] * v * v).to(torch.float64).sum()) \
            * self.units["mvv2e"]
        return s / (dof * self.units["boltz"]), s

    def pressure(self, v: torch.Tensor, vir_trace: float) -> float:
        _, s = self.kinetic(v, 1)
        return (s + vir_trace) / (3.0 * float(np.prod(self.L))) \
            * self.units["nktv2p"]

    def verlet_step(self, x, v, f, dt: float):
        """One velocity-Verlet step under fix nve from (x, v, f): returns
        (x, v, the force dict at the new positions)."""
        dtf = 0.5 * dt * self.units["ftm2v"]
        vh = v + dtf * f * self.minv[:, None]
        x1 = x + dt * vh
        r = self.forces(x1)
        return x1, vh + dtf * r["f"] * self.minv[:, None], r


def _kspace(ks, ps) -> bool:
    """Whether the deck's k-space has a dispersion part; refuses, by name,
    every k-space style and pair style pairing the reference lacks."""
    if ks is None:
        raise NotImplementedError("kspace_style none")
    name, diff = ks["name"], ks.get("diff", "ik")
    if name not in ("pppm", "pppm/disp"):
        raise NotImplementedError(f"kspace_style {name}")
    if diff != "ik":
        raise NotImplementedError(f"kspace_style {name} diff {diff}")
    if ks.get("slab"):
        raise NotImplementedError(f"kspace_modify slab {ks['slab']}")
    disp = name == "pppm/disp"
    if disp != (ps["name"] == "buck/long/coul/long"):
        raise NotImplementedError(
            f"pair_style {ps['name']} with kspace_style {name}")
    if disp:
        mix = ks.get("mix", ps.get("mix", "geometric"))
        if mix != "none":
            raise NotImplementedError(f"kspace_style pppm/disp mix {mix}")
        if "coul_off" in ps or ps.get("coul", "long") != "long":
            raise NotImplementedError(f"pair_style {ps['name']} coul off")
    return disp
