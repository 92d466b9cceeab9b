"""Buckingham, lj/cut, lj/long and lj/charmm pair styles: coefficient
tables and the per-pair physics.

Counterpart of ``lammps_buck_intel_tpu.models.pair.styles``.  The tables
use the same (T, T, 8) column layout (``COEF_NAMES``), so the CUDA
cell-pair kernel (csrc/cellpair.cu) and the plain version below read the
same numbers.  ``pair_terms`` is the plain torch form of the per-pair
physics; the kernel's device function computes the same expressions in
the same order.

The port carries ``buck``, ``buck/coul/long``, ``buck/coul/cut``,
``lj/charmm/coul/long``, ``lj/charmm/coul/cut`` and the 12-6 family of
``build_lj``: ``lj/cut``, ``lj/cut/coul/long``, ``lj/cut/coul/cut`` and
``lj/long/coul/long`` (Ewald-split dispersion, ``disp == "long"``, with
``coul`` none, long or cut), and ``buck/long/coul/long`` (``build_buck``
with ``disp == "long"``: the Buckingham repulsion beside the Ewald-split
r^-6 term).  Coulomb: Ewald real space through the A&S erfc (the k-space
half is models/kspace), or the plain Coulomb term inside its cutoff with
no k-space.  Dispersion: the r^-6 term damped by (1 + u^2 + u^4/2)
exp(-u^2), u = g_ewald_6 r, whose smooth remainder
``models.kspace.pppm_disp`` sums on a mesh.  Special-bond factors: the
LJ term of a 1-2/1-3/1-4 pair is scaled where it is evaluated (under
``disp long`` corrected additively on the undamped term, because
k-space holds every pair); the coul/long term is corrected
subtractively, the coul/cut term scaled.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Abramowitz & Stegun 7.1.26 erfc approximation (Ewald real space).
EWALD_F = 1.12837917  # 2/sqrt(pi)
EWALD_P = 0.3275911
ERFC_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)



@dataclasses.dataclass(frozen=True)
class PairConfig:
    """Static pair-style configuration."""

    name: str
    vdw: str   # "buck" | "ljcharmm" | "lj" (the JAX package also has "none")
    coul: str  # "none" | "cut" | "long"
    disp: str  # "cut" | "long"

    @property
    def has_coul(self) -> bool:
        return self.coul != "none"


@dataclasses.dataclass
class PairStyle:
    """Coefficient tables + scalars for one pair style (host numpy).

    tables: (T, T, 8) per-type-pair coefficients, columns per cfg.vdw
      buck:     [buck1, buck2, a, c, rhoinv, cut_ljsq, offset, cut_coulsq]
      lj:       [lj1, lj2, lj3, lj4, 0, cut_ljsq, offset, cut_coulsq]
      ljcharmm: [lj1, lj2, lj3, lj4, 0, cut_ljsq, 0, cut_coulsq].
    g_ewald_6: the dispersion splitting parameter of ``disp == "long"``
      (set by the deck runner from ``pppm_disp.solve_g6``).
    special_lj / special_coul: (4,) factors, slot 0 == 1.0.
    inner_sq, denom_lj: the lj/charmm switching region, cut_lj_inner^2 and
      (cut_ljsq - inner_sq)^3.  eps14 / sig14: (T,) 1-4 LJ parameters that
      dihedral charmm's baked 1-4 terms consume (``bake_charmm_14``).
    """

    cfg: PairConfig
    tables: np.ndarray
    special_lj: np.ndarray
    special_coul: np.ndarray
    qqrd2e: float
    g_ewald: float = 0.0
    g_ewald_6: float = 0.0
    cutsq_max: float = 0.0  # max over tables of all cutoffs (neighbor cut)
    inner_sq: float = 0.0
    denom_lj: float = 1.0
    eps14: Optional[np.ndarray] = None
    sig14: Optional[np.ndarray] = None
    # (dtype, device) -> flattened tables, copied to a device once
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    def replace(self, **kw) -> "PairStyle":
        return dataclasses.replace(self, _on_device={}, **kw)

    def _cached(self, what: str, array, dtype, device) -> torch.Tensor:
        key = (what, dtype, torch.device(device))
        t = self._on_device.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(array, np.float64)).to(device,
                                                                  dtype)
            self._on_device[key] = t
        return t

    def tables_on(self, dtype, device) -> torch.Tensor:
        """The (T*T*8,) tables as a ``dtype`` tensor on ``device``."""
        return self._cached("tables", self.tables.reshape(-1), dtype, device)

    def special_on(self, dtype, device) -> torch.Tensor:
        """(8,) special_lj[0:4] then special_coul[0:4] on ``device``."""
        return self._cached(
            "special", np.concatenate([self.special_lj, self.special_coul]),
            dtype, device)


NCOEF = 8
COEF_NAMES = ("c0", "c1", "e0", "e1", "rhoinv", "cut_ljsq", "offset",
              "cut_coulsq")
_COL = {name: i for i, name in enumerate(COEF_NAMES)}
# PairConfig.vdw -> the VDW template mode of csrc/pair_terms.cuh
VDW_MODE = {"buck": 0, "ljcharmm": 1, "lj": 2}


def _mix_geometric(e, s):
    return np.sqrt(e[:, None] * e[None, :]), np.sqrt(s[:, None] * s[None, :])


def _mix_arithmetic(e, s):
    return np.sqrt(e[:, None] * e[None, :]), 0.5 * (s[:, None] + s[None, :])


def build_buck(
    ntypes: int,
    coeffs: dict[tuple[int, int], tuple],
    cut_global: float,
    coul: str = "none",
    disp: str = "cut",
    cut_coul: Optional[float] = None,
    special_lj=(1.0, 0.0, 0.0, 0.0),
    special_coul=(1.0, 0.0, 0.0, 0.0),
    qqrd2e: float = 1.0,
    shift: bool = False,
    name: Optional[str] = None,
) -> PairStyle:
    """Buckingham builder (``coul`` "none", "long" or "cut"; ``disp``
    "cut", or "long" for buck/long/coul/long).

    coeffs: {(i, j) 0-based: (A, rho, C[, cut_lj[, cut_coul]])} — every
    type pair must be given (buck has no mixing rule); cut_coul defaults
    to cut_global.  g_ewald and g_ewald_6 are set later by the k-space
    solvers (``replace(g_ewald=...)``).
    """
    if coul not in ("none", "long", "cut"):
        raise ValueError(f"unknown Coulomb form {coul!r}")
    if disp not in ("cut", "long"):
        raise ValueError(f"unknown dispersion form {disp!r}")
    cut_coul = cut_global if cut_coul is None else cut_coul
    t = np.zeros((ntypes, ntypes, NCOEF), np.float64)
    seen = np.zeros((ntypes, ntypes), bool)
    for (i, j), c in coeffs.items():
        a, rho, cc = c[0], c[1], c[2]
        cut_lj = c[3] if len(c) > 3 else cut_global
        ccoul = c[4] if len(c) > 4 else cut_coul
        if rho <= 0:
            raise ValueError("buck rho must be > 0")
        row = np.zeros(NCOEF)
        row[_COL["c0"]] = a / rho          # buck1
        row[_COL["c1"]] = 6.0 * cc         # buck2
        row[_COL["e0"]] = a
        row[_COL["e1"]] = cc
        row[_COL["rhoinv"]] = 1.0 / rho
        row[_COL["cut_ljsq"]] = cut_lj**2
        row[_COL["cut_coulsq"]] = ccoul**2
        if shift:
            r6 = cut_lj**-6
            row[_COL["offset"]] = a * np.exp(-cut_lj / rho) - cc * r6
        for ii, jj in ((i, j), (j, i)):
            t[ii, jj] = row
            seen[ii, jj] = True
    if not seen.all():
        missing = np.argwhere(~seen)
        raise ValueError(f"buck coeffs missing for type pairs {missing[:4] + 1}")
    cutsq_max = float(t[..., _COL["cut_ljsq"]].max())
    if coul != "none":
        cutsq_max = max(cutsq_max, float(t[..., _COL["cut_coulsq"]].max()))
    default = f"buck/coul/{coul}" if coul != "none" else "buck"
    return PairStyle(
        cfg=PairConfig(name=name or default, vdw="buck", coul=coul,
                       disp=disp),
        tables=t,
        special_lj=np.asarray(special_lj, np.float64),
        special_coul=np.asarray(special_coul, np.float64),
        qqrd2e=float(qqrd2e),
        cutsq_max=cutsq_max,
    )


def build_lj(
    ntypes: int,
    coeffs: dict,
    cut_global: float,
    coul: str = "none",
    disp: str = "cut",
    cut_coul: Optional[float] = None,
    mix: str = "geometric",
    special_lj=(1.0, 0.0, 0.0, 0.0),
    special_coul=(1.0, 0.0, 0.0, 0.0),
    qqrd2e: float = 1.0,
    shift: bool = False,
    name: Optional[str] = None,
) -> PairStyle:
    """LJ 12-6 builder: lj/cut, lj/cut/coul/{long,cut} (disp "cut") and
    lj/long/coul/long (disp "long", coul "none" for ``coul off``).

    coeffs: {i: (eps, sigma)} per type, or {(i, j): (eps, sigma[,
    cut_lj])} overrides (0-based).  Unspecified cross terms are mixed,
    geometric by default (the rule in.hexane relies on) or arithmetic.
    g_ewald / g_ewald_6 are set later by the k-space solvers
    (``replace``)."""
    if coul not in ("none", "long", "cut"):
        raise ValueError(f"unknown Coulomb form {coul!r}")
    if disp not in ("cut", "long"):
        raise ValueError(f"unknown dispersion form {disp!r}")
    cut_coul = cut_global if cut_coul is None else cut_coul
    eps = np.zeros(ntypes)
    sig = np.zeros(ntypes)
    pair_override: dict = {}
    for key, c in coeffs.items():
        if isinstance(key, tuple):
            i, j = key
            if i == j:
                eps[i], sig[i] = c[0], c[1]
            pair_override[(min(i, j), max(i, j))] = c
        else:
            eps[key], sig[key] = c[0], c[1]
    mixer = _mix_geometric if mix == "geometric" else _mix_arithmetic
    e_ij, s_ij = mixer(eps, sig)
    cut_lj_ij = np.full((ntypes, ntypes), cut_global, np.float64)
    for (i, j), c in pair_override.items():
        e_ij[i, j] = e_ij[j, i] = c[0]
        s_ij[i, j] = s_ij[j, i] = c[1]
        if len(c) > 2:
            cut_lj_ij[i, j] = cut_lj_ij[j, i] = c[2]
    t = np.zeros((ntypes, ntypes, NCOEF), np.float64)
    s6 = s_ij**6
    t[..., _COL["c0"]] = 48.0 * e_ij * s6 * s6   # lj1
    t[..., _COL["c1"]] = 24.0 * e_ij * s6        # lj2
    t[..., _COL["e0"]] = 4.0 * e_ij * s6 * s6    # lj3
    t[..., _COL["e1"]] = 4.0 * e_ij * s6         # lj4
    t[..., _COL["cut_ljsq"]] = cut_lj_ij**2
    t[..., _COL["cut_coulsq"]] = cut_coul**2
    if shift:
        r6 = s6 / cut_lj_ij**6
        t[..., _COL["offset"]] = 4.0 * e_ij * (r6 * r6 - r6)
    cutsq_max = float(t[..., _COL["cut_ljsq"]].max())
    if coul != "none":
        cutsq_max = max(cutsq_max, float(t[..., _COL["cut_coulsq"]].max()))
    return PairStyle(
        cfg=PairConfig(name=name or "lj/cut", vdw="lj", coul=coul,
                       disp=disp),
        tables=t,
        special_lj=np.asarray(special_lj, np.float64),
        special_coul=np.asarray(special_coul, np.float64),
        qqrd2e=float(qqrd2e),
        cutsq_max=cutsq_max,
    )


def build_lj_charmm(
    ntypes: int,
    coeffs: dict[int, tuple],
    inner: float,
    cut_lj: float,
    coul: str = "long",
    cut_coul: Optional[float] = None,
    special_lj=(1.0, 0.0, 0.0, 0.0),
    special_coul=(1.0, 0.0, 0.0, 0.0),
    qqrd2e: float = 1.0,
    name: Optional[str] = None,
) -> PairStyle:
    """Build lj/charmm/coul/long or lj/charmm/coul/cut (LAMMPS
    pair_lj_charmm_coul_long, pair_lj_charmm_coul_charmm's cut form as the
    JAX package has it: the plain Coulomb term inside cut_coul).

    coeffs: {type: (eps, sigma[, eps14, sigma14])}.  CHARMM mixes
    arithmetically; the energy switches smoothly to zero between ``inner``
    and ``cut_lj``; cut_coul defaults to cut_lj.  eps14/sig14 default to
    eps/sigma and are consumed by dihedral charmm's baked 1-4 terms, not
    here: special_bonds charmm zeroes 1-2/1-3/1-4 in the pair pass.
    """
    if coul not in ("long", "cut"):
        raise NotImplementedError(
            f"lj/charmm/coul/{coul} is not ported: lj/charmm needs a "
            "Coulomb term (long or cut)")
    cut_coul = cut_lj if cut_coul is None else cut_coul
    eps, sig = np.zeros(ntypes), np.zeros(ntypes)
    e14, s14 = np.zeros(ntypes), np.zeros(ntypes)
    for t, c in coeffs.items():
        eps[t], sig[t] = c[0], c[1]
        e14[t] = c[2] if len(c) > 2 else c[0]
        s14[t] = c[3] if len(c) > 3 else c[1]
    e_ij, s_ij = _mix_arithmetic(eps, sig)
    t = np.zeros((ntypes, ntypes, NCOEF), np.float64)
    s6 = s_ij**6
    t[..., _COL["c0"]] = 48.0 * e_ij * s6 * s6
    t[..., _COL["c1"]] = 24.0 * e_ij * s6
    t[..., _COL["e0"]] = 4.0 * e_ij * s6 * s6
    t[..., _COL["e1"]] = 4.0 * e_ij * s6
    t[..., _COL["cut_ljsq"]] = cut_lj**2
    t[..., _COL["cut_coulsq"]] = cut_coul**2
    inner_sq = float(inner**2)
    return PairStyle(
        cfg=PairConfig(name=name or f"lj/charmm/coul/{coul}", vdw="ljcharmm",
                       coul=coul, disp="cut"),
        tables=t,
        special_lj=np.asarray(special_lj, np.float64),
        special_coul=np.asarray(special_coul, np.float64),
        qqrd2e=float(qqrd2e),
        cutsq_max=float(max(cut_lj, cut_coul) ** 2),
        inner_sq=inner_sq,
        denom_lj=float((cut_lj**2 - inner_sq) ** 3),
        eps14=e14,
        sig14=s14,
    )


def check_ported(style: PairStyle):
    """Raise for what neither the kernel nor the plain version covers."""
    cfg = style.cfg
    if cfg.vdw not in VDW_MODE or cfg.coul not in ("none", "long", "cut") \
            or cfg.disp not in ("cut", "long") \
            or (cfg.disp == "long" and cfg.vdw == "ljcharmm") \
            or (cfg.vdw == "ljcharmm" and cfg.coul == "none"):
        raise NotImplementedError(
            f"pair style {cfg.name!r} ({cfg.vdw}, coul {cfg.coul}, disp "
            f"{cfg.disp}) is not ported: buck, buck/coul/{{long,cut}}, "
            "lj/charmm/coul/{long,cut}, the lj/cut family and buck or lj "
            "with long-range dispersion only")


def erfc_approx(grij, expm2):
    """A&S 5-term erfc(x)*exp(x^2) form: erfc = t*poly(t)*exp(-x^2)."""
    a1, a2, a3, a4, a5 = (float(a) for a in ERFC_A)
    t = 1.0 / (1.0 + float(EWALD_P) * grij)
    return t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5)))) * expm2


def pair_terms(style: PairStyle, rsq, coef, qi, qj, f_lj, f_coul, *,
               eflag: bool):
    """Per-pair force scalar + energies (plain torch).

    rsq: squared distances (garbage at masked pairs — the caller masks).
    coef: dict of per-pair coefficients (``COEF_NAMES``), each a python
      float or a tensor broadcastable against rsq.
    f_lj, f_coul: special-bond factors, the python float 1.0 for decks
      without special bonds or tensors broadcastable against rsq.
    qi, qj: charges broadcastable against rsq (ignored without Coulomb).
    Returns (fscalar, evdwl, ecoul) with F_i += fscalar * (x_i - x_j);
    the energies are None without eflag.
    """
    cfg = style.cfg
    check_ported(style)
    rsq = torch.clamp(rsq, min=1e-12)
    r2inv = 1.0 / rsq
    r = torch.sqrt(rsq)
    r6inv = r2inv * r2inv * r2inv
    zero = torch.zeros_like(rsq)
    in_lj = rsq < coef["cut_ljsq"]
    if cfg.vdw == "buck" and cfg.disp != "long":
        rexp = torch.exp(-r * coef["rhoinv"])
        fvdw = (r * rexp * coef["c0"] - r6inv * coef["c1"]) * f_lj
        evdwl = (coef["e0"] * rexp - coef["e1"] * r6inv
                 - coef["offset"]) * f_lj
    elif cfg.disp == "long":
        # lj/long and buck/long: the r^-6 term damped by the Ewald split
        # beside the undamped repulsion, the JAX package's expressions in
        # its order (LAMMPS pair_lj_long_coul_long,
        # pair_buck_long_coul_long)
        if cfg.vdw == "buck":
            rexp = torch.exp(-r * coef["rhoinv"])
            rep_f = r * rexp * coef["c0"]
            rep_e = coef["e0"] * rexp
        else:
            rep_f = r6inv * r6inv * coef["c0"]
            rep_e = r6inv * r6inv * coef["e0"]
        g2 = float(style.g_ewald_6 ** 2)
        g6 = float(style.g_ewald_6 ** 6)
        g8 = float(style.g_ewald_6 ** 8)
        grij2 = g2 * rsq
        a2 = 1.0 / torch.clamp(grij2, min=1e-30)
        x2 = a2 * torch.exp(-grij2) * coef["e1"]
        fvdw = rep_f - g8 * x2 * rsq * (((6.0 * a2 + 6.0) * a2 + 3.0) * a2
                                        + 1.0)
        evdwl = rep_e - g6 * x2 * ((a2 + 1.0) * a2 + 0.5)
        # a special pair is corrected additively on the undamped term
        # (k-space holds every pair); elided without special bonds
        if not (isinstance(f_lj, float) and f_lj == 1.0):
            if cfg.vdw == "buck":
                tadd = f_lj - 1.0
                fvdw = fvdw + tadd * (rep_f - r6inv * coef["c1"])
                evdwl = evdwl + tadd * (rep_e - coef["e1"] * r6inv)
            else:
                tl = r6inv * (1.0 - f_lj)
                fvdw = fvdw + tl * (coef["c1"] - r6inv * coef["c0"])
                evdwl = evdwl + tl * (coef["e1"] - r6inv * coef["e0"])
    elif cfg.vdw == "lj":
        fvdw = (r6inv * r6inv * coef["c0"] - r6inv * coef["c1"]) * f_lj
        evdwl = (r6inv * r6inv * coef["e0"] - coef["e1"] * r6inv
                 - coef["offset"]) * f_lj
    else:
        # lj/charmm: the energy switch between the inner and outer cutoff
        forcelj = r6inv * r6inv * coef["c0"] - r6inv * coef["c1"]
        philj = r6inv * r6inv * coef["e0"] - coef["e1"] * r6inv
        innersq, denom = float(style.inner_sq), float(style.denom_lj)
        tt = coef["cut_ljsq"] - rsq
        switch1 = tt * tt * (coef["cut_ljsq"] + 2.0 * rsq
                             - 3.0 * innersq) / denom
        switch2 = 12.0 * rsq * tt * (rsq - innersq) / denom
        sw = rsq > innersq
        fvdw = torch.where(sw, forcelj * switch1 + philj * switch2,
                           forcelj) * f_lj
        evdwl = torch.where(sw, philj * switch1, philj) * f_lj
    fvdw = torch.where(in_lj, fvdw, zero)
    ecoul = zero
    if cfg.coul == "cut":
        # the plain Coulomb term, the JAX package's expressions
        qq = float(style.qqrd2e) * qi * qj
        fcoul = qq * (r * r2inv) * f_coul
        in_coul = rsq < coef["cut_coulsq"]
        fcoul = torch.where(in_coul, fcoul, zero)
        ecoul = fcoul
        fvdw = fvdw + fcoul
    elif cfg.coul == "long":
        # Ewald real space, the JAX package's expressions in its order
        qq = float(style.qqrd2e) * qi * qj
        prefactor = qq * (r * r2inv)
        grij = float(style.g_ewald) * r
        expm2 = torch.exp(-grij * grij)
        erfc = erfc_approx(grij, expm2)
        fcoul = prefactor * (erfc + float(EWALD_F) * grij * expm2)
        ecoul = prefactor * erfc
        # k-space holds every pair, so a special pair is corrected
        # subtractively: it keeps prefactor * (erfc - (1 - f_coul))
        if not (isinstance(f_coul, float) and f_coul == 1.0):
            adjust = (1.0 - f_coul) * prefactor
            fcoul = fcoul - adjust
            ecoul = ecoul - adjust
        in_coul = rsq < coef["cut_coulsq"]
        fcoul = torch.where(in_coul, fcoul, zero)
        ecoul = torch.where(in_coul, ecoul, zero)
        fvdw = fvdw + fcoul
    fscalar = fvdw * r2inv
    if not eflag:
        return fscalar, None, None
    return fscalar, torch.where(in_lj, evdwl, zero), ecoul
