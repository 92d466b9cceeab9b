"""Buckingham pair style: coefficient tables and the per-pair physics.

Counterpart of ``lammps_buck_intel_tpu.models.pair.styles``.  The tables
use the same (T, T, 8) column layout (``COEF_NAMES``), so the CUDA
cell-pair kernel (csrc/cellpair.cu) and the plain version below read the
same numbers.  ``pair_terms`` is the plain torch form of the per-pair
physics; the kernel's device function computes the same expressions in
the same order.

The port carries ``buck`` and ``buck/coul/long`` (Ewald real-space
Coulomb through the A&S erfc; the k-space half is models/kspace).
``buck/coul/cut`` (ROADMAP queue 1 item 10), Ewald-split dispersion
(``disp == "long"``, item 13) and special-bond factors other than 1
(item 12) raise NotImplementedError.
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
    vdw: str   # "buck" | "lj" | "none"
    coul: str  # "none" | "cut" | "long"
    disp: str  # "cut" | "long"

    @property
    def has_coul(self) -> bool:
        return self.coul != "none"


@dataclasses.dataclass
class PairStyle:
    """Coefficient tables + scalars for one pair style (host numpy).

    tables: (T, T, 8) per-type-pair coefficients, buck columns
      [buck1, buck2, a, c, rhoinv, cut_ljsq, offset, cut_coulsq].
    special_lj / special_coul: (4,) factors, slot 0 == 1.0.
    """

    cfg: PairConfig
    tables: np.ndarray
    special_lj: np.ndarray
    special_coul: np.ndarray
    qqrd2e: float
    g_ewald: float = 0.0
    g_ewald_6: float = 0.0
    cutsq_max: float = 0.0  # max over tables of all cutoffs (neighbor cut)
    # (dtype, device) -> flattened tables, copied to a device once
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    def replace(self, **kw) -> "PairStyle":
        return dataclasses.replace(self, _on_device={}, **kw)

    def tables_on(self, dtype, device) -> torch.Tensor:
        """The (T*T*8,) tables as a ``dtype`` tensor on ``device``."""
        key = (dtype, torch.device(device))
        t = self._on_device.get(key)
        if t is None:
            t = torch.as_tensor(self.tables.reshape(-1)).to(device, dtype)
            self._on_device[key] = t
        return t


NCOEF = 8
COEF_NAMES = ("c0", "c1", "e0", "e1", "rhoinv", "cut_ljsq", "offset",
              "cut_coulsq")
_COL = {name: i for i, name in enumerate(COEF_NAMES)}


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
    """Buckingham builder (``coul`` "none" or "long").

    coeffs: {(i, j) 0-based: (A, rho, C[, cut_lj[, cut_coul]])} — every
    type pair must be given (buck has no mixing rule).  g_ewald is set
    later by the k-space solver (``replace(g_ewald=...)``).
    """
    if coul not in ("none", "long"):
        raise NotImplementedError(
            f"buck/coul/{coul} is not ported: ROADMAP queue 1 item 10")
    if disp != "cut":
        raise NotImplementedError(
            "buck/long (Ewald-split dispersion) is not ported: ROADMAP "
            "queue 1 item 13")
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


def check_ported(style: PairStyle):
    """Raise for what neither the kernel nor the plain version covers."""
    cfg = style.cfg
    if cfg.vdw != "buck" or cfg.coul not in ("none", "long") \
            or cfg.disp != "cut":
        raise NotImplementedError(
            f"pair style {cfg.name!r} ({cfg.vdw}, coul {cfg.coul}, disp "
            f"{cfg.disp}) is not ported: buck and buck/coul/long only "
            "(ROADMAP queue 1 items 10, 13)")


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
    f_lj, f_coul: special-bond factors; only 1.0 (plain pairs) is ported,
      anything else raises (ROADMAP queue 1 item 12).
    qi, qj: charges broadcastable against rsq (ignored without Coulomb).
    Returns (fscalar, evdwl, ecoul) with F_i += fscalar * (x_i - x_j);
    the energies are None without eflag.
    """
    cfg = style.cfg
    check_ported(style)
    if not (isinstance(f_lj, float) and isinstance(f_coul, float)
            and f_lj == f_coul == 1.0):
        raise NotImplementedError(
            "special-bond factors other than 1 are not ported: ROADMAP "
            "queue 1 item 12 (molecular decks)")
    rsq = torch.clamp(rsq, min=1e-12)
    r2inv = 1.0 / rsq
    r = torch.sqrt(rsq)
    r6inv = r2inv * r2inv * r2inv
    rexp = torch.exp(-r * coef["rhoinv"])
    rep_f = r * rexp * coef["c0"]
    rep_e = coef["e0"] * rexp
    fvdw = rep_f - r6inv * coef["c1"]
    evdwl = rep_e - coef["e1"] * r6inv - coef["offset"]
    in_lj = rsq < coef["cut_ljsq"]
    zero = torch.zeros_like(rsq)
    fvdw = torch.where(in_lj, fvdw, zero)
    ecoul = zero
    if cfg.coul == "long":
        # Ewald real space, the JAX package's expressions in its order
        qq = float(style.qqrd2e) * qi * qj
        prefactor = qq * (r * r2inv)
        grij = float(style.g_ewald) * r
        expm2 = torch.exp(-grij * grij)
        erfc = erfc_approx(grij, expm2)
        in_coul = rsq < coef["cut_coulsq"]
        fcoul = torch.where(
            in_coul, prefactor * (erfc + float(EWALD_F) * grij * expm2), zero)
        ecoul = torch.where(in_coul, prefactor * erfc, zero)
        fvdw = fvdw + fcoul
    fscalar = fvdw * r2inv
    if not eflag:
        return fscalar, None, None
    return fscalar, torch.where(in_lj, evdwl, zero), ecoul
