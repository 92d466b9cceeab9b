"""K-space set-up math shared by the solvers (host numpy).

Counterpart of ``lammps_buck_intel_tpu.models.kspace.base``: accuracy ->
g_ewald, the real-space and Ewald k-space RMS error estimates that size
the Ewald k set, and the Deserno-Holm P3M ik error estimate that sizes
the PPPM mesh.  The formulas and the acons table are the JAX package's, copied so
the port imports nothing of it.  ``BoundKSpace`` binds a solver to
per-atom inputs other than the charges (the dispersion solver's B_i or
type channels); ``CombinedKSpace`` sums solvers (the Coulomb PPPM and the
dispersion PPPM of ``kspace_style pppm/disp``).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def two_charge_force(qqrd2e: float) -> float:
    """Force between two unit charges one distance unit apart — converts
    relative accuracy to absolute force accuracy (LAMMPS convention)."""
    return qqrd2e


def solve_g_ewald(accuracy_abs: float, cutoff: float, natoms: int,
                  volume: float, q2: float) -> float:
    """Ewald splitting parameter from the real-space RMS force error
    dF = 2 q2 sqrt(1/(N rc V)) exp(-g^2 rc^2) == accuracy (q2 = qsqsum *
    qqrd2e); the empirical (1.35 - 0.15 log(acc))/rc when the closed form
    has no solution."""
    arg = accuracy_abs * math.sqrt(natoms * cutoff * volume) / (2.0 * q2)
    if arg >= 1.0:
        return (1.35 - 0.15 * math.log(accuracy_abs)) / cutoff
    return math.sqrt(-math.log(arg)) / cutoff


def rms_real(g: float, cutoff: float, natoms: int, volume: float,
             q2: float) -> float:
    """Kolafa-Perram real-space RMS force error."""
    return (2.0 * q2 * math.sqrt(1.0 / (natoms * cutoff * volume))
            * math.exp(-g * g * cutoff * cutoff))


def rms_kspace_ewald(km: int, prd: float, natoms: int, g: float,
                     q2: float) -> float:
    """Petersen's RMS force error for a truncated Ewald sum along one axis."""
    if km <= 0:
        return math.inf
    return (2.0 * q2 * g / prd
            * math.sqrt(1.0 / (math.pi * km * natoms))
            * math.exp(-(math.pi * km / (g * prd)) ** 2))


def acons_table() -> np.ndarray:
    """Deserno & Holm (1998) P3M ik error expansion coefficients,
    acons[order][m] (the table LAMMPS' PPPM::compute_acons builds)."""
    a = np.zeros((8, 7))
    a[1][0] = 2.0 / 3.0
    a[2][0] = 1.0 / 50.0
    a[2][1] = 5.0 / 294.0
    a[3][0] = 1.0 / 588.0
    a[3][1] = 7.0 / 1440.0
    a[3][2] = 21.0 / 3872.0
    a[4][0] = 1.0 / 4320.0
    a[4][1] = 3.0 / 1936.0
    a[4][2] = 7601.0 / 2271360.0
    a[4][3] = 143.0 / 28800.0
    a[5][0] = 1.0 / 23232.0
    a[5][1] = 7601.0 / 13628160.0
    a[5][2] = 143.0 / 69120.0
    a[5][3] = 517231.0 / 106536960.0
    a[5][4] = 106640677.0 / 11737571328.0
    a[6][0] = 691.0 / 68140800.0
    a[6][1] = 13.0 / 57600.0
    a[6][2] = 47021.0 / 35512320.0
    a[6][3] = 9694607.0 / 2095994880.0
    a[6][4] = 733191589.0 / 59609088000.0
    a[6][5] = 326190917.0 / 11700633600.0
    a[7][0] = 1.0 / 345600.0
    a[7][1] = 3617.0 / 35512320.0
    a[7][2] = 745739.0 / 838397952.0
    a[7][3] = 56399353.0 / 12773376000.0
    a[7][4] = 25091609.0 / 1560084480.0
    a[7][5] = 1755948832039.0 / 36229939200000.0
    a[7][6] = 4887769399.0 / 37838389248.0
    return a


def estimate_ik_error(h: float, prd: float, natoms: int, order: int,
                      g_ewald: float, q2: float) -> float:
    """P3M ik-differentiation k-space RMS force error (Deserno-Holm)."""
    acons = acons_table()
    s = sum(acons[order][m] * (h * g_ewald) ** (2 * m) for m in range(order))
    return (q2 * (h * g_ewald) ** order
            * math.sqrt(g_ewald * prd * math.sqrt(2.0 * math.pi) * s / natoms)
            / (prd * prd))


class BoundKSpace:
    """A solver whose per-atom inputs are not the charges (the dispersion
    charges B_i of ``PPPMDisp``), bound to those inputs, so that an engine
    calls it like a Coulomb solver: ``compute(x, q)`` ignores q.

    Counterpart of the JAX ``BoundKSpace``: per_atom is (N,) B_i, or with
    ``typed`` the (N,) type ids whose channel charges A[:, type] the
    solver's pairing P combines.  ``compute_slot`` is the cell engine's
    slot-order form: x (3, NS) slot positions and aid (NS,) atom ids
    clamped to N, the baked atom-order inputs gathered through aid with a
    zero row for empty slots.

    The solver reads the charges as table[:, row] (``PPPMDisp.compute_rows``):
    typed, the (nch, T + 1) table of A with a zero column T and the rows
    type (atoms) or type of aid with T for empty slots (slots); otherwise
    the (1, N + 1) table of B with a zero column N and the rows the atom ids
    (the aid plane itself for slots)."""

    def __init__(self, solver, per_atom, typed: bool = False):
        self.solver = solver
        self.per_atom = np.asarray(per_atom)
        self.typed = typed
        self._dev = {}

    def _tables(self, device, dtype):
        """(table (nch, K + 1), atom rows (N,) int32, rows of a clamped aid
        (N + 1,) int32, how many atoms read each column (K + 1,) f64) on
        ``device``, made once: the composition is fixed, so the k = 0 and
        self terms need no count over the entries of each call."""
        key = (torch.device(device), dtype)
        t = self._dev.get(key)
        if t is None:
            n = len(self.per_atom)
            if self.typed:
                af = np.asarray(self.solver.A, np.float64)
                rows = self.per_atom.astype(np.int32)
            else:
                af = np.asarray(self.per_atom, np.float64)[None, :]
                rows = np.arange(n, dtype=np.int32)
            af = np.concatenate([af, np.zeros((af.shape[0], 1))], 1)
            slot_rows = np.concatenate([rows, [af.shape[1] - 1]])
            counts = np.bincount(rows, minlength=af.shape[1])
            t = self._dev[key] = (
                torch.as_tensor(af).to(device, dtype),
                torch.as_tensor(rows).to(device),
                torch.as_tensor(slot_rows.astype(np.int32)).to(device),
                torch.as_tensor(counts.astype(np.float64)).to(device))
        return t

    def _pairing(self):
        return self.solver.P if self.typed else np.ones((1, 1))

    def compute(self, x, q, eflag=True, vflag=True):
        table, rows, _, counts = self._tables(x.device, x.dtype)
        return self.solver.compute_rows(x, rows, table, self._pairing(),
                                        eflag, vflag, counts)

    def compute_slot(self, x, aid, q, eflag=True, vflag=True):
        table, _, slot_rows, counts = self._tables(x.device, x.dtype)
        rows = torch.index_select(slot_rows, 0, aid.to(torch.int32))
        return self.solver.compute_rows(x, rows, table, self._pairing(),
                                        eflag, vflag, counts)

    def compute_peratom(self, x):
        """Per-atom (eatom (N,), vatom (N, 6)) of the bound solver at the
        (3, N) atom positions x, as the JAX per-atom computes bind it:
        typed, the solver's channels of the type ids; otherwise the bound
        charges cast to f32 whatever x's dtype (JAX computes.py:149-152)."""
        if self.typed:
            typ = torch.as_tensor(self.per_atom.astype(np.int32))
            return self.solver.compute_peratom(x, typ=typ.to(x.device))
        b = torch.as_tensor(self.per_atom.astype(np.float32))
        return self.solver.compute_peratom(x, b_per_atom=b.to(x.device))


def _sum_results(a, b):
    from .pppm import KSpaceResult

    return KSpaceResult(f=tuple(u + v for u, v in zip(a.f, b.f)),
                        elong=a.elong + b.elong, virial=a.virial + b.virial)


class CombinedKSpace:
    """The sum of several k-space solvers: ``kspace_style pppm/disp`` with
    long-range Coulomb is a Coulomb ``PPPM`` beside a dispersion
    ``BoundKSpace`` (the reference's two pipelines,
    pppm_disp_intel.cpp:183-313).  Counterpart of the JAX
    ``CombinedKSpace``: forces, elong and the virial add in the order of
    ``solvers``."""

    def __init__(self, solvers):
        self.solvers = list(solvers)

    def compute(self, x, q, eflag=True, vflag=True):
        out = None
        for s in self.solvers:
            r = s.compute(x, q, eflag=eflag, vflag=vflag)
            out = r if out is None else _sum_results(out, r)
        return out

    def compute_slot(self, x, aid, q, eflag=True, vflag=True):
        """Slot order: a solver with ``compute_slot`` gathers its
        atom-order inputs through aid; a charge solver takes the slot
        charges directly (empty slots carry q = 0, and their finite
        positions fold into the mesh)."""
        out = None
        for s in self.solvers:
            if hasattr(s, "compute_slot"):
                r = s.compute_slot(x, aid, q, eflag=eflag, vflag=vflag)
            else:
                r = s.compute(x, q, eflag=eflag, vflag=vflag)
            out = r if out is None else _sum_results(out, r)
        return out
