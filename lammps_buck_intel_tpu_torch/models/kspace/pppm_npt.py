"""PPPM under a variable cell: the ``fix npt`` solver.

Counterpart of ``lammps_buck_intel_tpu.models.kspace.pppm_npt``
(``_alias_statics``, ``_sf_statics``, ``_sf_refit_traced``,
``TracedPPPM``, ``make_traced_kspace``) for ik or ad differentiation, with
or without ``kspace_modify slab``, on an orthogonal box.  Host LAMMPS
re-runs PPPM::setup() when the box changes: mesh size, order and g_ewald
stay fixed from init, the box-dependent tables are rebuilt.  Here the box
is a (3,) tensor of lengths on the card, and the tables are rebuilt from
it without a host round trip:

* ``tables(boxL)`` (once per neighbor block): the Hockney-Eastwood
  influence function G on the full (nx, ny, nz) mesh, a 125-term alias sum
  (nalias = 2) of box-independent spline transforms (``_alias_statics``,
  uploaded once) and box-dependent wave vectors k = 2 pi m / L (L the
  k-space box: z times the slab factor).  On the card the
  ``traced_greens`` kernel of csrc/npt.cu, on the CPU
  ``traced_greens_plain``.  With ad also the self-force series re-fitted
  to that G (``sf_refit``: two contractions of G with per-axis vectors
  and a (J, S) product, torch on the card).
* ``compute_traced(x, q, boxL, ...)`` (every step): the atom-order
  pipeline ``pppm_cells.solve_atoms`` that the static ``PPPM.compute``
  runs too, here with the box read on the card (lo = centre - L / 2, h =
  L f / n, f the slab factors), k rebuilt from boxL per call and the
  half-spectrum slice of the block's G: elong and the virial equal the
  JAX package's full-spectrum sums, the ik fields its real(ifftn) (the
  spectral kernel's ``nyquist`` option); then the slab term (K10 slab)
  with the extended volume of boxL.

The solver wrapped is the generic ``setup_pppm`` mesh at the deck's box,
as the JAX package's deck runner builds it for fix npt.  A tilted cell
raises item 14; the dispersion solvers (``TracedPPPMDisp``,
``TracedBoundKSpace``) item 13(c).  ``make_traced_kspace`` hands an
``Ewald`` through as it is: its ``compute_traced`` is the variable-cell
form (K11 traced).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import pppm_cells
from .ewald import Ewald
from .pppm import (PPPM, KSpaceResult, _fold_idx, _np_axis_A,
                   dspline_table, spline_table)


def _alias_statics(grid, order: int, nalias: int):
    """Box-independent pieces of the influence function: per-axis folded
    harmonics ``m``, alias-shifted harmonics ``ms`` ((S, n) per axis),
    squared spline transforms ``u2`` ((S, n) per axis), the squared
    denominator sum and the k = 0 mask (host numpy, the JAX package's)."""
    def sinc(t):
        out = np.ones_like(t)
        m = t != 0
        out[m] = np.sin(t[m]) / t[m]
        return out

    shifts = range(-nalias, nalias + 1)
    m_fold = [_fold_idx(n).astype(np.float64) for n in grid]
    ms, u2 = [], []
    for n in grid:
        i = np.arange(n)
        i = np.where(i > n // 2, i - n, i).astype(np.float64)
        ms.append(np.asarray([i + s * n for s in shifts]))
        u2.append(np.asarray([sinc(np.pi * (i + s * n) / n) ** (2 * order)
                              for s in shifts]))
    dx, dy, dz = (u.sum(0) for u in u2)
    den = dx[:, None, None] * dy[None, :, None] * dz[None, None, :]
    kmask = np.ones(grid)
    kmask[0, 0, 0] = 0.0
    return m_fold, ms, u2, den * den, kmask


def traced_greens_plain(st: dict, boxL: torch.Tensor,
                        g_ewald: float) -> torch.Tensor:
    """Plain torch version of csrc/npt.cu traced_greens (any device): G
    (nx, ny, nz) in the statics' acc dtype, the JAX package's
    TracedPPPM.tables in its order of operations."""
    acc = st["den_sq"].dtype
    mid = st["mid"]
    g2 = float(g_ewald) ** 2
    c = (2.0 * math.pi) / boxL.to(acc)
    shape = ((-1, 1, 1), (1, -1, 1), (1, 1, -1))
    k = [(st["ms"][a][mid] * c[a]).view(shape[a]) for a in range(3)]
    ksq = k[0] * k[0] + k[1] * k[1] + k[2] * k[2]
    num = torch.zeros(st["den_sq"].shape, dtype=acc, device=boxL.device)
    S = st["ms"][0].shape[0]
    for sx in range(S):
        u2x = st["u2"][0][sx].view(shape[0])
        kmx = (st["ms"][0][sx] * c[0]).view(shape[0])
        for sy in range(S):
            u2y = st["u2"][1][sy].view(shape[1])
            kmy = (st["ms"][1][sy] * c[1]).view(shape[1])
            for sz in range(S):
                u2z = st["u2"][2][sz].view(shape[2])
                kmz = (st["ms"][2][sz] * c[2]).view(shape[2])
                kmsq = kmx * kmx + kmy * kmy + kmz * kmz
                safe = torch.where(kmsq == 0.0, torch.ones_like(kmsq), kmsq)
                g = torch.where(kmsq == 0.0, torch.zeros_like(kmsq),
                                (4.0 * math.pi) / safe
                                * torch.exp((-0.25 * safe) / g2))
                kdot = k[0] * kmx + k[1] * kmy + k[2] * kmz
                num = num + (u2x * u2y * u2z) * g * kdot
    ksq_safe = torch.where(ksq == 0.0, torch.ones_like(ksq), ksq)
    G = num / (ksq_safe * st["den_sq"])
    G[0, 0, 0] = 0.0
    return G


def _sf_statics(grid, order: int, nterms: int = 4, nsamp: int = 32):
    """Box-independent pieces of the ad self-force fit (``pppm._sf_sine_fit``
    with the box factors deferred; the JAX ``_sf_statics``): per-axis Re(A
    conj dA) self terms (S, n), mean |A|^2 factors (n,), the sine basis
    (S, J) and S."""
    s = np.arange(nsamp) / nsamp + 1e3
    selfterm, mean2 = [], []
    for ax in range(3):
        a, da = _np_axis_A(grid[ax], s, order)
        selfterm.append(np.real(a * np.conj(da)))
        mean2.append(np.mean(np.abs(a) ** 2, axis=0))
    js = np.arange(1, nterms + 1)
    basis = np.sin(2.0 * np.pi * js[None, :] * (s % 1.0)[:, None])
    return selfterm, mean2, basis, nsamp


def sf_refit(G: torch.Tensor, L: torch.Tensor, grid, st: dict):
    """The (3, J) ad self-force series re-fitted to the influence function
    G (nx, ny, nz) of the k-space box L (3,) (the JAX ``_sf_refit_traced``,
    its order of operations): per axis the projection of G on the other
    two axes' mean |A|^2, then -(selfterm @ g) / (V h) and (2 / S) basis^T
    @ that.  st: ``TracedPPPM.consts``' sf statics in G's dtype.  Plain
    contractions (``torch.tensordot``), on any device, without reading the
    box to the host."""
    V = L[0] * L[1] * L[2]
    sf = []
    for ax in range(3):
        t0, t1 = [a for a in range(3) if a != ax]
        g1 = torch.movedim(G, ax, 0)
        g1 = torch.tensordot(g1, st["sf_mean2"][t1], dims=([2], [0]))
        g1 = torch.tensordot(g1, st["sf_mean2"][t0], dims=([1], [0]))
        h_ax = L[ax] / grid[ax]
        e_s = -(st["sf_self"][ax] @ g1) / (V * h_ax)
        sf.append((2.0 / st["sf_nsamp"]) * (st["sf_basis"].t() @ e_s))
    return torch.stack(sf)


class TracedPPPM:
    """Coulomb PPPM (ik or ad, slab or not, orthogonal) whose
    box-dependent tables follow a (3,) tensor of box lengths about a fixed
    centre.

    Built from ``setup_pppm`` at the initial box (which fixes mesh, order,
    g_ewald, diff and the slab factor); ``tables(boxL)`` per block,
    ``compute_traced`` per step."""

    def __init__(self, pm: PPPM, center, nalias: int = 2):
        if not isinstance(pm, PPPM):
            raise NotImplementedError(
                f"TracedPPPM wraps a plain PPPM solver, got {type(pm)}")
        self.pm = pm
        self.grid = pm.grid
        self.order = pm.order
        self.g_ewald = float(pm.g_ewald)
        self.qqrd2e = float(pm.qqrd2e)
        self.qsum = float(pm.qsum)
        self.qsqsum = float(pm.qsqsum)
        self.acc_dtype = pm.acc_dtype
        self.diff = pm.diff
        self.slab = pm.slab
        self._center = np.asarray(center, np.float64)
        self._nalias = nalias
        self._m, self._ms, self._u2, self._den_sq, _ = _alias_statics(
            pm.grid, pm.order, nalias)
        self._sf = (_sf_statics(pm.grid, pm.order,
                                np.asarray(pm.sf_sine).shape[1])
                    if self.diff == "ad" else None)
        self._consts = {}

    def consts(self, device, flt) -> dict:
        """Device statics, uploaded once per (device, dtype): ms and u2 per
        axis (S, n) and den_sq (nx, ny, nz) in acc, mid (the unshifted
        alias row), the folded harmonics m per axis (acc), the rfft half
        weights wz (acc), the spline piece table (flt) and the identity
        atom-id plane (set by ``compute_traced``)."""
        acc = self.acc_dtype
        key = (torch.device(device), flt)
        c = self._consts.get(key)
        if c is not None:
            return c

        def up(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device, dt)

        c = dict(
            ms=tuple(up(a, acc) for a in self._ms),
            u2=tuple(up(a, acc) for a in self._u2),
            den_sq=up(self._den_sq, acc), mid=self._nalias,
            m=tuple(up(a, acc) for a in self._m),
            wz=up(pppm_cells.half_weights(self.grid[2]), acc)[None, None, :],
            coef=up(spline_table(self.order), flt).view(-1),
            slabf=up(pppm_cells.slab_factors(self.pm), acc))
        if self._sf is not None:
            selfterm, mean2, basis, nsamp = self._sf
            c.update(dcoef=up(dspline_table(self.order), flt).view(-1),
                     sf_self=tuple(up(a, acc) for a in selfterm),
                     sf_mean2=tuple(up(a, acc) for a in mean2),
                     sf_basis=up(basis, acc), sf_nsamp=nsamp)
        self._consts[key] = c
        return c

    def kspace_lengths(self, boxL: torch.Tensor) -> torch.Tensor:
        """The k-space box (3,) in acc: boxL with z times the slab
        factor."""
        c = self.consts(boxL.device, boxL.dtype)
        return boxL.to(self.acc_dtype) * c["slabf"]

    @property
    def elong_self(self) -> float:
        """The self energy, a host constant; the background term depends
        on the volume and is added per call."""
        g = self.g_ewald
        return -g * self.qsqsum / math.sqrt(math.pi) * self.qqrd2e

    # ---- per-block tables ----

    def tables(self, boxL: torch.Tensor) -> dict:
        """{"G": the (nx, ny, nz) influence function, "G_half": its
        contiguous (nx, ny, nz // 2 + 1) rfft half} in acc, from boxL (the
        k-space box: z times the slab factor); with ad also "sf", the (3,
        J) self-force series re-fitted to G (``sf_refit``)."""
        st = self.consts(boxL.device, boxL.dtype)
        Lk = boxL if self.slab is None else \
            self.kspace_lengths(boxL).to(boxL.dtype)
        if boxL.is_cuda:
            from ...ops import npt as npt_ops

            G = npt_ops.traced_greens(st, Lk, self.g_ewald)
        elif boxL.device.type == "cpu":
            G = traced_greens_plain(st, Lk, self.g_ewald)
        else:
            raise RuntimeError(
                f"no kernel and no plain version for device {boxL.device}")
        nzh = self.grid[2] // 2 + 1
        out = {"G": G, "G_half": G[..., :nzh].contiguous()}
        if self.diff == "ad":
            out["sf"] = sf_refit(G, self.kspace_lengths(boxL), self.grid,
                                 st)
        return out

    # ---- force / energy pass ----

    def compute_traced(self, x: torch.Tensor, q: torch.Tensor,
                       boxL: torch.Tensor, eflag: bool = True,
                       kc=None) -> KSpaceResult:
        """Forces (acc planes), elong and the 6-virial of the charges q at
        the (3, N) positions x in the box boxL; kc: ``tables(boxL)`` of the
        block (rebuilt here when None)."""
        acc, dev = self.acc_dtype, x.device
        c = self.consts(dev, x.dtype)
        if kc is None:
            kc = self.tables(boxL)
        nzh = self.grid[2] // 2 + 1
        L = self.kspace_lengths(boxL)
        V = L[0] * L[1] * L[2]
        kv = (2.0 * math.pi) / L
        k3 = ((c["m"][0] * kv[0]).view(-1, 1, 1),
              (c["m"][1] * kv[1]).view(1, -1, 1),
              (c["m"][2][:nzh] * kv[2]).view(1, 1, -1))
        f, ek, virial = pppm_cells.solve_atoms(
            self.pm, x, q, c, kc["G_half"], k3, V, (self._center, boxL),
            eflag, True, kc.get("sf"))
        elong = torch.zeros((), dtype=acc, device=dev)
        if eflag:
            g = self.g_ewald
            bg = -(math.pi / 2.0 * self.qsum ** 2 / (g * g)) * self.qqrd2e / V
            elong = ek + self.elong_self + bg
        if self.slab is not None:
            elong = elong + pppm_cells.slab_correct(self.pm, x[2], q, f[2],
                                                    eflag, boxL)
        return KSpaceResult(f=f, elong=elong, virial=virial)


def make_traced_kspace(kspace, center):
    """Map a deck's k-space solver to its variable-cell form: a PPPM
    (orthogonal: the port's boxes are, a tilted data file raises item 14
    at read) -> TracedPPPM; an Ewald sum as it is (its
    ``compute_traced``, K11 traced, rebuilds the k vectors from the box
    every step); anything else raises naming its ROADMAP item."""
    if isinstance(kspace, PPPM):
        return TracedPPPM(kspace, center)
    if isinstance(kspace, Ewald):
        return kspace
    raise NotImplementedError(
        f"fix npt: no variable-cell form of {type(kspace).__name__} in the "
        "port (pppm/disp under a variable cell, TracedPPPMDisp and "
        "TracedBoundKSpace: ROADMAP queue 1 item 13(c))")
