"""PPPM under a variable cell: the ``fix npt`` solver.

Counterpart of ``lammps_buck_intel_tpu.models.kspace.pppm_npt``
(``_alias_statics``, ``TracedPPPM``, ``make_traced_kspace``) for ik
differentiation on an orthogonal box.  Host LAMMPS re-runs PPPM::setup()
when the box changes: mesh size, order and g_ewald stay fixed from init,
the box-dependent tables are rebuilt.  Here the box is a (3,) tensor of
lengths on the card, and the tables are rebuilt from it without a host
round trip:

* ``tables(boxL)`` (once per neighbor block): the Hockney-Eastwood
  influence function G on the full (nx, ny, nz) mesh, a 125-term alias sum
  (nalias = 2) of box-independent spline transforms (``_alias_statics``,
  uploaded once) and box-dependent wave vectors k = 2 pi m / L.  On the
  card the ``traced_greens`` kernel of csrc/npt.cu, on the CPU
  ``traced_greens_plain``.
* ``compute_traced(x, q, boxL, ...)`` (every step): the deposit and the ik
  gather of csrc/pppm.cu with the box read on the card (lo = centre - L /
  2, h = L / n), an rfftn / irfftn pair around the spectral kernel, k
  rebuilt from boxL per call, and the half-spectrum slice of G with the
  rfft half weights: elong and the virial equal the JAX package's
  full-spectrum sums, and the ik fields its real(ifftn) (the spectral
  kernel's ``nyquist`` option).

The solver wrapped is the generic ``setup_pppm`` mesh at the deck's box,
as the JAX package's deck runner builds it for fix npt.  ``diff ad`` and
``kspace_modify slab`` raise naming ROADMAP queue 1 item 10, a tilted cell
item 14, and the dispersion solvers (``TracedPPPMDisp``,
``TracedBoundKSpace``) item 13.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import pppm_cells
from .pppm import PPPM, _fold_idx, spline_table


class KSpaceResult(NamedTuple):
    f: tuple              # (fx, fy, fz) acc planes
    elong: torch.Tensor   # ()
    virial: torch.Tensor  # (6,)


class _Planes(NamedTuple):
    """Atom-order planes in the shape the PPPM kernels read (aid is the
    identity, so every atom counts)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    q: torch.Tensor
    aid: torch.Tensor


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


class TracedPPPM:
    """Coulomb PPPM (ik, orthogonal) whose box-dependent tables follow a
    (3,) tensor of box lengths about a fixed centre.

    Built from ``setup_pppm`` at the initial box (which fixes mesh, order
    and g_ewald); ``tables(boxL)`` per block, ``compute_traced`` per
    step."""

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
        self._center = np.asarray(center, np.float64)
        self._nalias = nalias
        self._m, self._ms, self._u2, self._den_sq, _ = _alias_statics(
            pm.grid, pm.order, nalias)
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
            coef=up(spline_table(self.order), flt).view(-1))
        self._consts[key] = c
        return c

    @property
    def elong_self(self) -> float:
        """The self energy, a host constant; the background term depends
        on the volume and is added per call."""
        g = self.g_ewald
        return -g * self.qsqsum / math.sqrt(math.pi) * self.qqrd2e

    # ---- per-block tables ----

    def tables(self, boxL: torch.Tensor) -> dict:
        """{"G": the (nx, ny, nz) influence function, "G_half": its
        contiguous (nx, ny, nz // 2 + 1) rfft half} in acc, from boxL."""
        st = self.consts(boxL.device, boxL.dtype)
        if boxL.is_cuda:
            from ...ops import npt as npt_ops

            G = npt_ops.traced_greens(st, boxL, self.g_ewald)
        elif boxL.device.type == "cpu":
            G = traced_greens_plain(st, boxL, self.g_ewald)
        else:
            raise RuntimeError(
                f"no kernel and no plain version for device {boxL.device}")
        nzh = self.grid[2] // 2 + 1
        return {"G": G, "G_half": G[..., :nzh].contiguous()}

    # ---- force / energy pass ----

    def compute_traced(self, x: torch.Tensor, q: torch.Tensor,
                       boxL: torch.Tensor, eflag: bool = True,
                       kc=None) -> KSpaceResult:
        """Forces (acc planes), elong and the 6-virial of the charges q at
        the (3, N) positions x in the box boxL; kc: ``tables(boxL)`` of the
        block (rebuilt here when None)."""
        acc, flt, dev = self.acc_dtype, x.dtype, x.device
        c = self.consts(dev, flt)
        if kc is None:
            kc = self.tables(boxL)
        n = x.shape[1]
        aid = c.get("aid")
        if aid is None or aid.shape[0] != n:
            aid = c["aid"] = torch.arange(n, dtype=torch.int32, device=dev)
        planes = _Planes(x[0], x[1], x[2], q, aid)
        box = (self._center, boxL)
        nx, ny, nz = self.grid
        nzh = nz // 2 + 1
        L = boxL.to(acc)
        V = L[0] * L[1] * L[2]

        mesh = pppm_cells.deposit(self.pm, planes, n, c, box)
        rhat = torch.fft.rfftn(mesh.to(acc)).contiguous()
        kv = (2.0 * math.pi) / L
        k3 = ((c["m"][0] * kv[0]).view(-1, 1, 1),
              (c["m"][1] * kv[1]).view(1, -1, 1),
              (c["m"][2][:nzh] * kv[2]).view(1, 1, -1))
        sc = dict(G=kc["G_half"], k3=k3, wz=c["wz"], g_ewald=self.g_ewald,
                  nyquist=True)
        if not x.is_cuda:
            ksq = k3[0] * k3[0] + k3[1] * k3[1] + k3[2] * k3[2]
            ksq_safe = torch.where(ksq == 0.0, torch.ones_like(ksq), ksq)
            sc["pref"] = 2.0 * (1.0 / ksq_safe + 0.25 / self.g_ewald ** 2)
        ehat, esum, vsum = pppm_cells.spectral(sc, rhat, eflag, True)
        qqrd2e = self.qqrd2e
        zero = torch.zeros((), dtype=acc, device=dev)
        elong = zero
        if eflag:
            g = self.g_ewald
            bg = -(math.pi / 2.0 * self.qsum ** 2 / (g * g)) * qqrd2e / V
            elong = (0.5 / V) * esum * qqrd2e + self.elong_self + bg
        virial = vsum * ((0.5 / V) * qqrd2e)
        e_mesh = (torch.fft.irfftn(ehat, s=self.grid, dim=(1, 2, 3))
                  * ((1.0 / V) * (nx * ny * nz))).to(flt).contiguous()
        f = pppm_cells.gather(self.pm, planes, e_mesh, n, acc, c, box)
        return KSpaceResult(f=f, elong=elong, virial=virial)


def make_traced_kspace(kspace, center):
    """Map a deck's k-space solver to its variable-cell form: a PPPM (ik,
    orthogonal: the port's boxes are, a tilted data file raises item 14 at
    read) -> TracedPPPM; anything else raises naming its ROADMAP item."""
    if isinstance(kspace, PPPM):
        return TracedPPPM(kspace, center)
    raise NotImplementedError(
        f"fix npt: no variable-cell form of {type(kspace).__name__} in the "
        "port (pppm/disp under a variable cell, TracedPPPMDisp and "
        "TracedBoundKSpace: ROADMAP queue 1 item 13; ewald: item 10)")
