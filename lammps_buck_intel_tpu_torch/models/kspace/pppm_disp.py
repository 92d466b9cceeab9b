"""Dispersion PPPM (``pppm/disp``): the long-range r^-6 mesh solver.

Counterpart of ``lammps_buck_intel_tpu.models.kspace.pppm_disp``.  The
set-up is the JAX package's host numpy line for line
(``dispersion_kernel``, ``dispersion_vfac``, ``solve_g6``,
``mixing_channels``, ``setup_pppm_disp``), so the mesh, the influence
function G, vfac and the channel tables A and P equal the JAX package's
to the bit in f64.

Channels: per-atom charges a_c = A[c, type] (nch, N) and a pairing P
(nch, nch) with C6_ij = sum_cc' P_cc' a_c,i a_c',j: one geometric channel
(a = B[type], B = sqrt(4 eps) sigma^3), seven arithmetic ones or the
eigen-split no-mix ones.  The solve on the rfft half spectrum:

    chi_c = sum_d P_cd S_d,  S_c = rfftn(deposit of a_c)
    E     = 1/(2V) sum_k G Re sum_c S_c conj(chi_c) w_z + e0 + e_self
    vir   = 1/(2V) sum_k ek (delta_ab + vfac k_a k_b) + e0 delta_ab
    f_i   = sum_c a_c,i (ik field of G chi_c)(x_i)

with e0 = w(0) (asum P asum) / 2V and e_self = g6^6 / 12 sum_i C6_ii,
host scalars for a fixed composition (``elong_const``).

``disp_compute_plain`` is the JAX ``_disp_compute_multi`` (ik, any number
of channels) in torch ops: the CPU tests hold it to the JAX package.
``PPPMDisp.compute_peratom`` (compute pe/atom and stress/atom) gives each
atom its dispersion k-space energy and 6-virial, the JAX
``_disp_peratom_multi`` (the per-atom corrections of
pppm_disp_intel.cpp:512-537): per channel a_c / 2 times the interpolated
potential mesh and its six virial meshes, with the k = 0 share (w0 / 2V)
a . P asum and the self term g6^6 / 12 a . P . a, so that the shares sum
to elong and the virial of ``compute`` (on even meshes as on odd ones:
the solve's half-spectrum sums and the irfftn agree at the Nyquist
planes).  On CUDA planes ``disp_peratom``: K12b, one batched rfftn, the
per-atom spectra of every channel (K12pa spectral, ``csrc/pppm_disp.cu``
``disp_peratom_spectral``), one batched irfftn of the 7 nch meshes, the
per-atom gather of every channel (K12pa gather, ``disp_peratom_gather``);
on CPU planes ``disp_peratom_plain``, each stage's plain version.
``PPPMDisp.compute_rows`` runs the solve through the kernels on CUDA
planes (``disp_compute_rows``): entry s (an atom, or a slot of the cell
engine) carries the channel charges table[:, row[s]] of a small table
(A[:, type] with a zero column for empty slots, or per-atom B), all
channels deposited in one pass (K12b, ``csrc/pppm_disp.cu``
``disp_deposit``), one batched rfftn, the dispersion spectral kernel
(K12a), one batched irfftn and the gather of every channel's field in one
pass (K12c, ``disp_gather``); on CPU planes ``disp_compute_plain``.  The
cell engine's geometric form is ``pppm_cells.CellPPPMDisp``; its
arithmetic and no-mix decks, and every pppm/disp deck of the
neighbor-list engine, run ``compute_rows`` through ``base.BoundKSpace``.
``diff ad`` is not ported (item 10, the dispersion ad: the next slice).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from scipy.special import erfc as sp_erfc

from ...core.box import Box
from .pppm import (PPPM, KSpaceResult, _fold_idx, _greens_function,
                   _next_good, spline_table)


def dispersion_kernel(beta):
    """w(k) for the r^-6 Ewald splitting."""

    def kern(kmsq):
        k = np.sqrt(kmsq)
        t = k / (2.0 * beta)
        f = (1.0 - 2.0 * t * t) * np.exp(-t * t) \
            + 2.0 * math.sqrt(math.pi) * t**3 * sp_erfc(t)
        return -(math.pi**1.5 * beta**3 / 3.0) * f

    return kern


def dispersion_vfac(beta, grid, L) -> np.ndarray:
    """(nx, ny, nz) static [d ln w/dk]/k for the anisotropic virial."""
    def axis_k(n, prd):
        m = np.arange(n)
        m = np.where(m > n // 2, m - n, m)
        return 2.0 * np.pi * m / prd

    kx = axis_k(grid[0], L[0])[:, None, None]
    ky = axis_k(grid[1], L[1])[None, :, None]
    kz = axis_k(grid[2], L[2])[None, None, :]
    k = np.sqrt(kx**2 + ky**2 + kz**2)
    t = k / (2.0 * beta)
    f = (1.0 - 2.0 * t * t) * np.exp(-t * t) \
        + 2.0 * math.sqrt(math.pi) * t**3 * sp_erfc(t)
    fp = -6.0 * t * np.exp(-t * t) \
        + 6.0 * math.sqrt(math.pi) * t * t * sp_erfc(t)
    k_safe = np.where(k == 0.0, 1.0, k)
    out = fp / (2.0 * beta * f * k_safe)
    out[k == 0.0] = 0.0  # the k = 0 term is e0 on the diagonal
    return out


def solve_g6(cutoff: float, tol_rel: float = 1e-4) -> float:
    """g6 such that the damped real-space tail kept at the cutoff is a
    tol_rel fraction of the bare 1/rc^6 (bisection on (1 + u^2 + u^4/2)
    exp(-u^2) = tol)."""
    lo_u, hi_u = 0.5, 10.0
    for _ in range(80):
        mid = 0.5 * (lo_u + hi_u)
        val = (1.0 + mid**2 + mid**4 / 2.0) * math.exp(-mid * mid)
        if val > tol_rel:
            lo_u = mid
        else:
            hi_u = mid
    return lo_u / cutoff


def mixing_channels(mix: str, *, B=None, epsilon=None, sigma=None,
                    C6=None):
    """(A (nch, ntypes), P (nch, nch)) of a mixing rule: geometric (B),
    arithmetic (epsilon, sigma: seven binomial channels), none (C6:
    eigen-split)."""
    if mix == "geometric":
        A = np.asarray(B, np.float64)[None, :]
        P = np.ones((1, 1))
    elif mix == "arithmetic":
        eps = np.asarray(epsilon, np.float64)
        sig = np.asarray(sigma, np.float64)
        A = np.stack([
            0.25 * math.sqrt(math.comb(6, m)) * np.sqrt(eps) * sig**m
            for m in range(7)
        ])
        P = np.zeros((7, 7))
        for m in range(7):
            P[m, 6 - m] = 1.0
    elif mix == "none":
        C6 = np.asarray(C6, np.float64)
        lam, vec = np.linalg.eigh(0.5 * (C6 + C6.T))
        keep = np.abs(lam) > 1e-12 * max(np.abs(lam).max(), 1e-300)
        lam, vec = lam[keep], vec[:, keep]
        A = (vec * np.sqrt(np.abs(lam))[None, :]).T
        P = np.diag(np.sign(lam))
    else:
        raise ValueError(f"unknown dispersion mixing {mix!r}")
    return A, P


@dataclasses.dataclass
class PPPMDisp:
    """Configured dispersion PPPM (orthogonal box, ik); host numpy, with
    the device constants cached per (device, flt)."""

    g_ewald_6: float
    grid: tuple[int, int, int]
    order: int
    greensfn: np.ndarray
    kx: np.ndarray
    ky: np.ndarray
    kz: np.ndarray
    B: np.ndarray
    volume: float
    box_lo: tuple[float, float, float]
    h: tuple[float, float, float]
    acc_dtype: torch.dtype = torch.float32
    mix: str = "geometric"
    A: Optional[np.ndarray] = None       # (nch, ntypes)
    P: Optional[np.ndarray] = None       # (nch, nch)
    vfac: Optional[np.ndarray] = None    # (nx, ny, nz)
    _consts: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def w0(self) -> float:
        return -(math.pi**1.5 * self.g_ewald_6**3 / 3.0)

    def elong_const(self, bsum: float, b2sum: float) -> float:
        """The k = 0 and self terms of a geometric channel (they depend
        only on the composition: bsum = sum B, b2sum = sum B^2)."""
        return (0.5 / self.volume) * self.w0 * bsum**2 \
            + self.g_ewald_6**6 / 12.0 * b2sum

    def shim(self) -> PPPM:
        """The PPPM of the same mesh that the deposit and gather stages
        read (charges in place of qqrd2e q: qqrd2e = 1)."""
        return PPPM(g_ewald=self.g_ewald_6, grid=self.grid, order=self.order,
                    greensfn=self.greensfn, kx=self.kx, ky=self.ky,
                    kz=self.kz, qsum=0.0, qsqsum=0.0, qqrd2e=1.0,
                    volume=float(self.volume), box_lo=self.box_lo, h=self.h,
                    acc_dtype=self.acc_dtype)

    def consts(self, device, flt) -> dict:
        """Device constants of the kernels, uploaded once per (device,
        flt): the rfft half of G, of vfac and of the wave vectors, the half
        weights wz (acc), the spline piece table (flt) and the mesh's
        ``shim``; the kernel wrapper adds the pairings P it is given."""
        key = (torch.device(device), flt)
        c = self._consts.get(key)
        if c is not None:
            return c
        from .pppm_cells import half_weights

        acc = self.acc_dtype
        nzh = self.grid[2] // 2 + 1

        def up(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device, dt)

        c = dict(G=up(self.greensfn[..., :nzh], acc),
                 vfac=up(self.vfac[..., :nzh], acc),
                 k3=(up(np.asarray(self.kx)[:, None, None], acc),
                     up(np.asarray(self.ky)[None, :, None], acc),
                     up(np.asarray(self.kz)[None, None, :nzh], acc)),
                 wz=up(half_weights(self.grid[2]), acc)[None, None, :],
                 coef=up(spline_table(self.order), flt).view(-1),
                 shim=self.shim())
        self._consts[key] = c
        return c

    def compute(self, x: torch.Tensor, b: torch.Tensor, eflag: bool = True,
                vflag: bool = True) -> KSpaceResult:
        """The geometric channel: b (N,) dispersion charges at the (3, N)
        positions x."""
        return self.compute_channels(x, b[None, :], np.ones((1, 1)), eflag,
                                     vflag)

    def compute_channels(self, x: torch.Tensor, a: torch.Tensor, P=None,
                         eflag: bool = True,
                         vflag: bool = True) -> KSpaceResult:
        """Forces (acc planes), elong and the 6-virial of the channel
        charges a (nch, N) with pairing P (default ``self.P``): entry s
        reads column s of a (``compute_rows``).  A slot-order caller pads
        empty rows with zero charges."""
        row = torch.arange(a.shape[1], dtype=torch.int32, device=a.device)
        return self.compute_rows(x, row, a, P, eflag, vflag)

    def compute_rows(self, x: torch.Tensor, row: torch.Tensor,
                     table: torch.Tensor, P=None, eflag: bool = True,
                     vflag: bool = True, counts=None) -> KSpaceResult:
        """``compute_channels`` of the charges table[:, row] (nch, M): x
        (3, M) positions, row (M,) int32 columns of the (nch, K) table;
        counts: how many entries read each column (K,), where the caller
        knows them (a fixed composition), else counted here.  The kernels
        on CUDA planes (``disp_compute_rows``), ``disp_compute_plain`` on
        CPU ones."""
        P = self.P if P is None else P
        if x.is_cuda:
            return disp_compute_rows(self, x, row, table, P, eflag, vflag,
                                     counts)
        if x.device.type != "cpu":
            raise RuntimeError(
                f"no kernel and no plain version for device {x.device}")
        return disp_compute_plain(self, x, table[:, row.long()], P, eflag,
                                  vflag)

    def compute_peratom(self, x: torch.Tensor, typ=None, b_per_atom=None):
        """Per-atom dispersion energy and virial (eatom (N,), vatom (N, 6))
        in acc at the (3, N) positions x (the JAX ``compute_peratom``): with
        ``b_per_atom`` (N,) one channel of those charges, P = [[1]];
        otherwise the channels A[:, typ] in x's dtype with ``self.P``.  The
        kernels on CUDA planes (``disp_peratom``), ``disp_peratom_plain``
        on CPU ones."""
        n = x.shape[1]
        if b_per_atom is not None:
            table = b_per_atom.to(x.device, x.dtype)[None, :]
            row = torch.arange(n, dtype=torch.int32, device=x.device)
            P = np.ones((1, 1))
        else:
            table = torch.as_tensor(np.asarray(self.A, np.float64)).to(
                x.device, x.dtype)
            row = typ.to(x.device, torch.int32)
            P = self.P
        if x.is_cuda:
            return disp_peratom(self, x, row, table, P)
        if x.device.type != "cpu":
            raise RuntimeError(
                f"no kernel and no plain version for device {x.device}")
        return disp_peratom_plain(self, x, table[:, row.long()], P)


def setup_pppm_disp(
    box: Box,
    B_per_type,
    typ,
    cutoff: float,
    qqrd2e_unused: float = 1.0,
    tol_real: float = 1e-4,
    g_ewald_6: Optional[float] = None,
    grid: Optional[tuple[int, int, int]] = None,
    order: int = 5,
    acc_dtype: torch.dtype = torch.float32,
    mix: str = "geometric",
    epsilon=None,
    sigma=None,
    C6=None,
    diff: str = "ik",
    multiple_of: Optional[tuple[int, int, int]] = None,
    grid_min: Optional[tuple[int, int, int]] = None,
) -> PPPMDisp:
    """Mesh sizing, influence function and channels, the JAX package's
    algorithm: the grid resolves t = k_max / (2 g6) ~ 3 (n >= 2.2 L g6,
    at least 2 order), rounded to an FFT-friendly size, or for a
    cell-aligned mesh up to a multiple of ``multiple_of`` (at least
    ``grid_min``)."""
    if diff != "ik":
        raise NotImplementedError(
            f"pppm/disp diff {diff!r} is not ported (ik only; the "
            "multi-channel ad gather, K10 disp ad): ROADMAP queue 1 item "
            "10, the dispersion ad, the next slice")
    if box.is_triclinic:
        raise NotImplementedError(
            "triclinic pppm/disp is not ported: ROADMAP queue 1 item 14")
    L = np.asarray(box.lengths, np.float64)
    volume = float(np.prod(L))
    if g_ewald_6 is None:
        g_ewald_6 = solve_g6(cutoff, tol_real)
    if grid is None:
        n = [max(int(math.ceil(L[ax] * g_ewald_6 * 2.2)), 2 * order)
             for ax in range(3)]
        grid = []
        for ax in range(3):
            v = n[ax]
            if grid_min is not None:
                v = max(v, grid_min[ax])
            if multiple_of is not None:
                m = multiple_of[ax]
                grid.append(m * (-(-v // m)))
            else:
                grid.append(_next_good(v))
        grid = tuple(grid)
    nx, ny, nz = grid

    def kvals(n, prd):
        return 2.0 * np.pi * _fold_idx(n) / prd

    greensfn = _greens_function(grid, L, g_ewald_6, order,
                                kernel=dispersion_kernel(g_ewald_6))
    if mix == "geometric":
        A, P = mixing_channels("geometric", B=B_per_type)
    else:
        A, P = mixing_channels(mix, B=B_per_type, epsilon=epsilon,
                               sigma=sigma, C6=C6)
    return PPPMDisp(
        g_ewald_6=float(g_ewald_6), grid=grid, order=order,
        greensfn=greensfn,
        kx=kvals(nx, L[0]), ky=kvals(ny, L[1]), kz=kvals(nz, L[2]),
        B=np.asarray(B_per_type, np.float64), volume=volume,
        box_lo=tuple(float(v) for v in np.asarray(box.lo)),
        h=tuple(float(L[i] / grid[i]) for i in range(3)),
        acc_dtype=acc_dtype, mix=mix, A=A, P=P,
        vfac=dispersion_vfac(g_ewald_6, grid, L),
    )


def channel_constants(pm: PPPMDisp, a: torch.Tensor, P):
    """(e0, e_self) of channel charges a (nch, N) in acc: the k = 0 term
    (0.5 / V) w0 (asum P asum) and the self term g6^6 / 12 sum_i C6_ii."""
    acc = pm.acc_dtype
    Pm = torch.as_tensor(np.asarray(P, np.float64)).to(a.device, acc)
    aa = a.to(acc)
    asum = aa.sum(1)
    e0 = (0.5 / float(pm.volume)) * pm.w0 * (asum @ Pm @ asum)
    c6_self = torch.einsum("cn,cd,dn->n", aa, Pm, aa)
    return e0, pm.g_ewald_6 ** 6 / 12.0 * c6_self.sum()


def row_constants(pm: PPPMDisp, row: torch.Tensor, table: torch.Tensor, P,
                  counts=None):
    """``channel_constants`` of the charges table[:, row] from how many
    entries read each column, ``counts`` (K,) or a scatter of ones over
    row (no host sync): asum = table counts and sum_i C6_ii = sum_t
    counts_t (table_t P table_t), in acc."""
    acc = pm.acc_dtype
    Pm = torch.as_tensor(np.asarray(P, np.float64)).to(table.device, acc)
    tab = table.to(acc)
    if counts is None:
        counts = torch.zeros(tab.shape[1], dtype=acc, device=tab.device)
        counts.index_add_(0, row, torch.ones(row.shape, dtype=acc,
                                             device=row.device))
    counts = counts.to(acc)
    asum = tab @ counts
    e0 = (0.5 / float(pm.volume)) * pm.w0 * (asum @ Pm @ asum)
    c6_col = torch.einsum("ct,cd,dt->t", tab, Pm, tab)
    return e0, pm.g_ewald_6 ** 6 / 12.0 * (c6_col @ counts)


def disp_spectral_plain(consts: dict, S: torch.Tensor, P, ev: bool):
    """The half-spectrum solve of K12a: S (nch, nx, ny, nzh) complex ->
    (ehat (nch, 3, nx, ny, nzh) complex, esum, vsum (6,)): chi = P S, ehat
    = -i k_a G chi_c, and with ``ev`` esum = sum ek and vsum the six sums
    ek (delta_ab + vfac k_a k_b), ek = G Re(sum_c S_c conj(chi_c)) wz
    (zeros without ``ev``)."""
    G, vf = consts["G"], consts["vfac"]
    kx, ky, kz = consts["k3"]
    acc = G.dtype
    Pm = torch.as_tensor(np.asarray(P, np.float64)).to(S.device, acc)
    chi = torch.einsum("cd,dxyz->cxyz", Pm.to(S.dtype), S)
    phi = G[None] * chi
    ehat = torch.stack([torch.stack([torch.complex(k * p.imag, -(k * p.real))
                                     for k in (kx, ky, kz)]) for p in phi])
    esum = torch.zeros((), dtype=acc, device=S.device)
    vsum = torch.zeros(6, dtype=acc, device=S.device)
    if ev:
        s2 = (S.real * chi.real + S.imag * chi.imag).sum(0)
        ek = G * s2 * consts["wz"]
        esum = ek.sum()
        vsum = torch.stack([
            (ek * (1.0 + vf * kx * kx)).sum(),
            (ek * (1.0 + vf * ky * ky)).sum(),
            (ek * (1.0 + vf * kz * kz)).sum(),
            (ek * (vf * kx * ky)).sum(),
            (ek * (vf * kx * kz)).sum(),
            (ek * (vf * ky * kz)).sum(),
        ])
    return ehat, esum, vsum


def disp_spectral(consts: dict, S: torch.Tensor, P, ev: bool):
    """K12a on CUDA spectra (``ops.pppm_disp.disp_spectral``), the plain
    version on CPU ones."""
    if S.is_cuda:
        from ...ops import pppm_disp as disp_ops

        return disp_ops.disp_spectral(consts, S, P, ev)
    if S.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {S.device}")
    return disp_spectral_plain(consts, S, P, ev)


def disp_finish(pm: PPPMDisp, esum, vsum, e0, e_self, eflag: bool,
                vflag: bool):
    """(elong, virial) from the spectral sums and the host terms."""
    V = float(pm.volume)
    acc, dev = pm.acc_dtype, esum.device
    zero = torch.zeros((), dtype=acc, device=dev)
    elong = (0.5 / V) * esum + e0 + e_self if eflag else zero
    if vflag:
        diag = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], dtype=acc,
                            device=dev)
        virial = vsum * (0.5 / V) + e0 * diag
    else:
        virial = torch.zeros(6, dtype=acc, device=dev)
    return elong, virial


def _planes(x: torch.Tensor, q):
    from .pppm_cells import AtomPlanes

    return AtomPlanes(x[0], x[1], x[2], q, None)


def deposit_multi_plain(pm: PPPM, x: torch.Tensor, row: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """(nch, nx, ny, nz) meshes in x's dtype: each channel deposited with
    its charges table[c, row] (the JAX deposit per channel, ``pm`` the
    mesh)."""
    from .pppm_cells import deposit_plain

    a = table.to(x.dtype)[:, row.long()]
    return torch.stack([deposit_plain(pm, _planes(x, a[ch]))
                        for ch in range(a.shape[0])])


def gather_multi_plain(pm: PPPM, x: torch.Tensor, row: torch.Tensor,
                       table: torch.Tensor, e_fields: torch.Tensor,
                       acc_dtype):
    """(fx, fy, fz) in acc: each channel's ik field (e_fields (nch, 3, nx,
    ny, nz)) gathered at x, scaled by table[c, row], summed over the
    channels in order."""
    from .pppm_cells import gather_plain

    a = table.to(x.dtype)[:, row.long()]
    f = None
    for ch in range(a.shape[0]):
        fc = gather_plain(pm, _planes(x, a[ch]), e_fields[ch], acc_dtype)
        f = fc if f is None else tuple(u + v for u, v in zip(f, fc))
    return f


def deposit_multi(pm: PPPM, x: torch.Tensor, row: torch.Tensor,
                  table: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """K12b on CUDA planes (``ops.pppm_disp.disp_deposit``), the plain
    version on CPU ones."""
    if x.is_cuda:
        from ...ops import pppm_disp as disp_ops

        return disp_ops.disp_deposit(pm, x, row, table, coef)
    if x.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {x.device}")
    return deposit_multi_plain(pm, x, row, table)


def gather_multi(pm: PPPM, x: torch.Tensor, row: torch.Tensor,
                 table: torch.Tensor, e_fields: torch.Tensor, acc_dtype,
                 coef: torch.Tensor):
    """K12c on CUDA planes (``ops.pppm_disp.disp_gather``), the plain
    version on CPU ones."""
    if x.is_cuda:
        from ...ops import pppm_disp as disp_ops

        return disp_ops.disp_gather(pm, x, row, table, e_fields, acc_dtype,
                                    coef)
    if x.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {x.device}")
    return gather_multi_plain(pm, x, row, table, e_fields, acc_dtype)


def disp_compute_rows(pm: PPPMDisp, x: torch.Tensor, row: torch.Tensor,
                      table: torch.Tensor, P, eflag: bool, vflag: bool,
                      counts=None) -> KSpaceResult:
    """The channel solve of the charges table[:, row]: every channel
    deposited in one pass (``deposit_multi``), one batched rfftn, the
    spectral solve (``disp_spectral``), one batched irfftn, every
    channel's field gathered in one pass (``gather_multi``); kernels on
    CUDA planes, plain versions on CPU ones.  e0 and the self term come
    from the table and how many entries read each column
    (``row_constants``, with ``counts`` where the caller has them)."""
    acc, flt = pm.acc_dtype, x.dtype
    c = pm.consts(x.device, flt)
    shim = c["shim"]
    tab = table.to(flt).contiguous()
    meshes = deposit_multi(shim, x, row, tab, c["coef"])
    S = torch.fft.rfftn(meshes.to(acc), dim=(1, 2, 3)).contiguous()
    ehat, esum, vsum = disp_spectral(c, S, P, eflag or vflag)
    e0, e_self = row_constants(pm, row, table, P, counts)
    elong, virial = disp_finish(pm, esum, vsum, e0, e_self, eflag, vflag)
    ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]
    e_fields = (torch.fft.irfftn(ehat, s=pm.grid, dim=(2, 3, 4))
                * ((1.0 / float(pm.volume)) * ngrid)).to(flt).contiguous()
    f = gather_multi(shim, x, row, tab, e_fields, acc, c["coef"])
    return KSpaceResult(f=f, elong=elong, virial=virial)


def disp_compute_plain(pm: PPPMDisp, x: torch.Tensor, a: torch.Tensor, P,
                       eflag: bool, vflag: bool) -> KSpaceResult:
    """The JAX ``_disp_compute_multi`` (ik) in torch ops, any device and
    any number of channels: x (3, N) positions, a (nch, N) channel
    charges, P (nch, nch) the pairing."""
    from .pppm import deposit_rho_plain
    from .pppm_cells import AtomPlanes, gather_plain

    acc, dev = pm.acc_dtype, x.device
    ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]
    V = float(pm.volume)
    shim = pm.shim()
    meshes = torch.stack([deposit_rho_plain(shim, x, a[ch])
                          for ch in range(a.shape[0])])
    S = torch.fft.rfftn(meshes.to(acc), dim=(1, 2, 3))
    ehat, esum, vsum = disp_spectral_plain(pm.consts(dev, x.dtype), S, P,
                                           eflag or vflag)
    e0, e_self = channel_constants(pm, a, P)
    elong, virial = disp_finish(pm, esum, vsum, e0, e_self, eflag, vflag)
    e_fields = torch.fft.irfftn(ehat, s=pm.grid, dim=(2, 3, 4)) \
        * ((1.0 / V) * ngrid)
    f = None
    for ch in range(a.shape[0]):
        fc = gather_plain(shim, AtomPlanes(x[0], x[1], x[2], a[ch], None),
                          e_fields[ch], acc)
        f = fc if f is None else tuple(u + v for u, v in zip(f, fc))
    return KSpaceResult(f=f, elong=elong, virial=virial)


def disp_peratom_spectral_plain(consts: dict, S: torch.Tensor,
                                P) -> torch.Tensor:
    """(nch, 7, nx, ny, nzh) complex: per channel phi_c = G chi_c (chi = P
    S) and the six virial spectra c_m phi_c, c = (1 + vfac kx kx, 1 + vfac
    ky ky, 1 + vfac kz kz, vfac kx ky, vfac kx kz, vfac ky kz) (the JAX
    ``_disp_peratom_multi``'s spectra, in acc)."""
    G, vf = consts["G"], consts["vfac"]
    kx, ky, kz = consts["k3"]
    Pm = torch.as_tensor(np.asarray(P, np.float64)).to(S.device, G.dtype)
    chi = torch.einsum("cd,dxyz->cxyz", Pm.to(S.dtype), S)
    phi = G[None] * chi
    comps = (1.0 + vf * kx * kx, 1.0 + vf * ky * ky, 1.0 + vf * kz * kz,
             vf * kx * ky, vf * kx * kz, vf * ky * kz)
    return torch.stack([torch.stack([p] + [c * p for c in comps])
                        for p in phi])


def peratom_terms(pm: PPPMDisp, P, asum: torch.Tensor):
    """(Pm (nch, nch), Pasum = P asum (nch,), k0c, selfc) of the per-atom
    k = 0 and self terms: eatom gets k0c (a . Pasum) + selfc (a . P . a),
    k0c = w0 / (2 V), selfc = g6^6 / 12; asum (nch,) the channel sums over
    the atoms, in acc."""
    Pm = torch.as_tensor(np.asarray(P, np.float64)).to(asum.device,
                                                        asum.dtype)
    return (Pm, Pm @ asum, (0.5 / float(pm.volume)) * pm.w0,
            pm.g_ewald_6 ** 6 / 12.0)


def disp_peratom_gather_plain(pm: PPPM, x: torch.Tensor, a: torch.Tensor,
                              meshes: torch.Tensor, scale: float,
                              Pm: torch.Tensor, Pasum: torch.Tensor,
                              k0c: float, selfc: float):
    """Per-entry (eatom (M,), vatom (M, 6)) in the meshes' dtype (acc):
    each channel's seven meshes (nch, 7, nx, ny, nz) interpolated at x (3,
    M) on the mesh ``pm``, times scale (ngrid / V) and a_c / 2, summed over
    the channels in order; then the k = 0 share k0c a . Pasum (eatom and
    the diagonal) and the self term selfc a . P . a (eatom).  a (nch, M):
    the channel charges (zero on an empty slot, which then gets 0)."""
    from .pppm_cells import _CHUNK, _stencil, mesh_geometry

    acc = meshes.dtype
    nch, m = a.shape
    flat = meshes.reshape(nch, 7, -1)
    aa = a.to(acc)
    out = torch.zeros((m, 7), dtype=acc, device=x.device)
    geo = mesh_geometry(pm, None)
    planes = _planes(x, None)
    for s0 in range(0, m, _CHUNK):
        s1 = min(m, s0 + _CHUNK)
        idx, w3 = _stencil(pm, planes, s0, s1, geo)
        for ch in range(nch):
            vals = torch.stack([(w3 * flat[ch, k][idx]).sum((1, 2, 3))
                                for k in range(7)], -1) * scale
            out[s0:s1] += 0.5 * aa[ch, s0:s1, None] * vals
    k0 = k0c * (aa.t() @ Pasum)
    c6 = torch.einsum("cn,cd,dn->n", aa, Pm, aa)
    eatom = out[:, 0] + k0 + selfc * c6
    vatom = out[:, 1:].clone()
    vatom[:, :3] += k0[:, None]
    return eatom, vatom


def disp_peratom_spectral(consts: dict, S: torch.Tensor, P) -> torch.Tensor:
    """K12pa spectral on CUDA spectra (``ops.pppm_disp
    .disp_peratom_spectral``), the plain version on CPU ones."""
    if S.is_cuda:
        from ...ops import pppm_disp as disp_ops

        return disp_ops.disp_peratom_spectral(consts, S, P)
    if S.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {S.device}")
    return disp_peratom_spectral_plain(consts, S, P)


def disp_peratom_gather(pm: PPPM, x: torch.Tensor, row: torch.Tensor,
                        table: torch.Tensor, meshes: torch.Tensor,
                        coef: torch.Tensor, scale: float, terms, aid=None,
                        n_atoms: int = 0):
    """K12pa gather (``ops.pppm_disp.disp_peratom_gather``) on CUDA planes:
    entry s carries the charges table[:, row[s]]; with ``aid`` the slot
    form (K18 slots), an entry whose aid is n_atoms or more empty; terms:
    ``peratom_terms``.  On CPU planes the plain version, the charges of an
    empty entry zeroed."""
    Pm, Pasum, k0c, selfc = terms
    if x.is_cuda:
        from ...ops import pppm_disp as disp_ops

        return disp_ops.disp_peratom_gather(pm, x, row, table, meshes, coef,
                                            Pm, Pasum, scale, k0c, selfc,
                                            aid, n_atoms)
    if x.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {x.device}")
    a = table.to(x.dtype)[:, row.long()]
    if aid is not None:
        a = torch.where(aid < n_atoms, a, torch.zeros_like(a))
    return disp_peratom_gather_plain(pm, x, a, meshes, scale, Pm, Pasum, k0c,
                                     selfc)


def _disp_peratom_stages(pm: PPPMDisp, x: torch.Tensor, row: torch.Tensor,
                         table: torch.Tensor, P, plain: bool):
    acc, flt = pm.acc_dtype, x.dtype
    c = pm.consts(x.device, flt)
    shim = c["shim"]
    tab = table.to(flt).contiguous()
    meshes = (deposit_multi_plain(shim, x, row, tab) if plain
              else deposit_multi(shim, x, row, tab, c["coef"]))
    S = torch.fft.rfftn(meshes.to(acc), dim=(1, 2, 3)).contiguous()
    spectra = (disp_peratom_spectral_plain(c, S, P) if plain
               else disp_peratom_spectral(c, S, P))
    del meshes, S
    # cuFFT may hand back permuted strides; the gather reads dense meshes
    pa = torch.fft.irfftn(spectra, s=pm.grid, dim=(2, 3, 4)).contiguous()
    del spectra
    ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]
    scale = ngrid / float(pm.volume)
    asum = tab.to(acc)[:, row.long()].sum(1)
    terms = peratom_terms(pm, P, asum)
    if plain:
        return disp_peratom_gather_plain(shim, x, tab[:, row.long()], pa,
                                         scale, *terms)
    return disp_peratom_gather(shim, x, row, tab, pa, c["coef"], scale,
                               terms)


def disp_peratom(pm: PPPMDisp, x: torch.Tensor, row: torch.Tensor,
                 table: torch.Tensor, P):
    """Per-atom dispersion energy and virial of the charges table[:, row]
    (nch, N) at x (3, N): K12b, one batched rfftn, K12pa spectral, one
    batched irfftn, K12pa gather on CUDA planes (each stage's plain version
    on CPU ones)."""
    return _disp_peratom_stages(pm, x, row, table, P, plain=False)


def disp_peratom_plain(pm: PPPMDisp, x: torch.Tensor, a: torch.Tensor, P):
    """The JAX ``_disp_peratom_multi`` in torch ops, any device: x (3, N)
    positions, a (nch, N) channel charges, P (nch, nch) the pairing ->
    (eatom (N,), vatom (N, 6)) in acc.  The version the K12pa kernels are
    held to on the card."""
    row = torch.arange(a.shape[1], dtype=torch.int32, device=a.device)
    return _disp_peratom_stages(pm, x, row, a, P, plain=True)
