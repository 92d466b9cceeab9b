"""PPPM on a static box: set-up, and the generic-mesh solve of the
neighbor-list engine.

Counterpart of ``lammps_buck_intel_tpu.models.kspace.pppm``
(``setup_pppm``, ``PPPM`` with ``compute``, ``_greens_function``,
``deposit_rho``, ``_pppm_compute``, the piecewise B-spline coefficients)
for what the port runs: an orthogonal box with ik or ad differentiation,
with or without ``kspace_modify slab``; tilted boxes raise
NotImplementedError (ROADMAP queue 1 item 14).  The set-up is host numpy
run once per mesh (with ``diff="ad"`` also the measured self-force sine
series, ``_sf_sine_fit``); ``mspline_horner`` and ``dmspline_horner`` are
the plain torch forms of the piecewise-Horner weights and derivative
weights that the CUDA kernels (csrc/pppm.cu) evaluate per atom.

``PPPM.compute(x, q, eflag, vflag)`` (the neighbor-list ``Simulation``'s
k-space term, every step) solves on the mesh ``setup_pppm`` gives for the
box.  On CUDA planes it is the staged route ``compute_staged``: the K5
deposit, ``torch.fft.rfftn``, the K7 spectral kernel with the
full-spectrum conventions at the Nyquist planes, ``irfftn`` and the K8
gather, in atom order (``pppm_cells.solve_atoms``, the pipeline the
variable-cell ``TracedPPPM`` runs too), with the static influence function
``greensfn``.  With ``diff="ad"`` the same route runs K5, rfftn, the K10
ad spectral kernel (one potential spectrum), one irfftn and the K10 ad
gather (derivative weights, self-force subtracted); with ``slab`` the
K10 slab kernel adds the EW3DC dipole energy and z force after either.
On CPU planes it is ``pppm_compute_plain``, the JAX ``_pppm_compute`` and
``_pppm_compute_ad`` line for line (a full-spectrum ``fftn``, one
``ifftn`` per field axis or one for the potential).  The cell engine's
solver is ``pppm_cells.CellPPPM``.

``compute_peratom(pm, x, q)`` (compute pe/atom and stress/atom, at dump
cadence) gives each atom its k-space energy and 6-virial: the K5 deposit
in atom order, one rfftn, ``peratom_spectral`` (phi_hat = G rho_hat and
the six virial spectra c_k phi_hat in one pass, K10pa), one batched
irfftn of the seven spectra, ``peratom_gather`` (the seven meshes
interpolated at every atom through one stencil, then the self and
background terms, K10pa); CUDA planes launch the kernels of
csrc/pppm.cu, CPU planes run each stage's plain version
(``compute_peratom_plain`` runs them all on any device).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...core.box import Box
from .base import estimate_ik_error, solve_g_ewald, two_charge_force

_GOOD_SIZES = sorted(
    {2**a * 3**b * 5**c
     for a in range(1, 12) for b in range(6) for c in range(5)
     if 2**a * 3**b * 5**c <= 4096}
)
# the acons table of base.py covers orders 1..7; the kernels hold 7
MAX_ORDER = 7


def _next_good(n: int) -> int:
    for g in _GOOD_SIZES:
        if g >= n:
            return g
    raise ValueError(f"grid size {n} too large")


def _fold_idx(n: int) -> np.ndarray:
    """FFT index -> signed harmonic number (m > n/2 wraps negative)."""
    m = np.arange(n)
    return np.where(m > n // 2, m - n, m)


@functools.lru_cache(maxsize=None)
def _mspline_piece_coeffs(p: int) -> tuple:
    """(p, p) ascending coefficients of the cardinal B-spline M_p on each
    unit interval [j, j+1) in t = x - j (the reference's rho_coeff form),
    from the Cox-de Boor recursion; and the derivative pieces."""
    pieces = [np.array([1.0])]                   # M_1 on [0, 1)
    for q in range(2, p + 1):
        prev = pieces
        pieces = []
        for j in range(q):
            poly = np.zeros(q)
            if j < q - 1:
                a = prev[j]
                poly[:len(a)] += j * a
                poly[1:len(a) + 1] += a
            if 0 <= j - 1 < q - 1:
                b = prev[j - 1]
                poly[:len(b)] += (q - j) * b
                poly[1:len(b) + 1] -= b
            pieces.append(poly / (q - 1))
    C = np.stack(pieces)                          # (p intervals, p coeffs)
    dC = C[:, 1:] * np.arange(1, p)[None, :]      # derivative pieces
    return (tuple(map(tuple, C)), tuple(map(tuple, dC)))


def spline_table(p: int) -> np.ndarray:
    """(p, p) piece coefficients as an array: row j holds M_p on [j, j+1)
    in ascending powers of t."""
    return np.asarray(_mspline_piece_coeffs(p)[0], np.float64)


def dspline_table(p: int) -> np.ndarray:
    """(p, p) derivative piece coefficients: row j holds dM_p/dx on [j,
    j+1) in ascending powers of t (p - 1 of them), a zero last column."""
    out = np.zeros((p, p))
    out[:, :p - 1] = np.asarray(_mspline_piece_coeffs(p)[1], np.float64)
    return out


def _horner(table: np.ndarray, ncoef: int, p: int,
            x: torch.Tensor) -> torch.Tensor:
    """The piecewise polynomial of ``table`` at x by Horner in x's dtype:
    interval j = floor(x) clipped to [0, p-1], t = x - j, 0 outside [0,
    p).  The coefficients are rounded once to x's dtype, as the JAX
    package's constants are."""
    C = torch.as_tensor(table).to(x.device, x.dtype)
    j = torch.clamp(torch.floor(x), 0.0, p - 1)
    t = x - j
    c = C[j.long()]                               # (..., p)
    acc = c[..., ncoef - 1]
    for d in range(ncoef - 2, -1, -1):
        acc = acc * t + c[..., d]
    return torch.where((x >= 0) & (x < p), acc, torch.zeros_like(acc))


def mspline_horner(p: int, x: torch.Tensor) -> torch.Tensor:
    """M_p(x) by piecewise Horner in x's dtype (``_horner``)."""
    if p == 1:
        return ((x >= 0) & (x < 1)).to(x.dtype)
    return _horner(spline_table(p), p, p, x)


def dmspline_horner(p: int, x: torch.Tensor) -> torch.Tensor:
    """dM_p/dx by piecewise Horner over the derivative pieces (the JAX
    ``dmspline_horner``; for p = 2 the pieces are +1 and -1, the JAX
    recursion's values)."""
    return _horner(dspline_table(p), p - 1, p, x)


def mspline_np(p: int, x: np.ndarray) -> np.ndarray:
    """Cardinal B-spline M_p on (0, p) by the Cox-de Boor recursion, host
    numpy (the JAX ``mspline``; the set-up's self-force fit uses it)."""
    if p == 1:
        return ((x >= 0) & (x < 1)).astype(x.dtype)
    return (x * mspline_np(p - 1, x)
            + (p - x) * mspline_np(p - 1, x - 1)) / (p - 1)


def dmspline_np(p: int, x: np.ndarray) -> np.ndarray:
    """dM_p/dx = M_{p-1}(x) - M_{p-1}(x - 1), host numpy."""
    return mspline_np(p - 1, x) - mspline_np(p - 1, x - 1)


def stencil_offsets(order: int) -> np.ndarray:
    if order % 2:
        return np.arange(-(order - 1) // 2, (order - 1) // 2 + 1)
    return np.arange(-(order // 2 - 1), order // 2 + 1)


class KSpaceResult(NamedTuple):
    f: tuple              # (fx, fy, fz) acc planes
    elong: torch.Tensor   # ()
    virial: torch.Tensor  # (6,)


@dataclasses.dataclass
class PPPM:
    """Configured PPPM solver for a fixed box, charge set and accuracy
    (orthogonal box); host numpy, with the device constants of
    ``compute_staged`` cached per (device, dtype).

    diff: "ik" (three field meshes) or "ad" (one potential mesh, the
    derivative-weight gather less the self force ``sf_sine``: (3, J) sine
    coefficients per unit q^2, pppm_intel.cpp:985-1054, :678-804).  slab:
    the ``kspace_modify slab`` factor; grid, h, volume and kz are then
    those of the box extended by it along z, and the EW3DC dipole term
    (``slab_correction_plain``) removes the coupling of the images."""

    g_ewald: float
    grid: tuple[int, int, int]
    order: int
    greensfn: np.ndarray      # (nx, ny, nz) optimal influence, energy units
    kx: np.ndarray            # folded k components per axis
    ky: np.ndarray
    kz: np.ndarray
    qsum: float
    qsqsum: float
    qqrd2e: float
    volume: float
    box_lo: tuple[float, float, float]
    h: tuple[float, float, float]
    acc_dtype: torch.dtype = torch.float32   # spectral and force dtype
    diff: str = "ik"
    sf_sine: Optional[np.ndarray] = None
    slab: Optional[float] = None
    _consts: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    def k3(self, nzh: Optional[int] = None):
        """((nx,1,1), (1,ny,1), (1,1,nz')) wave-vector components; nzh
        slices z (the fastest FFT axis) to the rfft half space."""
        kzv = self.kz if nzh is None else self.kz[:nzh]
        return (np.asarray(self.kx)[:, None, None],
                np.asarray(self.ky)[None, :, None],
                np.asarray(kzv)[None, None, :])

    @property
    def elong_self(self) -> float:
        g = self.g_ewald
        e = -g * self.qsqsum / math.sqrt(math.pi)
        e -= math.pi / 2.0 * self.qsum**2 / (g * g * self.volume)
        return e * self.qqrd2e

    def compute(self, x: torch.Tensor, q: torch.Tensor, eflag: bool = True,
                vflag: bool = True) -> KSpaceResult:
        """Forces (acc planes), elong (with the self and background terms)
        and the 6-virial of the charges q (N,) at the (3, N) positions x:
        the staged kernels on CUDA planes, ``pppm_compute_plain`` on CPU
        planes.  Without eflag elong is 0, without vflag the virial."""
        if x.is_cuda:
            return self.compute_staged(x, q, eflag, vflag)
        if x.device.type != "cpu":
            raise RuntimeError(
                f"no kernel and no plain version for device {x.device}")
        return pppm_compute_plain(self, x, q, eflag, vflag)

    def consts(self, device, flt) -> dict:
        """Device constants of ``compute_staged``, uploaded once per
        (device, flt): the rfft half of G and of the wave vectors, the half
        weights wz (acc), the spline piece table (flt), and with ad the
        derivative piece table (flt) and the self-force series sf (acc)."""
        key = (torch.device(device), flt)
        c = self._consts.get(key)
        if c is not None:
            return c
        from .pppm_cells import half_weights

        acc = self.acc_dtype
        nzh = self.grid[2] // 2 + 1

        def up(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device, dt)

        c = dict(G_half=up(self.greensfn[..., :nzh], acc),
                 k3=tuple(up(k, acc) for k in self.k3(nzh)),
                 wz=up(half_weights(self.grid[2]), acc)[None, None, :],
                 coef=up(spline_table(self.order), flt).view(-1))
        if self.diff == "ad":
            c["dcoef"] = up(dspline_table(self.order), flt).view(-1)
            c["sf"] = up(self.sf_sine, acc)
        self._consts[key] = c
        return c

    def compute_staged(self, x: torch.Tensor, q: torch.Tensor,
                       eflag: bool = True,
                       vflag: bool = True) -> KSpaceResult:
        """``compute`` through the atom-order pipeline
        ``pppm_cells.solve_atoms`` on this mesh (its box_lo and h), ik or
        ad by ``diff``, then the slab term: the PPPM kernels on CUDA
        planes, each stage's plain version on CPU ones."""
        from .pppm_cells import slab_correct, solve_atoms

        c = self.consts(x.device, x.dtype)
        V = float(self.volume)
        f, ek, virial = solve_atoms(self, x, q, c, c["G_half"], c["k3"], V,
                                    None, eflag, vflag, c.get("sf"))
        zero = torch.zeros((), dtype=self.acc_dtype, device=x.device)
        elong = ek + self.elong_self if eflag else zero
        if not vflag:
            virial = torch.zeros(6, dtype=self.acc_dtype, device=x.device)
        if self.slab is not None:
            elong = elong + slab_correct(self, x[2], q, f[2], eflag)
        return KSpaceResult(f=f, elong=elong, virial=virial)


def bspline_weights(u: torch.Tensor, order: int, deriv: bool = False):
    """(base (M,) int64, w (M, order)) of grid coordinates u: base =
    round(u) for odd order (floor for even), w the B-spline weights of the
    points base + stencil_offsets(order) (the JAX ``bspline_weights``);
    with ``deriv`` also dw/du (M, order)."""
    offs = torch.as_tensor(stencil_offsets(order)).to(u.device, u.dtype)
    base = torch.round(u) if order % 2 else torch.floor(u)
    arg = (u[:, None] - (base[:, None] + offs)) + order / 2.0
    if deriv:
        return (base.long(), mspline_horner(order, arg),
                dmspline_horner(order, arg))
    return base.long(), mspline_horner(order, arg)


def _atom_planes(x: torch.Tensor, q: torch.Tensor):
    from .pppm_cells import AtomPlanes

    return AtomPlanes(x[0], x[1], x[2], q, None)


def deposit_rho_plain(pm: PPPM, x: torch.Tensor,
                      q: torch.Tensor) -> torch.Tensor:
    """Charge assignment (the JAX ``deposit_rho``): the (nx, ny, nz) mesh in
    x's dtype, mesh[j] = sum_a q_a w3_a(j); x (3, N) planes, q (N,)."""
    from .pppm_cells import deposit_plain

    return deposit_plain(pm, _atom_planes(x, q))


def pppm_compute_plain(pm: PPPM, x: torch.Tensor, q: torch.Tensor,
                       eflag: bool, vflag: bool) -> KSpaceResult:
    """The JAX ``_pppm_compute`` (ik) and ``_pppm_compute_ad`` in torch
    ops, any device: deposit, full-spectrum fftn, E = 1/(2V) sum_k G
    |rho_hat|^2, the 6-virial; ik: three fields by ifftn, the gather times
    q qqrd2e; ad: the potential by one ifftn, the derivative-weight gather
    less the self force; then the slab term."""
    acc, dev = pm.acc_dtype, x.device
    nx, ny, nz = pm.grid
    ngrid = nx * ny * nz
    qqrd2e = float(pm.qqrd2e)
    V = float(pm.volume)

    mesh = deposit_rho_plain(pm, x, q)
    rhat = torch.fft.fftn(mesh.to(acc))
    G = torch.as_tensor(pm.greensfn).to(dev, acc)
    phi_hat = G * rhat
    zero = torch.zeros((), dtype=acc, device=dev)
    if eflag or vflag:
        ek = G * (rhat * rhat.conj()).real
    elong = ((0.5 / V) * ek.to(acc).sum() * qqrd2e + pm.elong_self
             if eflag else zero)
    kx, ky, kz = (torch.as_tensor(k).to(dev, acc) for k in pm.k3())
    if vflag:
        ksq = kx * kx + ky * ky + kz * kz
        ksq_safe = torch.where(ksq == 0.0, torch.ones_like(ksq), ksq)
        pref = 2.0 * (1.0 / ksq_safe + 0.25 / pm.g_ewald ** 2)
        virial = torch.stack([
            (ek * (1.0 - pref * kx * kx)).sum(),
            (ek * (1.0 - pref * ky * ky)).sum(),
            (ek * (1.0 - pref * kz * kz)).sum(),
            (ek * (-pref * kx * ky)).sum(),
            (ek * (-pref * kx * kz)).sum(),
            (ek * (-pref * ky * kz)).sum(),
        ]) * ((0.5 / V) * qqrd2e)
    else:
        virial = torch.zeros(6, dtype=acc, device=dev)

    if pm.diff == "ad":
        from .pppm_cells import gather_ad_plain

        # the potential mesh: phi(r_g) = (1/V) sum_k G rho_hat e^{ikr}
        u = torch.fft.ifftn(phi_hat).real * (ngrid / V)
        sf = torch.as_tensor(pm.sf_sine).to(dev, acc)
        f = gather_ad_plain(pm, _atom_planes(x, q), u, acc, sf)
    else:
        # ik E-field: E_a(r) = (1/V) sum_k (-i k_a) G rho_hat e^{ikr}
        e_mesh = torch.stack([torch.fft.ifftn((-1j) * k * phi_hat).real
                              * ((1.0 / V) * ngrid) for k in (kx, ky, kz)])
        from .pppm_cells import gather_plain

        f = gather_plain(pm, _atom_planes(x, q), e_mesh, acc)
    if pm.slab is not None:
        e_slab, fz = slab_correction_plain(pm, x[2], q, eflag)
        elong = elong + e_slab
        f = (f[0], f[1], f[2] + fz)
    return KSpaceResult(f=f, elong=elong, virial=virial)


def slab_correction_plain(pm: PPPM, z: torch.Tensor, q: torch.Tensor,
                          eflag: bool, V=None, zprd=None):
    """The Yeh-Berkowitz EW3DC dipole term (host LAMMPS slabcorr(), called
    at pppm_intel.cpp:305; the JAX ``slab_correction`` and its traced form
    in pppm_npt.py): (e_slab, fz) in acc from the z plane and charges, M =
    sum q z, M2 = sum q z^2 in acc, e_slab = (2 pi / V) (M^2 - Q M2 - Q^2
    zprd^2 / 12) qqrd2e (0 without eflag), fz = -(4 pi / V) qqrd2e q (M - Q
    z).  V, zprd: the extended volume and z length, ``pm``'s by default
    (0-d acc tensors under a variable cell)."""
    acc = pm.acc_dtype
    if V is None:
        V = float(pm.volume)
        zprd = pm.h[2] * pm.grid[2]
    qqrd2e = float(pm.qqrd2e)
    za, qa = z.to(acc), q.to(acc)
    dipole = (qa * za).sum()
    dipole_r2 = (qa * za * za).sum()
    qsum = pm.qsum
    two_pi = 2.0 * math.pi
    if eflag:
        e = (two_pi / V) * (dipole * dipole - qsum * dipole_r2
                            - qsum * qsum * zprd * zprd / 12.0) * qqrd2e
    else:
        e = torch.zeros((), dtype=acc, device=z.device)
    ffact = -(2.0 * two_pi / V) * qqrd2e
    return e, ffact * qa * (dipole - qsum * za)


def slab_peratom_plain(pm: PPPM, z: torch.Tensor,
                       q: torch.Tensor) -> torch.Tensor:
    """Per-atom share of the slab energy in acc (the eatom tally of host
    LAMMPS slabcorr()): (2 pi / V) qqrd2e q_i (z_i M - (M2 + Q z_i^2) / 2 -
    Q zprd^2 / 12); the shares sum to ``slab_correction_plain``'s e_slab."""
    acc = pm.acc_dtype
    V, zprd = float(pm.volume), pm.h[2] * pm.grid[2]
    za, qa = z.to(acc), q.to(acc)
    dipole = (qa * za).sum()
    dipole_r2 = (qa * za * za).sum()
    qsum = pm.qsum
    efact = float(pm.qqrd2e) * 2.0 * math.pi / V
    return efact * qa * (za * dipole - 0.5 * (dipole_r2 + qsum * za * za)
                         - qsum * zprd * zprd / 12.0)


def sf_axis_series(pm: PPPM, coord: torch.Tensor, ax: int, sf=None,
                   geo=None) -> torch.Tensor:
    """The ad self-field sine series on axis ``ax`` at the 1-D coordinates
    ``coord`` (the JAX ``sf_axis_series``, its literal formula): sum_j
    sf[ax, j] sin(2 pi (j + 1) u), u = (coord - lo) / h in the coordinates'
    dtype.  sf: a (3, J) tensor (``pm.sf_sine`` by default); geo: (lo,
    1/h) per axis (``pppm_cells.mesh_geometry``, ``pm``'s by default)."""
    if geo is None:
        geo = (pm.box_lo, [1.0 / h for h in pm.h])
    lo, ih = geo
    u = (coord - lo[ax]) * ih[ax]
    if sf is None:
        sf = torch.as_tensor(np.asarray(pm.sf_sine)).to(coord.device)
    acc = None
    for j in range(sf.shape[1]):
        t = sf[ax, j] * torch.sin((2.0 * math.pi * (j + 1)) * u).to(sf.dtype)
        acc = t if acc is None else acc + t
    return acc


def _np_axis_A(n_grid: int, s: np.ndarray, order: int):
    """Host numpy: per-axis DFT factors of a B-spline point deposit, A(k,
    s) = sum_g w_g(s) exp(-2 pi i k g / n) and dA/ds (grid units), s (S,)
    absolute positions in grid units (the JAX ``_np_axis_A``)."""
    offs = stencil_offsets(order).astype(np.float64)
    base = np.round(s) if order % 2 else np.floor(s)
    g = base[:, None] + offs[None, :]                   # (S, p)
    arg = (s[:, None] - g) + order / 2.0
    w = mspline_np(order, arg)
    dw = dmspline_np(order, arg)
    k = np.arange(n_grid)
    phase = np.exp(-2j * np.pi * k[None, None, :] * g[:, :, None] / n_grid)
    A = np.einsum("sp,spk->sk", w, phase)
    dA = np.einsum("sp,spk->sk", dw, phase)
    return A, dA


def _sf_sine_fit(grid, L, greensfn, order, nterms: int = 4,
                 nsamp: int = 32) -> np.ndarray:
    """The measured ad self-force correction (the JAX ``_sf_sine_fit``;
    pppm_intel.cpp:783-798 uses a 2-term series from host-LAMMPS alias
    sums, here the series is fitted to the self field of this mesh and
    influence function).  The ad force differentiates only the weights, so
    a charge feels a force from itself that is periodic in its fractional
    grid offset; per axis (the others averaged)

      Eself_ax(s) = -(1 / (V h_ax)) sum_k G(k) Re(A_ax conj(dA_ax))(k_ax, s)
                    <|A_b|^2>(k_b) <|A_c|^2>(k_c).

    Returns (3, nterms) sine coefficients of Eself per unit q^2."""
    V = float(np.prod(L))
    s = np.arange(nsamp) / nsamp + 1e3  # offset irrelevant (periodic)
    A, dA, m = [], [], []
    for ax in range(3):
        a, da = _np_axis_A(grid[ax], s, order)
        A.append(a)
        dA.append(da)
        m.append(np.mean(np.abs(a) ** 2, axis=0))
    out = np.zeros((3, nterms))
    js = np.arange(1, nterms + 1)
    sin_basis = np.sin(2.0 * np.pi * js[None, :] * (s % 1.0)[:, None])
    for ax in range(3):
        h_ax = L[ax] / grid[ax]
        self_term = np.real(A[ax] * np.conj(dA[ax]))      # (S, k_ax)
        axes = "xyz"
        sub = f"s{axes[ax]},{axes[(ax+1)%3]},{axes[(ax+2)%3]},xyz->s"
        e_s = -np.einsum(
            sub, self_term, m[(ax + 1) % 3], m[(ax + 2) % 3], greensfn
        ) / (V * h_ax)
        out[ax] = 2.0 / nsamp * (sin_basis * e_s[:, None]).sum(axis=0)
    return out


_VIRIAL_AXES = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def peratom_spectral_plain(pm: PPPM, consts: dict, rhat: torch.Tensor,
                           nyquist: bool = True) -> torch.Tensor:
    """(7, nx, ny, nzh) complex: phi_hat = G rho_hat, then c_k phi_hat for
    the six virial factors c = delta_ab - pref k_a k_b, pref = 2 (1/k^2 +
    1/(4 g^2)) (the JAX ``compute_peratom``'s spectra, in acc).  With
    ``nyquist`` an off-diagonal factor is 0 on an interior kz plane where
    exactly one of its two axes sits on its Nyquist index (the virial
    convention of ``pppm_cells.spectral_plain``): there k_a k_b changes sign
    between a point and its mirror, the full spectrum cancels the pair,
    and the per-atom sums then equal the global virial of the
    full-spectrum solve exactly.  The JAX package's irfftn of the half
    spectrum keeps the pair (``nyquist=False``)."""
    G = consts["G_half"]
    kx, ky, kz = consts["k3"]
    phi = G * rhat
    ksq = kx * kx + ky * ky + kz * kz
    ksq_safe = torch.where(ksq == 0.0, torch.ones_like(ksq), ksq)
    pref = 2.0 * (1.0 / ksq_safe + 0.25 / (pm.g_ewald * pm.g_ewald))
    k = (kx, ky, kz)
    comps = [(1.0 if a == b else 0.0) - pref * k[a] * k[b]
             for a, b in _VIRIAL_AXES]
    if nyquist:
        inner = consts["wz"] != 1.0
        nyq = []
        for a in (0, 1):
            n = pm.grid[a]
            idx = torch.arange(n, device=G.device).view(
                (n, 1, 1) if a == 0 else (1, n, 1))
            nyq.append((idx == n // 2) if n % 2 == 0
                       else torch.zeros_like(idx, dtype=torch.bool))
        for c, drop in ((3, nyq[0] != nyq[1]), (4, nyq[0]), (5, nyq[1])):
            comps[c] = torch.where(inner & drop, torch.zeros_like(comps[c]),
                                   comps[c])
    return torch.stack([phi] + [c * phi for c in comps])


def peratom_gather_plain(pm: PPPM, planes, meshes: torch.Tensor,
                         scale: float):
    """Per-atom (eatom (N,), vatom (N, 6)) in the meshes' dtype: the seven
    meshes (7, nx, ny, nz) interpolated at every atom of ``planes`` (x, y,
    z, q), times ``scale`` (ngrid / V); eatom = qqrd2e (q u / 2 - g /
    sqrt(pi) q^2 - pi / (2 g^2 V) q qsum), vatom_c = qqrd2e q v_c / 2."""
    from .pppm_cells import _CHUNK, _stencil, mesh_geometry

    acc = meshes.dtype
    n = planes.x.shape[0]
    flat7 = meshes.reshape(7, -1)
    s = torch.empty((n, 7), dtype=acc, device=meshes.device)
    geo = mesh_geometry(pm, None)
    for s0 in range(0, n, _CHUNK):
        s1 = min(n, s0 + _CHUNK)
        flat, w3 = _stencil(pm, planes, s0, s1, geo)
        for c in range(7):
            s[s0:s1, c] = (w3 * flat7[c][flat]).sum((1, 2, 3))
    s = s * scale
    q = planes.q.to(acc)
    g, V = pm.g_ewald, float(pm.volume)
    eatom = (0.5 * q * s[:, 0] - g / math.sqrt(math.pi) * q * q
             - math.pi / (2.0 * g * g * V) * q * pm.qsum) * pm.qqrd2e
    vatom = (0.5 * pm.qqrd2e) * q[:, None] * s[:, 1:]
    return eatom, vatom


def peratom_spectral(pm: PPPM, consts: dict, rhat: torch.Tensor,
                     nyquist: bool = True) -> torch.Tensor:
    """K10pa spectral (``ops.pppm.peratom_spectral``) on CUDA spectra, the
    plain version on CPU ones."""
    if rhat.is_cuda:
        from ...ops import pppm as pppm_ops

        return pppm_ops.peratom_spectral(pm, consts, rhat, nyquist)
    if rhat.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {rhat.device}")
    return peratom_spectral_plain(pm, consts, rhat, nyquist)


def peratom_gather(pm: PPPM, planes, meshes: torch.Tensor, consts: dict,
                   n_atoms=None):
    """K10pa gather (``ops.pppm.peratom_gather``; with ``n_atoms`` the slot
    form K18 slots, whose empty slots give 0) on CUDA planes, the plain
    version on CPU ones (empty slots carry q = 0 there, which gives 0)."""
    nx, ny, nz = pm.grid
    scale = (nx * ny * nz) / float(pm.volume)
    if planes.x.is_cuda:
        from ...ops import pppm as pppm_ops

        return pppm_ops.peratom_gather(pm, planes, meshes, consts["coef"],
                                       scale, n_atoms)
    if planes.x.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {planes.x.device}")
    return peratom_gather_plain(pm, planes, meshes, scale)


def _peratom_stages(pm: PPPM, x: torch.Tensor, q: torch.Tensor,
                    nyquist: bool, plain: bool):
    from .pppm_cells import AtomPlanes, deposit, deposit_plain

    acc, flt, dev = pm.acc_dtype, x.dtype, x.device
    n = x.shape[1]
    c = pm.consts(dev, flt)
    aid = c.get("aid")
    if aid is None or aid.shape[0] != n:
        aid = c["aid"] = torch.arange(n, dtype=torch.int32, device=dev)
    planes = AtomPlanes(x[0], x[1], x[2], q, aid)
    mesh = (deposit_plain(pm, planes) if plain
            else deposit(pm, planes, n, c))
    rhat = torch.fft.rfftn(mesh.to(acc)).contiguous()
    spectra = (peratom_spectral_plain(pm, c, rhat, nyquist) if plain
               else peratom_spectral(pm, c, rhat, nyquist))
    # cuFFT may hand back permuted strides; the gather reads dense meshes
    meshes = torch.fft.irfftn(spectra, s=pm.grid, dim=(1, 2, 3)).contiguous()
    if plain:
        nx, ny, nz = pm.grid
        eatom, vatom = peratom_gather_plain(pm, planes, meshes,
                                            (nx * ny * nz) / float(pm.volume))
    else:
        eatom, vatom = peratom_gather(pm, planes, meshes, c)
    if pm.slab is not None:
        # the slab term's energy shares (its virial is not tallied, as in
        # the global sums)
        if plain:
            eatom = eatom + slab_peratom_plain(pm, x[2], q)
        else:
            from .pppm_cells import slab_peratom

            eatom = slab_peratom(pm, x[2], q, eatom)
    return eatom, vatom


def compute_peratom_plain(pm: PPPM, x: torch.Tensor, q: torch.Tensor,
                          nyquist: bool = True):
    """``compute_peratom`` with every stage's plain version, on any device
    (the version the K10pa kernels are held to on the card)."""
    return _peratom_stages(pm, x, q, nyquist, plain=True)


def compute_peratom(pm: PPPM, x: torch.Tensor, q: torch.Tensor,
                    nyquist: bool = True):
    """Per-atom k-space energy and virial (the eflag_atom / vflag_atom
    contract of pppm_intel.cpp:224-252, the JAX ``compute_peratom``):
    (eatom (N,), vatom (N, 6)) in acc, energy units, with sum eatom =
    elong and sum vatom = the virial of ``PPPM.compute`` (exactly, with
    ``nyquist``; see ``peratom_spectral_plain``).  x: (3, N) planes, q
    (N,).  CUDA planes launch K5 and K10pa around cuFFT, CPU planes run
    the plain stages.  Both differentiations share these shares (the
    potential and the virial meshes do not depend on ``diff``); with
    ``slab`` each atom also gets its share of the slab energy (K10 slab),
    so sum eatom equals elong there too."""
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(
            f"no kernel and no plain version for device {x.device}")
    return _peratom_stages(pm, x, q, nyquist, plain=False)


def pppm_g_ewald(box: Box, q, cutoff: float, accuracy_rel: float,
                 qqrd2e: float, slab: Optional[float] = None) -> float:
    """The g_ewald ``setup_pppm`` chooses when none is given; it does not
    depend on the mesh (it does on the slab factor, through the extended
    volume)."""
    q = np.asarray(q, np.float64)
    accuracy = accuracy_rel * two_charge_force(qqrd2e)
    volume = float(np.prod(np.asarray(box.lengths, np.float64)))
    if slab is not None:
        volume *= slab
    return solve_g_ewald(accuracy, cutoff, len(q), volume,
                         float((q * q).sum()) * qqrd2e)


def setup_pppm(
    box: Box,
    q,
    cutoff: float,
    accuracy_rel: float,
    qqrd2e: float,
    order: int = 5,
    g_ewald: Optional[float] = None,
    multiple_of: Optional[tuple[int, int, int]] = None,
    grid_min: Optional[tuple[int, int, int]] = None,
    acc_dtype: torch.dtype = torch.float32,
    diff: str = "ik",
    slab: Optional[float] = None,
    grid: Optional[tuple[int, int, int]] = None,
) -> PPPM:
    """Mesh sizing and influence function, the JAX package's algorithm.

    multiple_of: cell-aligned meshes (each axis a multiple of the cell
    count, at least the accuracy-driven size and grid_min).  grid: the mesh
    as given, no sizing (``kspace_modify mesh``, or a solver rebuilt on a
    new box with its mesh pinned).  diff "ad" fits the self-force series
    at set-up; slab extends the k-space box along z by that factor (at
    least 2), the mesh, h, volume and g_ewald following."""
    if diff not in ("ik", "ad"):
        raise ValueError(f"pppm diff {diff!r}: ik or ad")
    if box.is_triclinic:
        raise NotImplementedError(
            "triclinic PPPM (with or without slab) is not ported: ROADMAP "
            "queue 1 item 14")
    if slab is not None and slab < 2.0:
        raise ValueError("slab factor must be >= 2 (vacuum padding)")
    if not 2 <= order <= MAX_ORDER:
        raise NotImplementedError(
            f"pppm order {order}: the port covers orders 2..{MAX_ORDER}")
    q = np.asarray(q, np.float64)
    natoms = len(q)
    qsum = float(q.sum())
    qsqsum = float((q * q).sum())
    L = np.asarray(box.lengths, np.float64).copy()
    if slab is not None:
        L[2] *= slab      # every k-space length below is the extended box's
    volume = float(np.prod(L))
    W = L
    q2 = qsqsum * qqrd2e
    accuracy = accuracy_rel * two_charge_force(qqrd2e)
    if g_ewald is None:
        g_ewald = pppm_g_ewald(box, q, cutoff, accuracy_rel, qqrd2e, slab)

    if grid is None:
        grid = []
        for ax in range(3):
            n = 2
            while (estimate_ik_error(W[ax] / n, W[ax], natoms, order,
                                     g_ewald, q2) > accuracy):
                n += 1
                if n > 4096:
                    raise RuntimeError("pppm grid blew up")
            n = max(n, 2 * order)
            if grid_min is not None:
                n = max(n, grid_min[ax])
            if multiple_of is not None:
                m = multiple_of[ax]
                grid.append(m * -(-n // m))
            else:
                grid.append(_next_good(n))
    grid = tuple(int(v) for v in grid)
    nx, ny, nz = grid

    def kvals(n, prd):
        return 2.0 * np.pi * _fold_idx(n) / prd

    greensfn = _greens_function(grid, L, g_ewald, order)
    return PPPM(
        g_ewald=float(g_ewald), grid=grid, order=order, greensfn=greensfn,
        kx=kvals(nx, L[0]), ky=kvals(ny, L[1]), kz=kvals(nz, L[2]),
        qsum=qsum, qsqsum=qsqsum, qqrd2e=qqrd2e, volume=volume,
        box_lo=tuple(float(v) for v in np.asarray(box.lo)),
        h=tuple(float(L[i] / grid[i]) for i in range(3)),
        acc_dtype=acc_dtype, diff=diff,
        sf_sine=(_sf_sine_fit(grid, L, greensfn, order) if diff == "ad"
                 else None),
        slab=None if slab is None else float(slab))


def coulomb_kernel(g_ewald: float):
    """hat-g(k) of the Coulomb split: 4 pi / k^2 exp(-k^2 / 4 g^2), 0 at
    k = 0."""

    def kernel(kmsq):
        safe = np.where(kmsq == 0.0, 1.0, kmsq)
        g = 4.0 * np.pi / safe * np.exp(-kmsq / (4.0 * g_ewald**2))
        return np.where(kmsq == 0.0, 0.0, g)

    return kernel


def _greens_function(grid, L, g_ewald, order, nalias: int = 2,
                     kernel=None) -> np.ndarray:
    """Hockney-Eastwood optimal influence function for ik differentiation:

    G(k) = [ sum_m U^2(k_m) hat-g(k_m) (k . k_m) ] / ( |k|^2 [ sum_m U^2(k_m) ]^2 )

    U the per-axis sinc^order deposit transform, the alias sum over
    |m| <= nalias, hat-g the pair kernel of k^2 (``coulomb_kernel`` by
    default; the dispersion solver passes its own); G(0) = 0."""
    nx, ny, nz = grid
    recip = np.diag(2.0 * np.pi / np.asarray(L, np.float64))
    if kernel is None:
        kernel = coulomb_kernel(g_ewald)

    def cart_k(ix, iy, iz):
        return [recip[r, r] * np.asarray(idx, np.float64)
                for r, idx in enumerate((ix, iy, iz))]

    def sinc(t):
        out = np.ones_like(t)
        nzm = t != 0
        out[nzm] = np.sin(t[nzm]) / t[nzm]
        return out

    ix = _fold_idx(nx)[:, None, None]
    iy = _fold_idx(ny)[None, :, None]
    iz = _fold_idx(nz)[None, None, :]
    kx, ky, kz = cart_k(ix, iy, iz)
    ksq = kx**2 + ky**2 + kz**2
    num = np.zeros((nx, ny, nz))
    den = np.zeros((nx, ny, nz))
    shifts = range(-nalias, nalias + 1)
    for sx in shifts:
        ux = sinc(np.pi * (ix + sx * nx) / nx) ** order
        for sy in shifts:
            uy = sinc(np.pi * (iy + sy * ny) / ny) ** order
            for sz in shifts:
                uz = sinc(np.pi * (iz + sz * nz) / nz) ** order
                kmx, kmy, kmz = cart_k(ix + sx * nx, iy + sy * ny,
                                       iz + sz * nz)
                u2 = (ux * uy * uz) ** 2
                kmsq = kmx**2 + kmy**2 + kmz**2
                num += u2 * kernel(kmsq) * (kx * kmx + ky * kmy + kz * kmz)
                den += u2
    ksq_safe = np.where(ksq == 0.0, 1.0, ksq)
    G = num / (ksq_safe * den * den)
    G[0, 0, 0] = 0.0
    return G
