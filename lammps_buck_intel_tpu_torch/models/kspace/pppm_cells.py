"""PPPM on the cell-slot layout: deposit, spectral solve, ik gather.

Counterpart of ``lammps_buck_intel_tpu.models.kspace.pppm_cells.CellPPPM``
(ik differentiation, Coulomb).  The JAX package moves charge between
slots and mesh through per-cell spline patches and one-hot matrix
products ("zblock", "columns", "patches"): forms that keep a TPU's
matrix unit busy and avoid scatters.  The port has one deposit and one
gather on the global periodic mesh, the generic form of the JAX
package's ``pppm.deposit_rho`` and ik gather with the piecewise-Horner
weights: every slot puts q * wx * wy * wz on the order^3 mesh points
around it, each index wrapped periodically, so positions that drifted up
to skin/2 out of the box or out of their cell need no margin.  The mesh
stays aligned to the coarse cell grid (``run.py`` picks it) so both
packages solve on the same mesh.

Index convention (the JAX ``bspline_weights``): u = (x - lo) / h per
axis, base = round(u) for odd order (floor for even), and mesh point
base + o, o in ``stencil_offsets(order)``, gets M_p(u - (base + o) +
p/2).  The patch form of ``_axis_weights`` evaluates the same M_p at the
same argument on the same mesh point (its patch index plus patch_lo).

Three stages, each a CUDA kernel on CUDA tensors (``ops.pppm``) and the
plain torch version below on CPU tensors:
  * ``deposit``: slot planes -> (nx, ny, nz) charge mesh in flt;
  * ``spectral``: rfftn(mesh) (cuFFT through torch.fft, outside the
    kernel) -> the three ik spectra -i k_a G rho_hat, and with eflag /
    vflag elong and the 6-virial over the half spectrum;
  * ``gather``: one batched irfftn of the spectra -> E meshes, then the
    field at every slot times q * qqrd2e, in acc.
"""
from __future__ import annotations

import numpy as np
import torch

from ...neighbor.cell_slots import SlotState
from .pppm import PPPM, mspline_horner, spline_table, stencil_offsets

# slots per chunk of the plain deposit and gather: bounds the
# (chunk, order^3) index and value temporaries
_CHUNK = 1 << 15


def half_weights(nz: int) -> np.ndarray:
    """rfft spectrum weights along z: interior k planes count twice."""
    nzh = nz // 2 + 1
    wz = np.full(nzh, 2.0)
    wz[0] = 1.0
    if nz % 2 == 0:
        wz[-1] = 1.0
    return wz


def mesh_geometry(pm: PPPM, box=None):
    """(lo, 1/h) per axis of the mesh: ``pm``'s (host floats, 1/h by an
    f64 reciprocal), or for box = (centre, boxL) a box on the card (the
    variable cell) lo = centre - L / 2 and 1/h = n / L in boxL's dtype,
    the JAX package's TracedPPPM._weights order, as the kernels take it."""
    if box is None:
        return pm.box_lo, [1.0 / h for h in pm.h]
    center, boxL = box
    lo = torch.as_tensor(np.asarray(center, np.float64)).to(boxL) \
        - 0.5 * boxL
    ih = torch.as_tensor(np.asarray(pm.grid, np.float64)).to(boxL) / boxL
    return lo, ih


def axis_weights(pm: PPPM, plane: torch.Tensor, ax: int, geo):
    """(base (M,) int64, w (M, order)) of positions ``plane`` on mesh
    axis ``ax`` of the geometry ``geo`` (``mesh_geometry``), in the plane's
    dtype (the JAX ``bspline_weights`` with ``mspline_horner``)."""
    p = pm.order
    lo, ih = geo
    u = (plane - lo[ax]) * ih[ax]
    base = torch.round(u) if p % 2 else torch.floor(u)
    offs = torch.as_tensor(stencil_offsets(p)).to(u.device, u.dtype)
    arg = (u[:, None] - (base[:, None] + offs)) + p / 2.0
    return base.long(), mspline_horner(p, arg)


def _stencil(pm: PPPM, state: SlotState, s0: int, s1: int, geo):
    """Flat wrapped mesh indices (M, p, p, p) and weights w3 (M, p, p, p)
    of slots [s0, s1)."""
    nx, ny, nz = pm.grid
    offs = torch.as_tensor(stencil_offsets(pm.order), device=state.x.device)
    idx, ws = [], []
    planes = (state.x, state.y, state.z)
    for ax, (plane, n) in enumerate(zip(planes, pm.grid)):
        base, w = axis_weights(pm, plane[s0:s1], ax, geo)
        idx.append(torch.remainder(base[:, None] + offs, n))
        ws.append(w)
    flat = ((idx[0][:, :, None, None] * ny + idx[1][:, None, :, None]) * nz
            + idx[2][:, None, None, :])
    w3 = (ws[0][:, :, None, None] * ws[1][:, None, :, None]
          * ws[2][:, None, None, :])
    return flat, w3


def deposit_plain(pm: PPPM, state: SlotState, box=None) -> torch.Tensor:
    """(nx, ny, nz) flt charge mesh: sum over slots of q w3 (empty slots
    carry q = 0); ``box`` as in ``mesh_geometry``."""
    nx, ny, nz = pm.grid
    mesh = torch.zeros(nx * ny * nz, dtype=state.x.dtype,
                       device=state.x.device)
    ns = state.x.shape[0]
    geo = mesh_geometry(pm, box)
    for s0 in range(0, ns, _CHUNK):
        s1 = min(ns, s0 + _CHUNK)
        flat, w3 = _stencil(pm, state, s0, s1, geo)
        vals = w3 * state.q[s0:s1, None, None, None]
        mesh.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    return mesh.view(nx, ny, nz)


def spectral_plain(consts: dict, rhat: torch.Tensor, eflag: bool,
                   vflag: bool):
    """Half-spectrum solve: (ehat (3, nx, ny, nzh) complex, esum, vsum)
    with esum = sum(ek) and vsum the six sums of ek (delta_ab - pref k_a
    k_b), ek = G |rho_hat|^2 wz (zeros without eflag / vflag).

    consts["nyquist"] (the variable-cell solver): the full-spectrum
    conventions of the JAX package's TracedPPPM at the Nyquist planes of
    even nx, ny.  (1) The x and y spectra take k = 0 on their own axis's
    Nyquist plane: there -i k G rho_hat is anti-Hermitian, so the real part
    of a full inverse FFT drops it, while the c2r of a half spectrum would
    keep it (the z Nyquist plane needs nothing: c2r drops its imaginary
    part).  (2) An off-diagonal virial sum over an interior kz plane
    (weight 2, the point and its mirror) takes weight 0 where exactly one
    of its two axes sits on its Nyquist index, its own mirror: k_a k_b
    changes sign between the point and its mirror, and the full sum
    cancels the pair."""
    G = consts["G"]
    kx, ky, kz = consts["k3"]
    phi = G * rhat
    ke = [kx, ky, kz]
    nyq = [torch.zeros(k.shape, dtype=torch.bool, device=k.device)
           for k in (kx, ky)]
    if consts.get("nyquist"):
        for a in (0, 1):
            n = ke[a].shape[a]
            if n % 2 == 0:
                nyq[a].select(a, n // 2).fill_(True)
                ke[a] = torch.where(nyq[a], torch.zeros_like(ke[a]), ke[a])
    ehat = torch.stack([torch.complex(k * phi.imag, -(k * phi.real))
                        for k in ke])
    acc = G.dtype
    esum = torch.zeros((), dtype=acc, device=G.device)
    vsum = torch.zeros(6, dtype=acc, device=G.device)
    if eflag or vflag:
        ek = G * (rhat.real * rhat.real + rhat.imag * rhat.imag) \
            * consts["wz"]
        esum = ek.sum()
        pref = consts["pref"]
        inner = consts["wz"] != 1.0

        def off(a, b, term):
            drop = inner & (nyq[a] != nyq[b] if b < 2 else nyq[a])
            return torch.where(drop, torch.zeros_like(term), term).sum()

        vsum = torch.stack([
            (ek * (1.0 - pref * kx * kx)).sum(),
            (ek * (1.0 - pref * ky * ky)).sum(),
            (ek * (1.0 - pref * kz * kz)).sum(),
            off(0, 1, ek * (-pref * kx * ky)),
            off(0, 2, ek * (-pref * kx * kz)),
            off(1, 2, ek * (-pref * ky * kz)),
        ])
    return ehat, esum, vsum


def gather_plain(pm: PPPM, state: SlotState, e_mesh: torch.Tensor,
                 acc_dtype, box=None):
    """Per-slot ik forces (fx, fy, fz) in acc: the three flt E meshes
    (3, nx, ny, nz) interpolated at every slot, times q * qqrd2e; ``box``
    as in ``mesh_geometry``."""
    ns = state.x.shape[0]
    flat_e = e_mesh.reshape(3, -1)
    out = [torch.empty(ns, dtype=acc_dtype, device=state.x.device)
           for _ in range(3)]
    geo = mesh_geometry(pm, box)
    for s0 in range(0, ns, _CHUNK):
        s1 = min(ns, s0 + _CHUNK)
        flat, w3 = _stencil(pm, state, s0, s1, geo)
        for c in range(3):
            out[c][s0:s1] = (w3 * flat_e[c][flat]).to(acc_dtype).sum(
                (1, 2, 3))
    qf = (pm.qqrd2e * state.q).to(acc_dtype)
    return tuple(f * qf for f in out)


def _device_kind(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {t.device}")
    return "cpu"


def deposit(pm: PPPM, state: SlotState, n_atoms: int, consts: dict,
            box=None) -> torch.Tensor:
    """Charge mesh: the CUDA deposit kernel on CUDA planes, the plain
    version on CPU planes.  box: None (``pm``'s mesh) or (centre, boxL), a
    box on the card."""
    if _device_kind(state.x) == "cuda":
        from ...ops import pppm as pppm_ops

        return pppm_ops.deposit(pm, state, n_atoms, consts["coef"], box)
    return deposit_plain(pm, state, box)


def spectral(consts: dict, rhat: torch.Tensor, eflag: bool, vflag: bool):
    """Half-spectrum solve (see ``spectral_plain``)."""
    if _device_kind(rhat) == "cuda":
        from ...ops import pppm as pppm_ops

        return pppm_ops.spectral(consts, rhat, eflag or vflag)
    return spectral_plain(consts, rhat, eflag, vflag)


def gather(pm: PPPM, state: SlotState, e_mesh: torch.Tensor, n_atoms: int,
           acc_dtype, consts: dict, box=None):
    """Per-slot ik forces (see ``gather_plain``; ``box`` as in
    ``deposit``)."""
    if _device_kind(state.x) == "cuda":
        from ...ops import pppm as pppm_ops

        return pppm_ops.gather(pm, state, e_mesh, n_atoms, acc_dtype,
                               consts["coef"], box)
    return gather_plain(pm, state, e_mesh, acc_dtype, box)


class CellPPPM:
    """PPPM on the slot planes of ``n_atoms`` atoms; plugs into
    ``CellPairSimulation``.

    ``compute_slots(state, eflag, vflag) -> (fx, fy, fz, elong, virial)``
    in the acc dtype and slot order.  The JAX ``CellPPPM`` is bound to a
    cell grid (its transfer engines work per cell patch) and is rebound
    when the capacity grows; the global-mesh kernels need only the atom
    count, which a grow leaves alone, and wrap every mesh index, so drift
    needs no skin margin.  The Green's function, wave vectors and spline
    table go to the device once per (device, dtype).
    """

    def __init__(self, pm: PPPM, n_atoms: int):
        self.pm = pm
        self.n_atoms = int(n_atoms)
        self._consts = {}

    def consts(self, device, flt, acc) -> dict:
        """Device constants of the mesh: G and the wave vectors on the
        half spectrum, wz, the virial prefactor (acc), the spline piece
        table (flt)."""
        key = (torch.device(device), flt, acc)
        c = self._consts.get(key)
        if c is not None:
            return c
        pm = self.pm
        nzh = pm.grid[2] // 2 + 1

        def up(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device, dt)

        kx, ky, kz = (up(k, acc) for k in pm.k3(nzh))
        ksq = kx * kx + ky * ky + kz * kz
        ksq_safe = torch.where(ksq == 0.0, torch.ones_like(ksq), ksq)
        c = dict(
            G=up(pm.greensfn[..., :nzh], acc), k3=(kx, ky, kz),
            wz=up(half_weights(pm.grid[2]), acc)[None, None, :],
            pref=2.0 * (1.0 / ksq_safe + 0.25 / pm.g_ewald**2),
            g_ewald=float(pm.g_ewald),
            coef=up(spline_table(pm.order), flt).view(-1))
        self._consts[key] = c
        return c

    def compute_slots(self, state: SlotState, eflag: bool, vflag: bool):
        pm = self.pm
        acc = pm.acc_dtype
        flt = state.x.dtype
        n = self.n_atoms
        consts = self.consts(state.x.device, flt, acc)
        V = float(pm.volume)
        ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]

        mesh = deposit(pm, state, n, consts)
        # cuFFT may hand back permuted strides; the kernels take dense
        # row-major meshes (a copy only where the layout differs)
        rhat = torch.fft.rfftn(mesh.to(acc)).contiguous()
        ehat, esum, vsum = spectral(consts, rhat, eflag, vflag)
        qqrd2e = float(pm.qqrd2e)
        zero = torch.zeros((), dtype=acc, device=state.x.device)
        elong = ((0.5 / V) * esum * qqrd2e + pm.elong_self) if eflag \
            else zero
        virial = (vsum * ((0.5 / V) * qqrd2e) if vflag
                  else torch.zeros(6, dtype=acc, device=state.x.device))
        e_mesh = (torch.fft.irfftn(ehat, s=pm.grid, dim=(1, 2, 3))
                  * ((1.0 / V) * ngrid)).to(flt).contiguous()
        fx, fy, fz = gather(pm, state, e_mesh, n, acc, consts)
        return fx, fy, fz, elong, virial
