"""PPPM on the cell-slot layout: deposit, spectral solve, ik gather.

Counterpart of ``lammps_buck_intel_tpu.models.kspace.pppm_cells.CellPPPM``
(ik differentiation, Coulomb).  The JAX package moves charge between
slots and mesh through per-cell spline patches and one-hot matrix
products ("zblock", "columns", "patches"): forms that keep a TPU's
matrix unit busy and avoid scatters.  The port's gather, and its deposit
in atom order, work on the global periodic mesh, the generic form of the
JAX package's ``pppm.deposit_rho`` and ik gather with the
piecewise-Horner weights: every slot puts q * wx * wy * wz on the
order^3 mesh points around it, each index wrapped periodically, so
positions that drifted up to skin/2 out of the box or out of their cell
need no margin.  The mesh stays aligned to the coarse cell grid
(``run.py`` picks it) so both packages solve on the same mesh; the slot
deposit uses that alignment as the JAX patches do (K5 by cell: one
shared-memory brick a cell, margins from the skin, ``cell_bricks``).

Index convention (the JAX ``bspline_weights``): u = (x - lo) / h per
axis, base = round(u) for odd order (floor for even), and mesh point
base + o, o in ``stencil_offsets(order)``, gets M_p(u - (base + o) +
p/2).  The patch form of ``_axis_weights`` evaluates the same M_p at the
same argument on the same mesh point (its patch index plus patch_lo).

The same stages serve the neighbor-list engines in atom order
(``solve_atoms``: aid the identity, the generic mesh, the full-spectrum
conventions at the Nyquist planes), for the static ``PPPM.compute`` and
the variable-cell ``TracedPPPM.compute_traced``.

With ad differentiation (``diff="ad"``) the spectral stage writes one
potential spectrum (K10 ad spectral, ``spectral(..., ad=True)``), one
irfftn gives the potential mesh, and the gather interpolates it with the
derivative weights of each axis in turn, less the self force
(``gather_ad``, K10 ad gather); in atom order, over the cell engine's
slots (``CellPPPM``, the JAX half-spectrum sums) and with the box on the
card alike.  ``slab_correct`` / ``slab_peratom`` dispatch K10 slab.

Three stages, each a CUDA kernel on CUDA tensors (``ops.pppm``) and the
plain torch version below on CPU tensors:
  * ``deposit``: slot planes -> (nx, ny, nz) charge mesh in flt; on the
    cell engine's slots (``bricks`` from ``cell_bricks``: the mesh a whole
    multiple of the coarse cells) K5 by cell, each cell's charges summed
    in a shared-memory brick of the mesh and the brick added once, else
    K5 in slot or atom order, every weight a global atomic;
  * ``spectral``: rfftn(mesh) (cuFFT through torch.fft, outside the
    kernel) -> the three ik spectra -i k_a G rho_hat, and with eflag /
    vflag elong and the 6-virial over the half spectrum;
  * ``gather``: one batched irfftn of the spectra -> E meshes, then the
    field at every slot times q * qqrd2e, in acc.

``CellPPPMDisp`` runs the geometric dispersion solve (``pppm_disp``)
through the same deposit and gather, with the dispersion charge B[type]
of each slot in place of q and the dispersion spectral kernel (K12a) in
place of the Coulomb one.

Per slot (``compute_peratom_slots``, K18 slots: the JAX
``CellPPPM.compute_peratom_slots`` and ``_peratom_disp_slots``), each
solver's energy and 6-virial shares in slot order, exactly 0 on empty
slots: the slot deposit, one rfftn, the per-atom spectra (K10pa's, or
K12pa's with one channel), one batched irfftn, and the per-atom gather
over the slots with their aid plane (K10pa's or K12pa's kernel in its slot
form).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...neighbor.cell_slots import SlotState
from .pppm import (PPPM, bspline_weights, dspline_table, spline_table,
                   stencil_offsets)

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


def slab_factors(pm: PPPM):
    """(1, 1, slab) per axis: the factors of the k-space box over the
    atoms' box (all 1 without ``kspace_modify slab``)."""
    return (1.0, 1.0, 1.0 if pm.slab is None else float(pm.slab))


class Bricks(NamedTuple):
    """The bricks of K5 by cell, per axis: ``nc`` coarse cells, the
    brick's first mesh point ``off`` less its cell's first (c * n / nc),
    and its ``w`` points."""
    nc: tuple
    off: tuple
    w: tuple


# the largest brick, in bytes (csrc/pppm.cu kMaxBrickBytes: a block's 48 KB
# of shared memory without opting in to more, less its static arrays)
BRICK_BYTES = 47 * 1024


def cell_bricks(mesh, nc, skin: float):
    """The ``Bricks`` of the mesh of ``mesh`` (its ``grid``, ``h`` and
    ``order``) on the coarse cells ``nc`` of a slot grid whose atoms drift
    up to skin/2 from their cell between rebins; None where an axis of the
    mesh is not a whole multiple of its cells.  A cell's stencil bases
    span its m = n / nc points widened by the drift d = skin / 2h on each
    side: rint (odd order) reaches at most floor(d + 1/2) below and one
    more above, floor (even order) ceil(d) below and floor(d) + 1 above;
    the brick adds the order - 1 points of the stencil."""
    p = int(mesh.order)
    first = -(p - 1) // 2 if p % 2 else -(p // 2 - 1)
    off, w = [], []
    for n, c, h in zip(mesh.grid, nc, mesh.h):
        if n % c:
            return None
        d = 0.5 * skin / float(h)
        if p % 2:
            below = int(np.floor(d + 0.5))
            above = below + 1
        else:
            below, above = int(np.ceil(d)), int(np.floor(d)) + 1
        off.append(first - below)
        w.append(n // c + below + above + p - 1)
    return Bricks(tuple(int(c) for c in nc), tuple(off), tuple(w))


def takes_bricks(bricks, ns: int, itemsize: int) -> bool:
    """Whether ``ns`` slot entries of ``itemsize`` bytes go through K5 by
    cell: a slot grid's bricks were given, the entries are whole cells of
    it (cap = ns / cells, read at each call: a capacity grow changes
    it), and one brick fits in a block's shared memory."""
    if bricks is None:
        return False
    ncell = int(np.prod(bricks.nc))
    return (ns > 0 and ns % ncell == 0
            and int(np.prod(bricks.w)) * itemsize <= BRICK_BYTES)


def mesh_geometry(pm: PPPM, box=None):
    """(lo, 1/h) per axis of the mesh: ``pm``'s (host floats, 1/h by an
    f64 reciprocal), or for box = (centre, boxL) a box on the card (the
    variable cell) lo = centre - L / 2 and 1/h = n / (L f), f the slab
    factors (``slab_factors``), in boxL's dtype, the JAX package's
    TracedPPPM._weights order, as the kernels take it."""
    if box is None:
        return pm.box_lo, [1.0 / h for h in pm.h]
    center, boxL = box
    lo = torch.as_tensor(np.asarray(center, np.float64)).to(boxL) \
        - 0.5 * boxL
    f = torch.as_tensor(np.asarray(slab_factors(pm))).to(boxL)
    ih = torch.as_tensor(np.asarray(pm.grid, np.float64)).to(boxL) \
        / (boxL * f)
    return lo, ih


def axis_weights(pm: PPPM, plane: torch.Tensor, ax: int, geo,
                 deriv: bool = False):
    """(base (M,) int64, w (M, order)) of positions ``plane`` on mesh
    axis ``ax`` of the geometry ``geo`` (``mesh_geometry``), in the plane's
    dtype (the JAX ``bspline_weights`` with ``mspline_horner``); with
    ``deriv`` also dw/du."""
    lo, ih = geo
    return bspline_weights((plane - lo[ax]) * ih[ax], pm.order, deriv)


def _outer3(a, b, c):
    return a[:, :, None, None] * b[:, None, :, None] * c[:, None, None, :]


def _stencil(pm: PPPM, state: SlotState, s0: int, s1: int, geo,
             deriv: bool = False):
    """Flat wrapped mesh indices (M, p, p, p) and weights w3 (M, p, p, p)
    of slots [s0, s1); with ``deriv`` the per-axis weights and derivative
    weights ((wx, wy, wz), (dwx, dwy, dwz)) in place of w3."""
    nx, ny, nz = pm.grid
    offs = torch.as_tensor(stencil_offsets(pm.order), device=state.x.device)
    idx, ws, dws = [], [], []
    planes = (state.x, state.y, state.z)
    for ax, (plane, n) in enumerate(zip(planes, pm.grid)):
        base, *w = axis_weights(pm, plane[s0:s1], ax, geo, deriv)
        idx.append(torch.remainder(base[:, None] + offs, n))
        ws.append(w[0])
        if deriv:
            dws.append(w[1])
    flat = ((idx[0][:, :, None, None] * ny + idx[1][:, None, :, None]) * nz
            + idx[2][:, None, None, :])
    if deriv:
        return flat, (ws, dws)
    return flat, _outer3(*ws)


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
                   vflag: bool, ad: bool = False):
    """Half-spectrum solve: (ehat (3, nx, ny, nzh) complex, esum, vsum)
    with esum = sum(ek) and vsum the six sums of ek (delta_ab - pref k_a
    k_b), ek = G |rho_hat|^2 wz (zeros without eflag / vflag).  With
    ``ad`` (K10 ad spectral) the one potential spectrum phi_hat = G rho_hat
    (nx, ny, nzh) in place of ehat, the sums the same.

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
    ehat = phi if ad else torch.stack(
        [torch.complex(k * phi.imag, -(k * phi.real)) for k in ke])
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


def gather_ad_plain(pm: PPPM, state: SlotState, u_mesh: torch.Tensor,
                    acc_dtype, sf: torch.Tensor, box=None):
    """Per-slot ad forces (fx, fy, fz) in acc (K10 ad gather, the JAX
    ``_pppm_compute_ad`` gather and ``CellPPPM`` ad): the potential mesh
    (nx, ny, nz) interpolated with the derivative weight of each axis in
    turn, f_a = -q qqrd2e sum (dw_a w w) u / h_a, less the self force q^2
    qqrd2e sum_j sf[a, j] sin(2 pi (j + 1) u_a) (``sf`` (3, J) in acc;
    ``box`` as in ``mesh_geometry``).  Empty slots carry q = 0, which
    gives 0."""
    ns = state.x.shape[0]
    flat_u = u_mesh.reshape(-1)
    out = [torch.empty(ns, dtype=acc_dtype, device=state.x.device)
           for _ in range(3)]
    geo = mesh_geometry(pm, box)
    ih = geo[1]
    for s0 in range(0, ns, _CHUNK):
        s1 = min(ns, s0 + _CHUNK)
        flat, (w, dw) = _stencil(pm, state, s0, s1, geo, deriv=True)
        uv = flat_u[flat]
        for a in range(3):
            f3 = [dw[b] if b == a else w[b] for b in range(3)]
            e = (_outer3(*f3) * uv).to(acc_dtype).sum((1, 2, 3))
            out[a][s0:s1] = -(e * ih[a])
    from .pppm import sf_axis_series

    q = state.q
    qf = (pm.qqrd2e * q).to(acc_dtype)
    q2 = (pm.qqrd2e * q * q).to(acc_dtype)
    planes = (state.x, state.y, state.z)
    return tuple(out[a] * qf - q2 * sf_axis_series(pm, planes[a], a, sf,
                                                    geo).to(acc_dtype)
                 for a in range(3))


def _device_kind(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {t.device}")
    return "cpu"


def deposit(pm: PPPM, state: SlotState, n_atoms: int, consts: dict,
            box=None, bricks=None) -> torch.Tensor:
    """Charge mesh: on CUDA planes K5 by cell where ``takes_bricks``
    (``bricks``: the slot grid's, from ``cell_bricks``; never with a box
    on the card), else K5 in slot or atom order; the plain version on CPU
    planes.  box: None (``pm``'s mesh) or (centre, boxL), a box on the
    card."""
    if _device_kind(state.x) == "cuda":
        from ...ops import pppm as pppm_ops

        if box is None and takes_bricks(bricks, state.x.shape[0],
                                        state.x.element_size()):
            return pppm_ops.deposit_cells(pm, state, n_atoms,
                                          consts["coef"], bricks)
        return pppm_ops.deposit(pm, state, n_atoms, consts["coef"], box)
    return deposit_plain(pm, state, box)


def spectral(consts: dict, rhat: torch.Tensor, eflag: bool, vflag: bool,
             ad: bool = False):
    """Half-spectrum solve (see ``spectral_plain``): K7, or with ``ad``
    K10 ad spectral, on CUDA spectra."""
    if _device_kind(rhat) == "cuda":
        from ...ops import pppm as pppm_ops

        return pppm_ops.spectral(consts, rhat, eflag or vflag, ad)
    return spectral_plain(consts, rhat, eflag, vflag, ad)


def gather(pm: PPPM, state: SlotState, e_mesh: torch.Tensor, n_atoms: int,
           acc_dtype, consts: dict, box=None):
    """Per-slot ik forces (see ``gather_plain``; ``box`` as in
    ``deposit``)."""
    if _device_kind(state.x) == "cuda":
        from ...ops import pppm as pppm_ops

        return pppm_ops.gather(pm, state, e_mesh, n_atoms, acc_dtype,
                               consts["coef"], box)
    return gather_plain(pm, state, e_mesh, acc_dtype, box)


def gather_ad(pm: PPPM, state: SlotState, u_mesh: torch.Tensor,
              n_atoms: int, acc_dtype, consts: dict, sf: torch.Tensor,
              box=None):
    """Per-slot ad forces (see ``gather_ad_plain``): the K10 ad gather on
    CUDA planes (consts: ``coef`` and ``dcoef``, the flt piece tables)."""
    if _device_kind(state.x) == "cuda":
        from ...ops import pppm as pppm_ops

        return pppm_ops.gather_ad(pm, state, u_mesh, n_atoms, acc_dtype,
                                  consts["coef"], consts["dcoef"], sf, box)
    return gather_ad_plain(pm, state, u_mesh, acc_dtype, sf, box)


def slab_correct(pm: PPPM, z: torch.Tensor, q: torch.Tensor,
                 fz: torch.Tensor, eflag: bool, boxL=None) -> torch.Tensor:
    """The slab term (``pppm.slab_correction_plain``): adds fz_i to the acc
    plane ``fz`` in place and returns e_slab (0-d acc; 0 without eflag).
    boxL: the atoms' box lengths on the card (a variable cell; the
    extended volume and z length follow from it and ``pm.slab``), else
    ``pm``'s.  K10 slab on CUDA planes, the plain version on CPU ones."""
    if _device_kind(z) == "cuda":
        from ...ops import pppm as pppm_ops

        return pppm_ops.slab(pm, z, q, fz, eflag, boxL)
    from .pppm import slab_correction_plain

    V = zprd = None
    if boxL is not None:
        L = boxL.to(pm.acc_dtype) * torch.as_tensor(
            np.asarray(slab_factors(pm))).to(boxL.device, pm.acc_dtype)
        V, zprd = L[0] * L[1] * L[2], L[2]
    e, f = slab_correction_plain(pm, z, q, eflag, V, zprd)
    fz.add_(f)
    return e


def slab_peratom(pm: PPPM, z: torch.Tensor, q: torch.Tensor,
                 eatom: torch.Tensor) -> torch.Tensor:
    """eatom plus each atom's share of the slab energy
    (``pppm.slab_peratom_plain``): K10 slab's per-atom form on CUDA planes
    (in place), the plain version on CPU ones."""
    if _device_kind(z) == "cuda":
        from ...ops import pppm as pppm_ops

        pppm_ops.slab_peratom(pm, z, q, eatom)
        return eatom
    from .pppm import slab_peratom_plain

    return eatom + slab_peratom_plain(pm, z, q)


class AtomPlanes(NamedTuple):
    """Atom-order planes in the shape the PPPM stages read (aid is the
    identity, so every atom counts; the plain versions do not read it)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    q: torch.Tensor
    aid: torch.Tensor


def solve_atoms(pm: PPPM, x: torch.Tensor, q: torch.Tensor, consts: dict,
                G_half: torch.Tensor, k3, V, box, eflag: bool, vflag: bool,
                sf=None):
    """The atom-order pipeline of the neighbor-list engines: deposit,
    rfftn, the half-spectrum solve with the full-spectrum conventions at
    the Nyquist planes (``nyquist``), then by ``pm.diff`` either ik (three
    spectra, one batched irfftn, the gather) or ad (one potential spectrum,
    one irfftn, the derivative-weight gather less the self force).
    Returns ((fx, fy, fz) acc, ek, virial): ek = (0.5 / V) sum G
    |rho_hat|^2 qqrd2e (None without eflag; elong less the self and
    background terms), the 6-virial (zeros without eflag or vflag), equal
    to the JAX package's full-spectrum sums.

    x: (3, N) positions, q (N,) charges; consts: ``coef`` (the flt spline
    table), ``wz`` (acc half weights), with ad ``dcoef`` (the flt
    derivative table), and an ``aid`` identity plane kept there; G_half:
    the (nx, ny, nz // 2 + 1) acc influence function; k3: the wave vectors
    on the half spectrum; V: the volume (a float or a 0-d acc tensor);
    box: None (the mesh of ``pm``: box_lo, h) or (centre, boxL) for a box
    on the card; sf: the ad self-force series (3, J) in acc."""
    acc, flt, dev = pm.acc_dtype, x.dtype, x.device
    n = x.shape[1]
    aid = consts.get("aid")
    if aid is None or aid.shape[0] != n:
        aid = consts["aid"] = torch.arange(n, dtype=torch.int32, device=dev)
    planes = AtomPlanes(x[0], x[1], x[2], q, aid)
    nx, ny, nz = pm.grid
    g = float(pm.g_ewald)
    ad = pm.diff == "ad"

    mesh = deposit(pm, planes, n, consts, box)
    rhat = torch.fft.rfftn(mesh.to(acc)).contiguous()
    sc = dict(G=G_half, k3=k3, wz=consts["wz"], g_ewald=g, nyquist=True)
    if not x.is_cuda:
        ksq = k3[0] * k3[0] + k3[1] * k3[1] + k3[2] * k3[2]
        ksq_safe = torch.where(ksq == 0.0, torch.ones_like(ksq), ksq)
        sc["pref"] = 2.0 * (1.0 / ksq_safe + 0.25 / g ** 2)
    spec, esum, vsum = spectral(sc, rhat, eflag, vflag, ad)
    qqrd2e = float(pm.qqrd2e)
    ek = (0.5 / V) * esum * qqrd2e if eflag else None
    virial = vsum * ((0.5 / V) * qqrd2e)
    if ad:
        u = (torch.fft.irfftn(spec, s=pm.grid) * ((nx * ny * nz) / V)
             ).to(flt).contiguous()
        f = gather_ad(pm, planes, u, n, acc, consts, sf, box)
    else:
        e_mesh = (torch.fft.irfftn(spec, s=pm.grid, dim=(1, 2, 3))
                  * ((1.0 / V) * (nx * ny * nz))).to(flt).contiguous()
        f = gather(pm, planes, e_mesh, n, acc, consts, box)
    return f, ek, virial


class CellPPPM:
    """PPPM on the slot planes of ``n_atoms`` atoms; plugs into
    ``CellPairSimulation``.

    ``compute_slots(state, eflag, vflag) -> (fx, fy, fz, elong, virial)``
    in the acc dtype and slot order.  The JAX ``CellPPPM`` is bound to a
    cell grid (its transfer engines work per cell patch) and is rebound
    when the capacity grows; the global-mesh kernels need only the atom
    count, which a grow leaves alone, and wrap every mesh index, so drift
    needs no skin margin.  ``bricks`` (``cell_bricks`` of the engine's
    coarse cells, or None) sends the slot deposit through K5 by cell.  The
    Green's function, wave vectors and spline table go to the device once
    per (device, dtype).
    """

    def __init__(self, pm: PPPM, n_atoms: int, bricks=None):
        self.pm = pm
        self.n_atoms = int(n_atoms)
        self.bricks = bricks
        self._consts = {}

    def consts(self, device, flt, acc) -> dict:
        """Device constants of the mesh: G and the wave vectors on the
        half spectrum, wz, the virial prefactor (acc), the spline piece
        table (flt); with ad the derivative piece table (flt) and the
        self-force series sf (acc)."""
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
        if pm.diff == "ad":
            c["dcoef"] = up(dspline_table(pm.order), flt).view(-1)
            c["sf"] = up(pm.sf_sine, acc)
        self._consts[key] = c
        return c

    def compute_slots(self, state: SlotState, eflag: bool, vflag: bool):
        """(fx, fy, fz, elong, virial) in acc and slot order.  ik: the
        spectral kernel's three spectra, one batched irfftn, the ik gather.
        ad (the JAX ``CellPPPM`` ad, pppm_cells.py:936-995): K10 ad
        spectral on the half spectrum (the JAX half-spectrum sums, no
        Nyquist conventions), one irfftn, the K10 ad gather over the slots
        with their aid (empty slots 0), the self force subtracted there."""
        pm = self.pm
        acc = pm.acc_dtype
        flt = state.x.dtype
        n = self.n_atoms
        consts = self.consts(state.x.device, flt, acc)
        V = float(pm.volume)
        ngrid = pm.grid[0] * pm.grid[1] * pm.grid[2]

        mesh = deposit(pm, state, n, consts, bricks=self.bricks)
        # cuFFT may hand back permuted strides; the kernels take dense
        # row-major meshes (a copy only where the layout differs)
        rhat = torch.fft.rfftn(mesh.to(acc)).contiguous()
        ad = pm.diff == "ad"
        spec, esum, vsum = spectral(consts, rhat, eflag, vflag, ad)
        qqrd2e = float(pm.qqrd2e)
        zero = torch.zeros((), dtype=acc, device=state.x.device)
        elong = ((0.5 / V) * esum * qqrd2e + pm.elong_self) if eflag \
            else zero
        virial = (vsum * ((0.5 / V) * qqrd2e) if vflag
                  else torch.zeros(6, dtype=acc, device=state.x.device))
        if ad:
            u = (torch.fft.irfftn(spec, s=pm.grid) * ((1.0 / V) * ngrid)
                 ).to(flt).contiguous()
            fx, fy, fz = gather_ad(pm, state, u, n, acc, consts,
                                   consts["sf"])
        else:
            e_mesh = (torch.fft.irfftn(spec, s=pm.grid, dim=(1, 2, 3))
                      * ((1.0 / V) * ngrid)).to(flt).contiguous()
            fx, fy, fz = gather(pm, state, e_mesh, n, acc, consts)
        return fx, fy, fz, elong, virial

    def compute_peratom_slots(self, state: SlotState, plain: bool = False):
        """Per-slot k-space (eatom (NS,), vatom (NS, 6)) in acc, 0 on empty
        slots (the JAX ``compute_peratom_slots``, pppm_intel.cpp:224-252):
        the slot deposit (K5), rfftn, the K10pa spectra, one batched
        irfftn, the K10pa gather over the slots (K18 slots); ``plain``:
        every stage's plain version on any device.  The shares sum to
        ``compute_slots``' elong and virial: both are half-spectrum sums,
        so the spectra keep the off-diagonal products at the Nyquist
        planes (the JAX numbers; ``pppm.compute_peratom``'s full-spectrum
        rule would miss this solver's virial)."""
        from .pppm import (peratom_gather, peratom_gather_plain,
                           peratom_spectral, peratom_spectral_plain)

        pm = self.pm
        c = pm.consts(state.x.device, state.x.dtype)
        mesh = (deposit_plain(pm, state) if plain
                else deposit(pm, state, self.n_atoms, c,
                             bricks=self.bricks))
        rhat = torch.fft.rfftn(mesh.to(pm.acc_dtype)).contiguous()
        spectra = (peratom_spectral_plain if plain else peratom_spectral)(
            pm, c, rhat, False)
        meshes = torch.fft.irfftn(spectra, s=pm.grid,
                                  dim=(1, 2, 3)).contiguous()
        if plain:
            # empty slots carry q = 0, which gives 0
            nx, ny, nz = pm.grid
            return peratom_gather_plain(pm, state, meshes,
                                        (nx * ny * nz) / float(pm.volume))
        return peratom_gather(pm, state, meshes, c, self.n_atoms)


class CellPPPMDisp:
    """Geometric-mix dispersion PPPM on the slot planes; plugs into
    ``CellPairSimulation`` like ``CellPPPM``.

    Counterpart of ``lammps_buck_intel_tpu.models.kspace.pppm_cells
    .CellPPPMDisp`` (the reference's ``function[1]`` pipeline,
    pppm_disp_intel.cpp:245-313): one channel a = B[type] per slot (zero on
    empty slots) deposited on the cell-aligned dispersion mesh (K5 with a
    as the charge), rfftn, the dispersion solve on the half spectrum
    (K12a, ``csrc/pppm_disp.cu``: ik spectra, energy and the vfac
    virial), irfftn, the ik gather scaled by a (K8).  The k = 0 and self
    terms (``PPPMDisp.elong_const``) are host scalars of the atoms'
    composition.  Only the geometric mix has one channel: other mixes
    raise, as the JAX class does (its C8 guard); the deck runner gives
    their decks the generic solvers (``base.BoundKSpace``) instead.
    ``bricks`` as in ``CellPPPM``, on the dispersion mesh."""

    def __init__(self, pmd, n_atoms: int, typ, bricks=None):
        if pmd.mix != "geometric":
            raise NotImplementedError(
                f"CellPPPMDisp: mix {pmd.mix!r} (geometric single-channel "
                "only; the other mixes run the generic channel solver, "
                "base.BoundKSpace)")
        self.pmd = pmd
        self.pm = pmd.shim()
        self.n_atoms = int(n_atoms)
        self.bricks = bricks
        b = np.asarray(pmd.B, np.float64)[np.asarray(typ)]
        bsum, b2sum = float(b.sum()), float((b * b).sum())
        self.elong_const = pmd.elong_const(bsum, b2sum)
        # the k = 0 term (also the virial's diagonal) and the self term
        self._e0 = (0.5 / float(pmd.volume)) * pmd.w0 * bsum * bsum
        self._e_self = pmd.g_ewald_6 ** 6 / 12.0 * b2sum
        self._bsum = bsum
        self._B = {}

    def _b_table(self, device, flt) -> torch.Tensor:
        """B per type in flt on ``device``, uploaded once."""
        key = (device, flt)
        B = self._B.get(key)
        if B is None:
            B = self._B[key] = torch.as_tensor(
                np.asarray(self.pmd.B, np.float64)).to(device, flt)
        return B

    def compute_peratom(self, x: torch.Tensor, typ: torch.Tensor):
        """Per-atom (eatom (N,), vatom (N, 6)) at the (3, N) atom positions
        x on the cell-aligned mesh: one channel b = B[type] in x's dtype
        (the JAX computes.py:138-145 binding)."""
        b = torch.index_select(self._b_table(x.device, x.dtype), 0,
                               typ.to(x.device))
        return self.pmd.compute_peratom(x, b_per_atom=b)

    def _slot_b(self, state: SlotState) -> torch.Tensor:
        """a = B[typ] per slot in flt, 0 on empty slots."""
        B = self._b_table(state.x.device, state.x.dtype)
        b = torch.index_select(B, 0, state.typ)
        return torch.where(state.aid < self.n_atoms, b, torch.zeros_like(b))

    def compute_slots(self, state: SlotState, eflag: bool, vflag: bool):
        from .pppm_disp import disp_finish, disp_spectral

        pmd = self.pmd
        acc = pmd.acc_dtype
        flt = state.x.dtype
        n = self.n_atoms
        c = pmd.consts(state.x.device, flt)
        st = state._replace(q=self._slot_b(state))
        mesh = deposit(self.pm, st, n, c, bricks=self.bricks)
        S = torch.fft.rfftn(mesh.to(acc)).contiguous()
        ehat, esum, vsum = disp_spectral(c, S[None], pmd.P, eflag or vflag)
        elong, virial = disp_finish(pmd, esum, vsum, self._e0, self._e_self,
                                    eflag, vflag)
        ngrid = pmd.grid[0] * pmd.grid[1] * pmd.grid[2]
        e_mesh = (torch.fft.irfftn(ehat[0], s=pmd.grid, dim=(1, 2, 3))
                  * ((1.0 / float(pmd.volume)) * ngrid)).to(flt).contiguous()
        fx, fy, fz = gather(self.pm, st, e_mesh, n, acc, c)
        return fx, fy, fz, elong, virial

    def compute_peratom_slots(self, state: SlotState, plain: bool = False):
        """Per-slot dispersion k-space (eatom (NS,), vatom (NS, 6)) in acc,
        0 on empty slots (the JAX ``_peratom_disp_slots``, the per-atom
        corrections of pppm_disp_intel.cpp:512-537): b = B[type] deposited
        by the slot deposit (K5), rfftn, the K12pa spectra of the one
        channel, one batched irfftn, the K12pa gather over the slots with
        the k = 0 share (w0 / 2V) b bsum and the self term g6^6 / 12 b^2
        (K18 slots); ``plain``: every stage's plain version on any device.
        The shares sum to ``compute_slots``' elong and virial."""
        from .pppm_disp import (disp_peratom_gather,
                                disp_peratom_gather_plain,
                                disp_peratom_spectral,
                                disp_peratom_spectral_plain, peratom_terms)

        pmd = self.pmd
        acc, flt, dev = pmd.acc_dtype, state.x.dtype, state.x.device
        c = pmd.consts(dev, flt)
        b = self._slot_b(state)
        st = state._replace(q=b)
        mesh = (deposit_plain(self.pm, st) if plain
                else deposit(self.pm, st, self.n_atoms, c,
                             bricks=self.bricks))
        S = torch.fft.rfftn(mesh.to(acc)).contiguous()[None]
        spectra = (disp_peratom_spectral_plain if plain
                   else disp_peratom_spectral)(c, S, pmd.P)
        meshes = torch.fft.irfftn(spectra, s=pmd.grid,
                                  dim=(2, 3, 4)).contiguous()
        ngrid = pmd.grid[0] * pmd.grid[1] * pmd.grid[2]
        scale = ngrid / float(pmd.volume)
        terms = peratom_terms(pmd, pmd.P, torch.full(
            (1,), self._bsum, dtype=acc, device=dev))
        x = torch.stack([state.x, state.y, state.z])
        if plain:
            return disp_peratom_gather_plain(self.pm, x, b[None], meshes,
                                             scale, *terms)
        table = self._b_table(dev, flt)[None, :]
        return disp_peratom_gather(self.pm, x, state.typ, table, meshes,
                                   c["coef"], scale, terms, state.aid,
                                   self.n_atoms)
