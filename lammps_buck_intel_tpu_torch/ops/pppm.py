"""Launch wrappers of the PPPM kernels (csrc/pppm.cu).

``deposit_cells`` is K5 by cell, the deposit of the cell engine's slots
through a shared-memory brick of the mesh a cell; ``deposit`` is K5 in
slot or atom order.  The plain versions of the same functions are
``deposit_plain`` (of both deposits),
``spectral_plain`` (with ``ad`` for K10 ad spectral), ``gather_plain`` and
``gather_ad_plain`` (K10 ad gather) in ``models.kspace.pppm_cells``, and
``peratom_spectral_plain``, ``peratom_gather_plain`` (K10pa, the per-atom
energy and virial; in slot order K18 slots), ``slab_correction_plain``
and ``slab_peratom_plain`` (K10 slab) in ``models.kspace.pppm``.  The FFTs
around the spectral kernels stay ``torch.fft`` (cuFFT) calls in
``CellPPPM.compute_slots`` and ``pppm.compute_peratom``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES
from . import build
from .cellpair import check_plane
from ..utils import trace

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_FLT = {torch.float32: 0, torch.float64: 1}
_PAIR = {(torch.float32, torch.float32): 0, (torch.float32, torch.float64): 1,
         (torch.float64, torch.float64): 2}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
# spectral grid: enough blocks to fill the card (this many per SM), a
# grid-stride loop beyond
_SPECTRAL_BLOCKS_PER_SM = 8


def _lib():
    lib = build.load("pppm")
    if lib.pppm_deposit.argtypes is None:
        slot_args = [_P] * 5 + [_I] * 2 + [_D] * 6 + [_I] * 4 + [_P, _P]
        lib.pppm_deposit.argtypes = [_I] + slot_args + [_P, _P]
        lib.pppm_deposit.restype = _I
        lib.pppm_deposit_cells.argtypes = ([_I] + slot_args[:-1]
                                           + [_I] * 9 + [_P] * 3)
        lib.pppm_deposit_cells.restype = _I
        lib.pppm_brick_bytes.argtypes = []
        lib.pppm_brick_bytes.restype = _I
        lib.pppm_gather.argtypes = ([_I] + slot_args
                                    + [_P, _D, _P, _P, _P, _P])
        lib.pppm_gather.restype = _I
        lib.pppm_spectral.argtypes = ([_I] * 3 + [_P] * 6 + [_I] * 3
                                      + [_D, _I, _P, _P, _I, _P])
        lib.pppm_spectral.restype = _I
        lib.pppm_threads.argtypes = []
        lib.pppm_threads.restype = _I
        lib.pppm_peratom_spectral.argtypes = ([_I] + [_P] * 6 + [_I] * 3
                                              + [_D, _I, _P, _I, _P])
        lib.pppm_peratom_spectral.restype = _I
        lib.pppm_peratom_gather.argtypes = ([_I] + [_P] * 5 + [_I] * 2
                                            + [_D] * 6 + [_I] * 4
                                            + [_P, _P] + [_D] * 5
                                            + [_P] * 3)
        lib.pppm_peratom_gather.restype = _I
        lib.pppm_gather_ad.argtypes = ([_I] + [_P] * 5 + [_I] * 2
                                       + [_D] * 6 + [_I] * 4 + [_P] * 4
                                       + [_D, _P, _I] + [_P] * 4)
        lib.pppm_gather_ad.restype = _I
        lib.pppm_slab_parts.argtypes = [_I, _I]
        lib.pppm_slab_parts.restype = _I
        lib.pppm_slab.argtypes = ([_I, _P, _P, _I] + [_D] * 4
                                  + [_P, _D] + [_P] * 4 + [_I, _P])
        lib.pppm_slab.restype = _I
    return lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _slot_args(pm, state, n_atoms: int, coef: torch.Tensor, box=None):
    """The slot-plane and mesh-geometry arguments shared by the deposit
    and the gather, after checking the planes.  box: None (the mesh of
    ``pm``: its box_lo and h), or (centre, boxL) for a box that lives on
    the card (boxL a (3,) tensor of the planes' dtype; the kernels derive
    lo and 1/h from it)."""
    dev = state.x.device
    if dev.type != "cuda":
        raise ValueError(f"pppm kernel needs CUDA tensors, got {dev}")
    flt = state.x.dtype
    if flt not in _FLT:
        raise TypeError(f"unsupported slot dtype {flt}")
    ns = state.x.shape[0]
    for name in ("x", "y", "z", "q"):
        check_plane(getattr(state, name), name, flt, ns, dev)
    check_plane(state.aid, "aid", torch.int32, ns, dev)
    p = pm.order
    check_plane(coef, "coef", flt, p * p, dev)
    if box is None:
        geo = [*(float(v) for v in pm.box_lo),
               *(1.0 / float(h) for h in pm.h)]
        box_ptr = None
    else:
        # the kernels take lo from the centre and 1/h = n / (L f) with f
        # the k-space box's factors (1, 1, slab) in the 1/h slots
        from ..models.kspace.pppm_cells import slab_factors

        center, boxL = box
        check_plane(boxL, "boxL", flt, 3, dev)
        geo = [*(float(v) for v in center), *slab_factors(pm)]
        box_ptr = boxL.data_ptr()
    return [state.x.data_ptr(), state.y.data_ptr(), state.z.data_ptr(),
            state.q.data_ptr(), state.aid.data_ptr(), ns, n_atoms, *geo,
            *pm.grid, p, coef.data_ptr(), box_ptr]


def deposit(pm, state, n_atoms: int, coef: torch.Tensor,
            box=None) -> torch.Tensor:
    """(nx, ny, nz) charge mesh in the slot dtype, on the card (``box`` as
    in ``_slot_args``)."""
    args = _slot_args(pm, state, n_atoms, coef, box)
    dev = state.x.device
    nx, ny, nz = pm.grid
    mesh = torch.zeros(nx * ny * nz, dtype=state.x.dtype, device=dev)
    rc = _lib().pppm_deposit(_FLT[state.x.dtype], *args, mesh.data_ptr(),
                             _stream(dev))
    if rc != 0:
        raise RuntimeError(f"pppm deposit launch failed: CUDA error {rc}")
    LAUNCHES["pppm_deposit"] += 1
    return mesh.view(nx, ny, nz)


def deposit_cells(pm, state, n_atoms: int, coef: torch.Tensor,
                  bricks) -> torch.Tensor:
    """K5 by cell: the (nx, ny, nz) charge mesh of slot planes grouped by
    the coarse cells of ``bricks`` (``pppm_cells.Bricks``; the caller has
    checked ``pppm_cells.takes_bricks``), each cell's charges summed in its
    brick in shared memory and the brick added to the mesh once.  While
    the tracer is on the kernel adds the charged slots it spread and those
    of them that spilled out of their brick to the device counters
    ``pppm.deposited`` and ``pppm.spilled``."""
    args = _slot_args(pm, state, n_atoms, coef)
    dev = state.x.device
    nx, ny, nz = pm.grid
    mesh = torch.zeros(nx * ny * nz, dtype=state.x.dtype, device=dev)
    counts = trace.device_counts("pppm", dev)
    # _slot_args ends with (coef, box): no box on the card here
    rc = _lib().pppm_deposit_cells(
        _FLT[state.x.dtype], *args[:-1], *bricks.nc, *bricks.off, *bricks.w,
        mesh.data_ptr(), None if counts is None else counts.data_ptr(),
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"pppm deposit_cells launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["pppm_deposit_cells"] += 1
    return mesh.view(nx, ny, nz)


def spectral(consts: dict, rhat: torch.Tensor, ev: bool, ad: bool = False):
    """(ehat (3, nx, ny, nzh) complex, esum, vsum (6,)) on the card; the
    sums are zeros without ``ev``.  consts["nyquist"] (default False):
    the full-spectrum conventions at the Nyquist planes (see
    ``pppm_cells.spectral_plain``).  ``ad``: K10 ad spectral, one potential
    spectrum phi_hat (nx, ny, nzh) in place of ehat, its own launch count
    (the plain version is ``spectral_plain(..., ad=True)``)."""
    ins, (nx, ny, nzh), nblocks = _spectral_inputs(consts, rhat, "G")
    acc, dev = ins[0].dtype, rhat.device
    ehat = torch.empty((nx, ny, nzh) if ad else (3, nx, ny, nzh),
                       dtype=rhat.dtype, device=dev)
    partial = (torch.empty((nblocks, 7), dtype=acc, device=dev) if ev
               else None)
    g = consts["g_ewald"]
    key = "pppm_ad_spectral" if ad else "pppm_spectral"
    rc = _lib().pppm_spectral(
        _FLT[acc], int(ev), int(ad), rhat.data_ptr(),
        *(t.data_ptr() for t in ins), nx, ny, nzh,
        0.25 / g**2, int(consts.get("nyquist", False)), ehat.data_ptr(),
        partial.data_ptr() if ev else None, nblocks, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{key} launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    if not ev:
        zero = torch.zeros(7, dtype=acc, device=dev)
        return ehat, zero[0], zero[1:]
    tot = partial.sum(0)
    return ehat, tot[0], tot[1:]


def gather(pm, state, e_mesh: torch.Tensor, n_atoms: int, acc_dtype,
           coef: torch.Tensor, box=None):
    """Per-slot ik forces (fx, fy, fz) in acc on the card (``box`` as in
    ``_slot_args``)."""
    args = _slot_args(pm, state, n_atoms, coef, box)
    dev = state.x.device
    flt = state.x.dtype
    prec = _PAIR.get((flt, acc_dtype))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc_dtype})")
    nx, ny, nz = pm.grid
    if not e_mesh.is_contiguous():
        raise ValueError("e_mesh is not contiguous")
    check_plane(e_mesh.view(-1), "e_mesh", flt, 3 * nx * ny * nz, dev)
    ns = state.x.shape[0]
    fx, fy, fz = (torch.empty(ns, dtype=acc_dtype, device=dev)
                  for _ in range(3))
    rc = _lib().pppm_gather(prec, *args, e_mesh.data_ptr(),
                            float(pm.qqrd2e), fx.data_ptr(), fy.data_ptr(),
                            fz.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"pppm gather launch failed: CUDA error {rc}")
    LAUNCHES["pppm_gather"] += 1
    return fx, fy, fz


def gather_ad(pm, state, u_mesh: torch.Tensor, n_atoms: int, acc_dtype,
              coef: torch.Tensor, dcoef: torch.Tensor, sf: torch.Tensor,
              box=None):
    """K10 ad gather: per-slot ad forces (fx, fy, fz) in acc on the card
    (``pppm_cells.gather_ad_plain``), from the flt potential mesh; sf the
    (3, J) acc self-force series; ``box`` as in ``_slot_args``."""
    args = _slot_args(pm, state, n_atoms, coef, box)
    dev = state.x.device
    flt = state.x.dtype
    prec = _PAIR.get((flt, acc_dtype))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc_dtype})")
    p = pm.order
    check_plane(dcoef, "dcoef", flt, p * p, dev)
    nx, ny, nz = pm.grid
    if not u_mesh.is_contiguous():
        raise ValueError("u_mesh is not contiguous")
    check_plane(u_mesh.view(-1), "u_mesh", flt, nx * ny * nz, dev)
    if sf.dim() != 2 or sf.shape[0] != 3 or not sf.is_contiguous():
        raise ValueError(f"sf has shape {tuple(sf.shape)}, expected (3, J)")
    check_plane(sf.view(-1), "sf", acc_dtype, sf.numel(), dev)
    ns = state.x.shape[0]
    fx, fy, fz = (torch.empty(ns, dtype=acc_dtype, device=dev)
                  for _ in range(3))
    # _slot_args ends with (coef, box); the kernel takes dcoef between them
    rc = _lib().pppm_gather_ad(
        prec, *args[:-1], dcoef.data_ptr(), args[-1], u_mesh.data_ptr(),
        float(pm.qqrd2e), sf.data_ptr(), int(sf.shape[1]), fx.data_ptr(),
        fy.data_ptr(), fz.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"pppm gather_ad launch failed: CUDA error {rc}")
    LAUNCHES["pppm_gather_ad"] += 1
    return fx, fy, fz


def _slab_launch(pm, z: torch.Tensor, q: torch.Tensor, fz, eatom, e_out,
                 boxL):
    dev, flt, acc = z.device, z.dtype, pm.acc_dtype
    if dev.type != "cuda":
        raise ValueError(f"pppm kernel needs CUDA tensors, got {dev}")
    prec = _PAIR.get((flt, acc))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc})")
    n = z.shape[0]
    check_plane(z, "z", flt, n, dev)
    check_plane(q, "q", flt, n, dev)
    for t, name in ((fz, "fz"), (eatom, "eatom")):
        if t is not None:
            check_plane(t, name, acc, n, dev)
    if boxL is not None:
        check_plane(boxL, "boxL", flt, 3, dev)
    lib = _lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nparts = lib.pppm_slab_parts(n, sms)
    partial = torch.empty((nparts, 2), dtype=acc, device=dev)
    rc = lib.pppm_slab(
        prec, z.data_ptr(), q.data_ptr(), n, float(pm.qsum),
        float(pm.qqrd2e), float(pm.volume), float(pm.h[2] * pm.grid[2]),
        None if boxL is None else boxL.data_ptr(), float(pm.slab),
        None if fz is None else fz.data_ptr(),
        None if eatom is None else eatom.data_ptr(),
        None if e_out is None else e_out.data_ptr(), partial.data_ptr(),
        nparts, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"pppm slab launch failed: CUDA error {rc}")
    LAUNCHES["pppm_slab"] += 1


def slab(pm, z: torch.Tensor, q: torch.Tensor, fz: torch.Tensor,
         eflag: bool, boxL=None) -> torch.Tensor:
    """K10 slab: adds the slab z force to the acc plane ``fz`` in place and
    returns e_slab (0-d acc, 0 without eflag) on the card
    (``pppm.slab_correction_plain``); boxL: the atoms' box on the card (the
    extended V and zprd follow with ``pm.slab``), else ``pm``'s."""
    e = torch.zeros(1, dtype=pm.acc_dtype, device=z.device)
    _slab_launch(pm, z, q, fz, None, e if eflag else None, boxL)
    return e[0]


def slab_peratom(pm, z: torch.Tensor, q: torch.Tensor, eatom: torch.Tensor):
    """K10 slab's per-atom form: adds each atom's share of the slab energy
    to the acc plane ``eatom`` in place (``pppm.slab_peratom_plain``)."""
    _slab_launch(pm, z, q, None, eatom, None, None)


def _spectral_inputs(consts: dict, rhat: torch.Tensor, G_key: str):
    """The half-spectrum inputs of a spectral kernel, checked: (G, kx, ky,
    kz, wz) flattened, the grid (nx, ny, nzh) and the block count."""
    G = consts[G_key]
    acc = G.dtype
    dev = rhat.device
    if dev.type != "cuda":
        raise ValueError(f"pppm kernel needs CUDA tensors, got {dev}")
    if acc not in _FLT or rhat.dtype != _COMPLEX[acc]:
        raise TypeError(f"spectral: rhat {rhat.dtype} with G {acc}")
    nx, ny, nzh = G.shape
    if tuple(rhat.shape) != (nx, ny, nzh) or not rhat.is_contiguous():
        raise ValueError(f"rhat has shape {tuple(rhat.shape)}, expected "
                         f"contiguous {(nx, ny, nzh)}")
    kx, ky, kz = (k.view(-1) for k in consts["k3"])
    wz = consts["wz"].view(-1)
    for name, t, size in (("G", G.view(-1), nx * ny * nzh), ("kx", kx, nx),
                          ("ky", ky, ny), ("kz", kz, nzh), ("wz", wz, nzh)):
        check_plane(t, name, acc, size, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblocks = min(_SPECTRAL_BLOCKS_PER_SM * sms,
                  -(-(nx * ny * nzh) // _lib().pppm_threads()))
    return (G, kx, ky, kz, wz), (nx, ny, nzh), nblocks


def peratom_spectral(pm, consts: dict, rhat: torch.Tensor,
                     nyquist: bool) -> torch.Tensor:
    """K10pa spectral: (7, nx, ny, nzh) complex on the card, phi_hat = G
    rho_hat and the six virial spectra (``pppm.peratom_spectral_plain``);
    consts: ``PPPM.consts`` (G_half, k3, wz)."""
    ins, (nx, ny, nzh), nblocks = _spectral_inputs(consts, rhat, "G_half")
    acc = ins[0].dtype
    out = torch.empty((7, nx, ny, nzh), dtype=rhat.dtype, device=rhat.device)
    g = float(pm.g_ewald)
    rc = _lib().pppm_peratom_spectral(
        _FLT[acc], rhat.data_ptr(), *(t.data_ptr() for t in ins), nx, ny,
        nzh, 0.25 / (g * g), int(nyquist), out.data_ptr(), nblocks,
        _stream(rhat.device))
    if rc != 0:
        raise RuntimeError(
            f"pppm peratom spectral launch failed: CUDA error {rc}")
    LAUNCHES["pppm_peratom_spectral"] += 1
    return out


def peratom_gather(pm, planes, meshes: torch.Tensor, coef: torch.Tensor,
                   scale: float, n_atoms=None):
    """K10pa gather: (eatom (N,), vatom (N, 6)) in the meshes' dtype (acc)
    on the card, the seven meshes (7, nx, ny, nz) interpolated at the
    entries of ``planes`` (x, y, z, q in flt) on ``pm``'s mesh
    (``pppm.peratom_gather_plain``): atoms, or with ``n_atoms`` the cell
    engine's slots (K18 slots: a slot whose ``planes.aid`` is n_atoms or
    more is empty and gets 0).  The meshes are copied point-major into (nx
    ny nz, 8), a pad after the seven values, the layout the kernel reads a
    point from in one aligned load."""
    dev, flt, acc = planes.x.device, planes.x.dtype, meshes.dtype
    if dev.type != "cuda":
        raise ValueError(f"pppm kernel needs CUDA tensors, got {dev}")
    prec = _PAIR.get((flt, acc))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc})")
    n = planes.x.shape[0]
    for name in ("x", "y", "z", "q"):
        check_plane(getattr(planes, name), name, flt, n, dev)
    p = pm.order
    check_plane(coef, "coef", flt, p * p, dev)
    aid = None
    if n_atoms is not None:
        aid = planes.aid
        check_plane(aid, "aid", torch.int32, n, dev)
    nx, ny, nz = pm.grid
    if not meshes.is_contiguous():
        raise ValueError("meshes are not contiguous")
    check_plane(meshes.view(-1), "meshes", acc, 7 * nx * ny * nz, dev)
    points = torch.zeros((nx * ny * nz, 8), dtype=acc, device=dev)
    points[:, :7] = meshes.view(7, -1).t()
    g, V = float(pm.g_ewald), float(pm.volume)
    eatom = torch.empty(n, dtype=acc, device=dev)
    vatom = torch.empty((n, 6), dtype=acc, device=dev)
    rc = _lib().pppm_peratom_gather(
        prec, planes.x.data_ptr(), planes.y.data_ptr(), planes.z.data_ptr(),
        planes.q.data_ptr(), None if aid is None else aid.data_ptr(), n,
        0 if n_atoms is None else int(n_atoms),
        *(float(v) for v in pm.box_lo),
        *(1.0 / float(h) for h in pm.h), nx, ny, nz, p, coef.data_ptr(),
        points.data_ptr(), float(scale), float(pm.qqrd2e),
        g / math.sqrt(math.pi), math.pi / (2.0 * g * g * V), float(pm.qsum),
        eatom.data_ptr(), vatom.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"pppm peratom gather launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["pppm_peratom_gather" if aid is None
             else "pppm_peratom_slots"] += 1
    return eatom, vatom
