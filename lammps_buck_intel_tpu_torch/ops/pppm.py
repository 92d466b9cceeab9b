"""Launch wrappers of the PPPM kernels (csrc/pppm.cu).

The plain versions of the same functions are ``deposit_plain``,
``spectral_plain`` and ``gather_plain`` in
``models.kspace.pppm_cells``.  The FFTs around the spectral kernel stay
``torch.fft`` (cuFFT) calls in ``CellPPPM.compute_slots``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from . import build
from .cellpair import check_plane

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
        lib.pppm_gather.argtypes = ([_I] + slot_args
                                    + [_P, _D, _P, _P, _P, _P])
        lib.pppm_gather.restype = _I
        lib.pppm_spectral.argtypes = ([_I, _I] + [_P] * 6 + [_I] * 3
                                      + [_D, _I, _P, _P, _I, _P])
        lib.pppm_spectral.restype = _I
        lib.pppm_threads.argtypes = []
        lib.pppm_threads.restype = _I
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
        center, boxL = box
        check_plane(boxL, "boxL", flt, 3, dev)
        geo = [*(float(v) for v in center), 1.0, 1.0, 1.0]
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


def spectral(consts: dict, rhat: torch.Tensor, ev: bool):
    """(ehat (3, nx, ny, nzh) complex, esum, vsum (6,)) on the card; the
    sums are zeros without ``ev``.  consts["nyquist"] (default False):
    the full-spectrum conventions at the Nyquist planes (see
    ``pppm_cells.spectral_plain``)."""
    G = consts["G"]
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
    lib = _lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblocks = min(_SPECTRAL_BLOCKS_PER_SM * sms,
                  -(-(nx * ny * nzh) // lib.pppm_threads()))
    ehat = torch.empty((3, nx, ny, nzh), dtype=rhat.dtype, device=dev)
    partial = (torch.empty((nblocks, 7), dtype=acc, device=dev) if ev
               else None)
    g = consts["g_ewald"]
    rc = lib.pppm_spectral(
        _FLT[acc], int(ev), rhat.data_ptr(), G.data_ptr(), kx.data_ptr(),
        ky.data_ptr(), kz.data_ptr(), wz.data_ptr(), nx, ny, nzh,
        0.25 / g**2, int(consts.get("nyquist", False)), ehat.data_ptr(),
        partial.data_ptr() if ev else None, nblocks, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"pppm spectral launch failed: CUDA error {rc}")
    LAUNCHES["pppm_spectral"] += 1
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
