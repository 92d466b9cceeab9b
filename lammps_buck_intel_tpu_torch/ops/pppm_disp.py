"""Launch wrappers of the dispersion kernels (csrc/pppm_disp.cu): the
multi-channel deposit (K12b), the half-spectrum solve (K12a), the
multi-channel ik gather (K12c), and the per-atom energy and virial: the
per-atom spectra (K12pa spectral) and the per-atom gather (K12pa gather,
and in slot order K18 slots).

The plain versions of the same functions are
``models.kspace.pppm_disp.deposit_multi_plain``, ``disp_spectral_plain``,
``gather_multi_plain``, ``disp_peratom_spectral_plain`` and
``disp_peratom_gather_plain``.  The FFTs between them stay ``torch.fft``
(cuFFT) calls.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LAUNCHES
from . import build
from .cellpair import check_plane

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_FLT = {torch.float32: 0, torch.float64: 1}
_PAIR = {(torch.float32, torch.float32): 0, (torch.float32, torch.float64): 1,
         (torch.float64, torch.float64): 2}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
# enough blocks to fill the card (this many per SM), a grid-stride loop
# beyond
_BLOCKS_PER_SM = 8


def _lib():
    lib = build.load("pppm_disp")
    if lib.disp_spectral.argtypes is None:
        lib.disp_spectral.argtypes = ([_I, _I, _P, _P, _I] + [_P] * 6
                                      + [_I] * 3 + [_P, _P, _I, _P])
        lib.disp_spectral.restype = _I
        entry_args = [_I] + [_P] * 4 + [_I, _P, _I, _I] + [_D] * 6 \
            + [_I] * 4 + [_P]
        lib.disp_deposit.argtypes = entry_args + [_P, _P]
        lib.disp_deposit.restype = _I
        lib.disp_gather.argtypes = entry_args + [_P] * 5
        lib.disp_gather.restype = _I
        lib.disp_peratom_spectral.argtypes = ([_I, _P, _P, _I] + [_P] * 5
                                              + [_I] * 3 + [_P, _I, _P])
        lib.disp_peratom_spectral.restype = _I
        lib.disp_peratom_gather.argtypes = (entry_args + [_P, _I] + [_P] * 3
                                            + [_D] * 3 + [_P] * 3)
        lib.disp_peratom_gather.restype = _I
        for fn in (lib.disp_threads, lib.disp_max_channels):
            fn.argtypes = []
            fn.restype = _I
    return lib


def _pairing(consts: dict, P, nch: int, acc, dev) -> torch.Tensor:
    """The pairing P (nch, nch) in acc on the card, uploaded once per
    pairing into ``consts``."""
    Pn = np.ascontiguousarray(P, np.float64)
    if Pn.shape != (nch, nch):
        raise ValueError(f"P has shape {Pn.shape}, expected ({nch}, {nch})")
    key = ("P", Pn.tobytes())
    Pm = consts.get(key)
    if Pm is None:
        Pm = consts[key] = torch.as_tensor(Pn).to(dev, acc)
    check_plane(Pm.view(-1), "P", acc, nch * nch, dev)
    return Pm


def _spectral_inputs(consts: dict, S: torch.Tensor, P):
    """The checked inputs of a dispersion spectral kernel: (G, vfac, kx,
    ky, kz, wz) flattened, P on the card, (nx, ny, nzh), nch and the block
    count."""
    G = consts["G"]
    acc = G.dtype
    dev = S.device
    if dev.type != "cuda":
        raise ValueError(f"pppm_disp kernel needs CUDA tensors, got {dev}")
    if acc not in _FLT or S.dtype != _COMPLEX[acc]:
        raise TypeError(f"dispersion spectral: S {S.dtype} with G {acc}")
    nx, ny, nzh = G.shape
    nch = S.shape[0]
    if (S.dim() != 4 or tuple(S.shape[1:]) != (nx, ny, nzh)
            or not S.is_contiguous()):
        raise ValueError(f"S has shape {tuple(S.shape)}, expected "
                         f"contiguous (nch, {nx}, {ny}, {nzh})")
    lib = _lib()
    if nch > lib.disp_max_channels():
        raise ValueError(f"{nch} channels > {lib.disp_max_channels()}")
    Pm = _pairing(consts, P, nch, acc, dev)
    kx, ky, kz = (k.view(-1) for k in consts["k3"])
    wz = consts["wz"].view(-1)
    vfac = consts["vfac"]
    for name, t, size in (("G", G.view(-1), nx * ny * nzh),
                          ("vfac", vfac.view(-1), nx * ny * nzh),
                          ("kx", kx, nx), ("ky", ky, ny), ("kz", kz, nzh),
                          ("wz", wz, nzh)):
        check_plane(t, name, acc, size, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblocks = min(_BLOCKS_PER_SM * sms,
                  -(-(nx * ny * nzh) // lib.disp_threads()))
    return (G, vfac, kx, ky, kz, wz), Pm, (nx, ny, nzh), nch, nblocks


def disp_spectral(consts: dict, S: torch.Tensor, P, ev: bool):
    """(ehat (nch, 3, nx, ny, nzh) complex, esum, vsum (6,)) on the card
    from the channel spectra S (nch, nx, ny, nzh) and the pairing P (nch,
    nch); the sums are zeros without ``ev`` (see ``disp_spectral_plain``)."""
    (G, vfac, kx, ky, kz, wz), Pm, (nx, ny, nzh), nch, nblocks = \
        _spectral_inputs(consts, S, P)
    acc, dev, lib = G.dtype, S.device, _lib()
    ehat = torch.empty((nch, 3, nx, ny, nzh), dtype=S.dtype, device=dev)
    partial = (torch.empty((nblocks, 7), dtype=acc, device=dev) if ev
               else None)
    rc = lib.disp_spectral(
        _FLT[acc], int(ev), S.data_ptr(), Pm.data_ptr(), nch, G.data_ptr(),
        vfac.data_ptr(), kx.data_ptr(), ky.data_ptr(), kz.data_ptr(),
        wz.data_ptr(), nx, ny, nzh, ehat.data_ptr(),
        partial.data_ptr() if ev else None, nblocks,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"disp_spectral launch failed: CUDA error {rc}")
    LAUNCHES["disp_spectral"] += 1
    if not ev:
        zero = torch.zeros(7, dtype=acc, device=dev)
        return ehat, zero[0], zero[1:]
    tot = partial.sum(0)
    return ehat, tot[0], tot[1:]


def _entry_args(pm, x, row, table, coef):
    """The entry and mesh-geometry arguments shared by the deposit and the
    gather, after checking them: x (3, M) positions, row (M,) int32
    columns of table (nch, K) in x's dtype, coef the spline piece table."""
    dev, flt = x.device, x.dtype
    if dev.type != "cuda":
        raise ValueError(f"pppm_disp kernels need CUDA tensors, got {dev}")
    if flt not in _FLT:
        raise TypeError(f"unsupported position dtype {flt}")
    if x.dim() != 2 or x.shape[0] != 3:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (3, M)")
    m = x.shape[1]
    planes = [x[a].contiguous() for a in range(3)]
    for name, t in zip("xyz", planes):
        check_plane(t, name, flt, m, dev)
    check_plane(row, "row", torch.int32, m, dev)
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table has shape {tuple(table.shape)}, expected "
                         "a contiguous (nch, K)")
    nch, ntab = table.shape
    check_plane(table.view(-1), "table", flt, nch * ntab, dev)
    lib = _lib()
    if not 0 < nch <= lib.disp_max_channels():
        raise ValueError(f"{nch} channels (1..{lib.disp_max_channels()})")
    p = pm.order
    check_plane(coef, "coef", flt, p * p, dev)
    geo = [*(float(v) for v in pm.box_lo), *(1.0 / float(h) for h in pm.h)]
    args = [*(t.data_ptr() for t in planes), row.data_ptr(), m,
            table.data_ptr(), ntab, nch, *geo, *pm.grid, p, coef.data_ptr()]
    # the planes must outlive the launch: keep them beside the arguments
    return lib, args, planes, nch, m


def disp_deposit(pm, x: torch.Tensor, row: torch.Tensor,
                 table: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """(nch, nx, ny, nz) channel meshes in x's dtype on the card: entry s
    deposits table[c, row[s]] on channel c (K12b; ``pm`` the mesh: grid,
    order, box_lo, h)."""
    lib, args, planes, nch, _ = _entry_args(pm, x, row, table, coef)
    nx, ny, nz = pm.grid
    mesh = torch.zeros((nch, nx, ny, nz), dtype=x.dtype, device=x.device)
    rc = lib.disp_deposit(_FLT[x.dtype], *args, mesh.data_ptr(),
                          torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"disp_deposit launch failed: CUDA error {rc}")
    LAUNCHES["disp_deposit"] += 1
    return mesh


def disp_gather(pm, x: torch.Tensor, row: torch.Tensor, table: torch.Tensor,
                e_fields: torch.Tensor, acc_dtype, coef: torch.Tensor):
    """(fx, fy, fz) acc on the card: f_s = sum_c table[c, row[s]] (the ik
    field of channel c at x_s), e_fields (nch, 3, nx, ny, nz) in x's dtype
    (K12c)."""
    lib, args, planes, nch, m = _entry_args(pm, x, row, table, coef)
    prec = _PAIR.get((x.dtype, acc_dtype))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({x.dtype}, {acc_dtype})")
    nx, ny, nz = pm.grid
    if not e_fields.is_contiguous():
        raise ValueError("e_fields is not contiguous")
    check_plane(e_fields.view(-1), "e_fields", x.dtype,
                nch * 3 * nx * ny * nz, x.device)
    fx, fy, fz = (torch.empty(m, dtype=acc_dtype, device=x.device)
                  for _ in range(3))
    rc = lib.disp_gather(prec, *args, e_fields.data_ptr(), fx.data_ptr(),
                         fy.data_ptr(), fz.data_ptr(),
                         torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"disp_gather launch failed: CUDA error {rc}")
    LAUNCHES["disp_gather"] += 1
    return fx, fy, fz


def disp_peratom_spectral(consts: dict, S: torch.Tensor, P) -> torch.Tensor:
    """K12pa spectral: (nch, 7, nx, ny, nzh) complex on the card, phi_c = G
    (P S)_c and its six virial spectra, from the channel spectra S (nch, nx,
    ny, nzh) (``pppm_disp.disp_peratom_spectral_plain``)."""
    (G, vfac, kx, ky, kz, _), Pm, (nx, ny, nzh), nch, nblocks = \
        _spectral_inputs(consts, S, P)
    out = torch.empty((nch, 7, nx, ny, nzh), dtype=S.dtype, device=S.device)
    rc = _lib().disp_peratom_spectral(
        _FLT[G.dtype], S.data_ptr(), Pm.data_ptr(), nch, G.data_ptr(),
        vfac.data_ptr(), kx.data_ptr(), ky.data_ptr(), kz.data_ptr(), nx, ny,
        nzh, out.data_ptr(), nblocks,
        torch.cuda.current_stream(S.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"disp_peratom_spectral launch failed: CUDA error {rc}")
    LAUNCHES["disp_peratom_spectral"] += 1
    return out


def disp_peratom_gather(pm, x: torch.Tensor, row: torch.Tensor,
                        table: torch.Tensor, meshes: torch.Tensor,
                        coef: torch.Tensor, Pm: torch.Tensor,
                        Pasum: torch.Tensor, scale: float, k0c: float,
                        selfc: float, aid=None, n_atoms: int = 0):
    """K12pa gather: (eatom (M,), vatom (M, 6)) in the meshes' dtype (acc)
    on the card (``pppm_disp.disp_peratom_gather_plain``): entry s carries
    the charges table[:, row[s]]; meshes (nch, 7, nx, ny, nz) acc, copied
    here point-major into (nch, nx ny nz, 8), a pad after the seven values;
    Pm (nch, nch) and Pasum = P asum (nch,) in acc.  With ``aid`` (the
    slots' atom ids, K18 slots) an entry whose aid is n_atoms or more is
    empty and gets 0."""
    lib, args, planes, nch, m = _entry_args(pm, x, row, table, coef)
    dev, acc = x.device, meshes.dtype
    prec = _PAIR.get((x.dtype, acc))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({x.dtype}, {acc})")
    nx, ny, nz = pm.grid
    ng = nx * ny * nz
    if tuple(meshes.shape) != (nch, 7, nx, ny, nz) or \
            not meshes.is_contiguous():
        raise ValueError(f"meshes have shape {tuple(meshes.shape)}, expected "
                         f"contiguous {(nch, 7, nx, ny, nz)}")
    check_plane(meshes.view(-1), "meshes", acc, nch * 7 * ng, dev)
    check_plane(Pm.view(-1), "P", acc, nch * nch, dev)
    check_plane(Pasum, "Pasum", acc, nch, dev)
    if aid is not None:
        check_plane(aid, "aid", torch.int32, m, dev)
    points = torch.zeros((nch, ng, 8), dtype=acc, device=dev)
    points[:, :, :7] = meshes.view(nch, 7, ng).transpose(1, 2)
    eatom = torch.empty(m, dtype=acc, device=dev)
    vatom = torch.empty((m, 6), dtype=acc, device=dev)
    rc = lib.disp_peratom_gather(
        prec, *args, None if aid is None else aid.data_ptr(), int(n_atoms),
        points.data_ptr(), Pm.data_ptr(), Pasum.data_ptr(), float(scale),
        float(k0c), float(selfc), eatom.data_ptr(), vatom.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"disp_peratom_gather launch failed: CUDA error {rc}")
    LAUNCHES["disp_peratom_slots" if aid is not None
             else "disp_peratom_gather"] += 1
    return eatom, vatom
