"""Launch wrapper of the dispersion spectral kernel (csrc/pppm_disp.cu).

The plain version of the same function is
``models.kspace.pppm_disp.disp_spectral_plain``.  The deposit and the
gather around it are ``ops.pppm``'s, and the FFTs stay ``torch.fft``
(cuFFT) calls.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LAUNCHES
from . import build
from .cellpair import check_plane

_P, _I = ctypes.c_void_p, ctypes.c_int
_FLT = {torch.float32: 0, torch.float64: 1}
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
        for fn in (lib.disp_threads, lib.disp_max_channels):
            fn.argtypes = []
            fn.restype = _I
    return lib


def disp_spectral(consts: dict, S: torch.Tensor, P, ev: bool):
    """(ehat (nch, 3, nx, ny, nzh) complex, esum, vsum (6,)) on the card
    from the channel spectra S (nch, nx, ny, nzh) and the pairing P (nch,
    nch); the sums are zeros without ``ev`` (see ``disp_spectral_plain``)."""
    G = consts["G"]
    acc = G.dtype
    dev = S.device
    if dev.type != "cuda":
        raise ValueError(f"pppm_disp kernel needs CUDA tensors, got {dev}")
    if acc not in _FLT or S.dtype != _COMPLEX[acc]:
        raise TypeError(f"disp_spectral: S {S.dtype} with G {acc}")
    nx, ny, nzh = G.shape
    nch = S.shape[0]
    if (S.dim() != 4 or tuple(S.shape[1:]) != (nx, ny, nzh)
            or not S.is_contiguous()):
        raise ValueError(f"S has shape {tuple(S.shape)}, expected "
                         f"contiguous (nch, {nx}, {ny}, {nzh})")
    lib = _lib()
    if nch > lib.disp_max_channels():
        raise ValueError(f"{nch} channels > {lib.disp_max_channels()}")
    Pn = np.ascontiguousarray(P, np.float64)
    if Pn.shape != (nch, nch):
        raise ValueError(f"P has shape {Pn.shape}, expected ({nch}, {nch})")
    key = ("P", Pn.tobytes())   # uploaded once per pairing
    Pm = consts.get(key)
    if Pm is None:
        Pm = consts[key] = torch.as_tensor(Pn).to(dev, acc)
    check_plane(Pm.view(-1), "P", acc, nch * nch, dev)
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
