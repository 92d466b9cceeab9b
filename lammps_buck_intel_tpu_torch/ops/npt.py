"""Launch wrappers of the variable-cell kernels (csrc/npt.cu).

The plain versions of the same functions are
``models.kspace.pppm_npt.traced_greens_plain`` and ``integrate.npt``'s
``ke3_plain``, ``vscale_kick_plain`` and ``drift_dilate_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from . import build
from .cellpair import check_plane

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PREC = {(torch.float32, torch.float32): 0, (torch.float32, torch.float64): 1,
         (torch.float64, torch.float64): 2}


def _lib():
    lib = build.load("npt")
    if lib.npt_ke3.argtypes is None:
        lib.npt_partial_rows.argtypes = [_I]
        lib.traced_greens.argtypes = [_I] + [_P] * 8 + [_I] * 5 + [_D, _P, _P]
        lib.npt_ke3.argtypes = [_I] + [_P] * 5 + [_I, _P, _P]
        lib.npt_vscale_kick.argtypes = [_I] + [_P] * 9 + [_D, _I, _P]
        lib.npt_drift_dilate.argtypes = [_I] + [_P] * 7 + [_D] * 4 + [_I, _P]
        for fn in (lib.npt_partial_rows, lib.traced_greens, lib.npt_ke3,
                   lib.npt_vscale_kick, lib.npt_drift_dilate):
            fn.restype = _I
    return lib


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _prec(flt, acc) -> int:
    prec = _PREC.get((flt, acc))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc})")
    return prec


def _planes(planes, names, dtype, n, dev):
    for p, name in zip(planes, names):
        check_plane(p, name, dtype, n, dev)
    return [p.data_ptr() for p in planes]


def _atoms(vs):
    dev, flt, n = vs[0].device, vs[0].dtype, vs[0].shape[0]
    if dev.type != "cuda":
        raise ValueError(f"npt kernels need CUDA tensors, got {dev}")
    if flt not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported plane dtype {flt}")
    return dev, flt, n


def traced_greens(st: dict, boxL: torch.Tensor, g_ewald: float):
    """(nx, ny, nz) influence function in the statics' acc dtype from the
    box lengths on the card.  st: the statics of
    ``pppm_npt.TracedPPPM.statics_on`` (ms and u2 per axis (S, n), den_sq,
    mid)."""
    den = st["den_sq"]
    dev, acc = den.device, den.dtype
    if dev.type != "cuda":
        raise ValueError(f"traced_greens needs CUDA tensors, got {dev}")
    nx, ny, nz = den.shape
    S = st["ms"][0].shape[0]
    for ax, n in enumerate((nx, ny, nz)):
        for k in ("ms", "u2"):
            check_plane(st[k][ax].view(-1), f"{k}[{ax}]", acc, S * n, dev)
    check_plane(den.view(-1), "den_sq", acc, nx * ny * nz, dev)
    check_plane(boxL, "boxL", boxL.dtype, 3, dev)
    G = torch.empty((nx, ny, nz), dtype=acc, device=dev)
    _check(_lib().traced_greens(
        _prec(boxL.dtype, acc), *(t.data_ptr() for t in st["ms"]),
        *(t.data_ptr() for t in st["u2"]), den.data_ptr(), boxL.data_ptr(),
        nx, ny, nz, S, st["mid"], float(g_ewald) ** 2, G.data_ptr(),
        _stream(dev)), "traced_greens")
    return G


def ke3(vs, typ, mass_t, acc_dtype) -> torch.Tensor:
    """(rows, 3) acc partials whose column sums are sum m v_a^2."""
    dev, flt, n = _atoms(vs)
    check_plane(typ, "typ", torch.int32, n, dev)
    check_plane(mass_t, "mass_t", flt, mass_t.numel(), dev)
    lib = _lib()
    part = torch.empty((lib.npt_partial_rows(n), 3), dtype=acc_dtype,
                       device=dev)
    _check(lib.npt_ke3(
        _prec(flt, acc_dtype), *_planes(vs, ("vx", "vy", "vz"), flt, n, dev),
        typ.data_ptr(), mass_t.data_ptr(), n, part.data_ptr(), _stream(dev)),
        "npt_ke3")
    return part


def vscale_kick(vs, fs, typ, minv_t, vfac, dtf: float):
    """v_a <- v_a vfac_a, then + (dtf / m) f_a unless ``fs`` is None; in
    place."""
    dev, flt, n = _atoms(vs)
    vp = _planes(vs, ("vx", "vy", "vz"), flt, n, dev)
    fp = ([None] * 3 if fs is None else
          _planes(fs, ("fx", "fy", "fz"), flt, n, dev))
    check_plane(typ, "typ", torch.int32, n, dev)
    check_plane(minv_t, "minv_t", flt, minv_t.numel(), dev)
    check_plane(vfac, "vfac", flt, 3, dev)
    _check(_lib().npt_vscale_kick(
        int(flt == torch.float64), *vp, *fp, typ.data_ptr(),
        minv_t.data_ptr(), vfac.data_ptr(), float(dtf), n, _stream(dev)),
        "npt_vscale_kick")


def drift_dilate(xs, vs, s, center, dtv: float):
    """x_a <- c_a + ((x_a + dtv v_a) - c_a) s_a, in place."""
    dev, flt, n = _atoms(vs)
    xp = _planes(xs, "xyz", flt, n, dev)
    vp = _planes(vs, ("vx", "vy", "vz"), flt, n, dev)
    check_plane(s, "s", flt, 3, dev)
    _check(_lib().npt_drift_dilate(
        int(flt == torch.float64), *xp, *vp, s.data_ptr(),
        *(float(c) for c in center), float(dtv), n, _stream(dev)),
        "npt_drift_dilate")
