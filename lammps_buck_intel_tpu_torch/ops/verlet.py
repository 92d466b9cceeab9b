"""Launch wrappers of the integrator kernels (csrc/verlet.cu).

The plain versions of the same functions are ``integrate.nve``'s
``kick_drift_plain``, ``kick_plain`` and ``kinetic_plain`` and
``integrate.nvt.nhc_scale_plain``.
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
# longest chain csrc/verlet.cu integrates in registers
MAX_CHAIN = 16


def _lib():
    lib = build.load("verlet")
    if lib.verlet_kick_drift.argtypes is None:
        lib.verlet_partial_rows.argtypes = [_I]
        lib.verlet_kick_drift.argtypes = [_I] + [_P] * 12 + [_I, _I, _D, _D,
                                                             _P]
        lib.verlet_kick.argtypes = [_I] + [_P] * 16 + [_I, _I, _D, _P, _P]
        lib.verlet_ke.argtypes = [_I] + [_P] * 6 + [_I, _I, _P, _P]
        lib.nhc_scale.argtypes = ([_I] + [_P] * 3 + [_I, _P, _I, _P, _P, _I]
                                  + [_D] * 6 + [_P])
        for fn in (lib.verlet_partial_rows, lib.verlet_kick_drift,
                   lib.verlet_kick, lib.verlet_ke, lib.nhc_scale):
            fn.restype = _I
    return lib


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _planes(planes, names, dtype, ns, dev):
    for p, name in zip(planes, names):
        check_plane(p, name, dtype, ns, dev)
    return [p.data_ptr() for p in planes]


def _slots(vs, typ, aid, tables):
    """Checks shared by the kernels; returns (device, flt, nslots)."""
    dev, flt, ns = vs[0].device, vs[0].dtype, vs[0].shape[0]
    if dev.type != "cuda":
        raise ValueError(f"integrator kernels need CUDA tensors, got {dev}")
    check_plane(typ, "typ", torch.int32, ns, dev)
    check_plane(aid, "aid", torch.int32, ns, dev)
    for t in tables:
        check_plane(t, "per-type table", flt, t.numel(), dev)
    return dev, flt, ns


def _prec(flt, acc_dtype) -> int:
    prec = _PREC.get((flt, acc_dtype))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc_dtype})")
    return prec


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def kick_drift(xs, vs, fs, typ, aid, minv_t, n_atoms: int, dtf: float,
               dtv: float):
    """v += dtf / m f; x += dtv v on the occupied slots, in place."""
    dev, flt, ns = _slots(vs, typ, aid, (minv_t,))
    ptrs = (_planes(xs, "xyz", flt, ns, dev)
            + _planes(vs, ("vx", "vy", "vz"), flt, ns, dev)
            + _planes(fs, ("fx", "fy", "fz"), flt, ns, dev))
    _check(_lib().verlet_kick_drift(
        int(flt == torch.float64), *ptrs, typ.data_ptr(), aid.data_ptr(),
        minv_t.data_ptr(), n_atoms, ns, dtf, dtv, _stream(dev)),
        "verlet_kick_drift")


def kick(vs, fs, fa, fb, typ, aid, minv_t, mass_t, n_atoms: int, dtf: float,
         acc_dtype, ke: bool):
    """f = (flt)(fa + fb) stored in ``fs``; v += dtf / m f; with ``ke`` the
    (rows, 2) kinetic partials of the kicked velocities, else None."""
    dev, flt, ns = _slots(vs, typ, aid, (minv_t, mass_t))
    prec = _prec(flt, acc_dtype)
    ptrs = (_planes(vs, ("vx", "vy", "vz"), flt, ns, dev)
            + _planes(fs, ("fx", "fy", "fz"), flt, ns, dev)
            + _planes(fa, ("fax", "fay", "faz"), acc_dtype, ns, dev)
            + ([None] * 3 if fb is None else
               _planes(fb, ("fbx", "fby", "fbz"), acc_dtype, ns, dev)))
    lib = _lib()
    partial = (torch.empty((lib.verlet_partial_rows(ns), 2), dtype=acc_dtype,
                           device=dev) if ke else None)
    _check(lib.verlet_kick(
        prec, *ptrs, typ.data_ptr(), aid.data_ptr(), minv_t.data_ptr(),
        mass_t.data_ptr(), n_atoms, ns, dtf,
        partial.data_ptr() if ke else None, _stream(dev)), "verlet_kick")
    return partial


def kinetic(vs, typ, aid, mass_t, n_atoms: int, acc_dtype) -> torch.Tensor:
    """(rows, 2) partials: column 0 sums to sum(m v^2) over the occupied
    slots, the max of column 1 is max |v|^2."""
    dev, flt, ns = _slots(vs, typ, aid, (mass_t,))
    prec = _prec(flt, acc_dtype)
    lib = _lib()
    partial = torch.empty((lib.verlet_partial_rows(ns), 2), dtype=acc_dtype,
                          device=dev)
    _check(lib.verlet_ke(
        prec, *_planes(vs, ("vx", "vy", "vz"), flt, ns, dev), typ.data_ptr(),
        aid.data_ptr(), mass_t.data_ptr(), n_atoms, ns, partial.data_ptr(),
        _stream(dev)), "verlet_ke")
    return partial


def nhc_scale(cfg, therm: torch.Tensor, vs, partial: torch.Tensor,
              t_target: float) -> torch.Tensor:
    """One Nose-Hoover chain half step from the kinetic partials: scales
    the velocity planes in place and returns the new (2, M) chain."""
    dev, flt, ns = vs[0].device, vs[0].dtype, vs[0].shape[0]
    if dev.type != "cuda":
        raise ValueError(f"nhc_scale kernel needs CUDA tensors, got {dev}")
    prec = _prec(flt, partial.dtype)
    m = cfg.tchain
    if not 1 <= m <= MAX_CHAIN:
        raise ValueError(f"tchain {m} outside 1..{MAX_CHAIN}")
    check_plane(therm.view(-1), "therm", flt, 2 * m, dev)
    if partial.device != dev or partial.dim() != 2 or partial.shape[1] != 2 \
            or not partial.is_contiguous():
        raise ValueError("partial must be a contiguous (rows, 2) tensor on "
                         "the device of the planes")
    out = torch.empty_like(therm)
    kt = cfg.boltz * t_target
    _check(_lib().nhc_scale(
        prec, *_planes(vs, ("vx", "vy", "vz"), flt, ns, dev), ns,
        partial.data_ptr(), partial.shape[0], therm.data_ptr(),
        out.data_ptr(), m, cfg.dt, kt, cfg.dof * kt,
        cfg.dof * kt * cfg.t_damp**2, kt * cfg.t_damp**2, cfg.mvv2e,
        _stream(dev)), "nhc_scale")
    return out
