"""Launch wrappers of the rigid-body kernels (csrc/rigid.cu).

The plain versions of the same functions are
``integrate.rigid.slot_force_torque_plain``, ``rigid_update_plain`` and
``slot_constraint_virial_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import LAUNCHES
from . import build
from .cellpair import check_plane

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PREC = {(torch.float32, torch.float32): 0, (torch.float32, torch.float64): 1,
         (torch.float64, torch.float64): 2}


def _lib():
    lib = build.load("rigid")
    if lib.rigid_force_torque.argtypes is None:
        lib.rigid_force_torque.argtypes = ([_I, _P, _P, _I, _I]
                                           + [_P] * 13 + [_P])
        lib.rigid_force_torque.restype = _I
        lib.rigid_update.argtypes = ([_I, _P, _P, _I, _I, _I] + [_P] * 9
                                     + [_D, _D] + [_P] * 8 + [_P])
        lib.rigid_update.restype = _I
        lib.rigid_virial.argtypes = ([_I, _P, _P, _I, _I] + [_P] * 5 + [_D]
                                     + [_P] * 9 + [_P])
        lib.rigid_virial.restype = _I
        lib.rigid_blocks.argtypes = [_I, _I]
        lib.rigid_blocks.restype = _I
    return lib


def default_width(max_size: int) -> int:
    """Lanes per body: the smallest power of two that holds the largest
    body, at most a warp."""
    w = 1
    while w < min(max(max_size, 1), 32):
        w *= 2
    return w


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _common(t, d, inv, width):
    dev = d.device
    if dev.type != "cuda":
        raise ValueError(f"rigid kernel needs CUDA tensors, got {dev}")
    n, B = t.order.shape[0], t.nbody
    flt = d.dtype
    if flt not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {flt}")
    if d.shape != (n, 3) or not d.is_contiguous():
        raise ValueError(f"d has shape {tuple(d.shape)}, expected ({n}, 3)")
    check_plane(t.order, "order", torch.int32, n, dev)
    check_plane(t.start, "start", torch.int32, B + 1, dev)
    if inv.device != dev or inv.dtype != torch.int32 or inv.dim() != 1 \
            or inv.shape[0] < n or not inv.is_contiguous():
        raise ValueError("inv must be a contiguous int32 (N + 1,) atom -> "
                         "slot map on the card")
    w = default_width(t.max_size) if width is None else int(width)
    return dev, flt, w


def _body(t_, name, shape, flt, dev):
    if t_.device != dev or t_.dtype != flt or tuple(t_.shape) != shape \
            or not t_.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {flt} {shape} on "
                         f"{dev}, got {t_.dtype} {tuple(t_.shape)}")


def _planes(ps, name, dtype, ns, dev):
    if ps is None:
        return [None] * 3
    for k, p in enumerate(ps):
        check_plane(p, f"{name}[{k}]", dtype, ns, dev)
    return [p.data_ptr() for p in ps]


def force_torque(t, d, inv, fa, fb=None, f_out=None,
                 width: Optional[int] = None):
    """K15a: (F, T) (B, 3) flt on the card (see
    ``integrate.rigid.slot_force_torque_plain``)."""
    dev, flt, w = _common(t, d, inv, width)
    acc = fa[0].dtype
    prec = _PREC.get((flt, acc))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc})")
    ns = fa[0].shape[0]
    fa_p = _planes(fa, "fa", acc, ns, dev)
    fb_p = _planes(fb, "fb", acc, ns, dev)
    fo_p = _planes(f_out, "f_out", flt, ns, dev)
    B = t.nbody
    F = torch.empty((B, 3), dtype=flt, device=dev)
    T = torch.empty((B, 3), dtype=flt, device=dev)
    rc = _lib().rigid_force_torque(
        prec, t.order.data_ptr(), t.start.data_ptr(), B, w, d.data_ptr(),
        inv.data_ptr(), *fa_p, *fb_p, *fo_p, F.data_ptr(), T.data_ptr(),
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rigid_force_torque launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["rigid_force_torque"] += 1
    return F, T


def update(t, bs, d, inv, planes, off, F, T, dtv: float, dtf: float,
           mode: int, width: Optional[int] = None):
    """K15b in place on the card (see ``integrate.rigid.rigid_update_plain``)."""
    from ..integrate.rigid import MODE_FINAL, MODE_OFFSETS

    dev, flt, w = _common(t, d, inv, width)
    B = t.nbody
    for name, tt, shape in (("X", bs.X, (B, 3)), ("V", bs.V, (B, 3)),
                            ("q", bs.q, (B, 4)), ("L", bs.L, (B, 3)),
                            ("minv", t.minv, (B,)), ("iinv", t.iinv, (B, 3)),
                            ("r_body", t.r_body, (d.shape[0], 3))):
        _body(tt, name, shape, flt, dev)
    if mode != MODE_FINAL and (planes is None or off is None):
        raise ValueError("the offsets and initial modes need the position "
                         "and offset planes")
    if mode != MODE_OFFSETS:
        if F is None or T is None:
            raise ValueError("the initial and final modes need F and T")
        _body(F, "F", (B, 3), flt, dev)
        _body(T, "T", (B, 3), flt, dev)
    ns = (planes or off or [inv])[0].shape[0]
    p_p = _planes(planes, "planes", flt, ns, dev)
    o_p = _planes(off, "off", flt, ns, dev)
    rc = _lib().rigid_update(
        int(flt == torch.float64), t.order.data_ptr(), t.start.data_ptr(), B,
        w, int(mode), t.r_body.data_ptr(), t.minv.data_ptr(),
        t.iinv.data_ptr(), bs.X.data_ptr(), bs.V.data_ptr(), bs.q.data_ptr(),
        bs.L.data_ptr(), None if F is None else F.data_ptr(),
        None if T is None else T.data_ptr(), float(dtv), float(dtf),
        d.data_ptr(), inv.data_ptr(), *p_p, *o_p, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rigid_update launch failed: CUDA error {rc}")
    LAUNCHES["rigid_update"] += 1


def virial(t, bs, d, inv, fa, fb, T, ftm2v: float, acc_dtype,
           width: Optional[int] = None):
    """K15c: the (6,) rigid constraint virial in acc on the card (see
    ``integrate.rigid.slot_constraint_virial_plain``)."""
    dev, flt, w = _common(t, d, inv, width)
    acc = fa[0].dtype
    prec = _PREC.get((flt, acc))
    if prec is None or acc != acc_dtype:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc}), "
                        f"acc_dtype {acc_dtype}")
    B = t.nbody
    for name, tt, shape in (("q", bs.q, (B, 4)), ("L", bs.L, (B, 3)),
                            ("T", T, (B, 3)), ("iinv", t.iinv, (B, 3)),
                            ("mass", t.mass, (d.shape[0],))):
        _body(tt, name, shape, flt, dev)
    ns = fa[0].shape[0]
    fa_p = _planes(fa, "fa", acc, ns, dev)
    fb_p = _planes(fb, "fb", acc, ns, dev)
    lib = _lib()
    partial = torch.empty((lib.rigid_blocks(B, w), 6), dtype=acc, device=dev)
    rc = lib.rigid_virial(
        prec, t.order.data_ptr(), t.start.data_ptr(), B, w,
        t.mass.data_ptr(), t.iinv.data_ptr(), bs.q.data_ptr(),
        bs.L.data_ptr(), T.data_ptr(), float(ftm2v), d.data_ptr(),
        inv.data_ptr(), *fa_p, *fb_p, partial.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rigid_virial launch failed: CUDA error {rc}")
    LAUNCHES["rigid_virial"] += 1
    return partial.sum(0)
