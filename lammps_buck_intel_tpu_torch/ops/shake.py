"""Launch wrappers of the constraint kernels (csrc/shake.cu).

The plain versions of the same functions are ``integrate.shake``'s
``shake_ref_plain``, ``shake_positions_plain``, ``rattle_velocities_plain``
and ``shake_virial_plain``.  ``t`` is the dict of ``ShakeClusters.tables_on``
on the device of the planes.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from . import build
from .cellpair import check_plane
from ..integrate.shake import MAX_C

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PREC = {(torch.float32, torch.float32): 0, (torch.float32, torch.float64): 1,
         (torch.float64, torch.float64): 2}
_TABLES = ("atoms", "pi", "pj", "d2", "K", "invm")


def _lib():
    lib = build.load("shake")
    if lib.shake_ref.argtypes is None:
        head = [_I] * 4 + [_P] * 3
        lib.shake_partial_rows.argtypes = [_I]
        lib.shake_ref.argtypes = head + [_P] * 4 + [_D] * 3 + [_P, _P]
        lib.shake_positions.argtypes = (head + [_P] * 4 + [_P] * 6
                                        + [_P, _P] + [_D] * 4 + [_I, _P])
        lib.rattle_velocities.argtypes = (head + [_P] * 3 + [_P] * 6
                                          + [_P] + [_D] * 3 + [_P])
        lib.shake_virial.argtypes = (head + [_P] * 3 + [_P] * 12 + [_D] * 4
                                     + [_P, _P])
        for fn in (lib.shake_partial_rows, lib.shake_ref,
                   lib.shake_positions, lib.rattle_velocities,
                   lib.shake_virial):
            fn.restype = _I
    return lib


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _setup(t: dict, planes, inv):
    """Checks shared by the kernels; returns (device, flt, head args)."""
    dev, flt = planes[0].device, planes[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"shake kernels need CUDA tensors, got {dev}")
    if flt not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported plane dtype {flt}")
    ns = planes[0].shape[0]
    for p, name in zip(planes, ("p0", "p1", "p2")):
        check_plane(p, name, flt, ns, dev)
    if inv.device != dev or inv.dtype != torch.int32 or inv.dim() != 1 \
            or not inv.is_contiguous():
        raise TypeError("inv must be a contiguous int32 (N + 1,) tensor on "
                        "the device of the planes")
    A, M = t["atoms"].shape
    C = t["pi"].shape[0]
    if C > MAX_C or A > C + 1:
        raise ValueError(f"cluster of {C} constraints on {A} atoms: the "
                         f"kernels take at most {MAX_C} constraints on "
                         "C + 1 atoms")
    shapes = {"atoms": (A, M), "pi": (C, M), "pj": (C, M), "d2": (C, M),
              "K": (C, C, M), "invm": (A, M)}
    for k in _TABLES:
        want = torch.int32 if k in ("atoms", "pi", "pj") else flt
        v = t[k]
        if v.device != dev or v.dtype != want or tuple(v.shape) != shapes[k] \
                or not v.is_contiguous():
            raise ValueError(f"shake table {k} must be a contiguous {want} "
                             f"{shapes[k]} tensor on {dev}")
    return dev, flt, (M, C, A)


def _rvec(r, flt, dims, dev, name):
    M, C, _ = dims
    if r.device != dev or r.dtype != flt or tuple(r.shape) != (3, C, M) \
            or not r.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {flt} (3, {C}, {M}) "
                         f"tensor on {dev}")
    return r.data_ptr()


def _box(L):
    return [float(v) for v in L]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptrs(t, names):
    return [t[k].data_ptr() for k in names]


def shake_ref(t, xs, inv, L) -> torch.Tensor:
    """(3, C, M) minimum-imaged x_i - x_j of the positions ``xs``."""
    dev, flt, dims = _setup(t, xs, inv)
    M, C, _ = dims
    ro = torch.empty((3, C, M), dtype=flt, device=dev)
    _check(_lib().shake_ref(
        int(flt == torch.float64), *dims, *_ptrs(t, ("atoms", "pi", "pj")),
        inv.data_ptr(), *(p.data_ptr() for p in xs), *_box(L), ro.data_ptr(),
        _stream(dev)), "shake_ref")
    return ro


def shake_positions(t, ro, xs, vs, inv, L, dt: float,
                    iters: int) -> torch.Tensor:
    """The Newton solve along ``ro``; x (and v unless ``vs`` is None)
    updated in place; returns rn (3, C, M)."""
    dev, flt, dims = _setup(t, xs, inv)
    M, C, _ = dims
    if vs is not None:
        for p, name in zip(vs, ("vx", "vy", "vz")):
            check_plane(p, name, flt, xs[0].shape[0], dev)
    rn = torch.empty((3, C, M), dtype=flt, device=dev)
    vp = [None] * 3 if vs is None else [p.data_ptr() for p in vs]
    _check(_lib().shake_positions(
        int(flt == torch.float64), *dims, *_ptrs(t, _TABLES), inv.data_ptr(),
        *(p.data_ptr() for p in xs), *vp, _rvec(ro, flt, dims, dev, "ro"),
        rn.data_ptr(), *_box(L), float(dt), min(int(iters), 4),
        _stream(dev)), "shake_positions")
    return rn


def rattle_velocities(t, vs, inv, L, r=None, xs=None):
    """The velocity projection, in place, along ``r`` (SHAKE's rn) or
    along the bond vectors of ``xs``."""
    dev, flt, dims = _setup(t, vs, inv)
    if r is None:
        if xs is None:
            raise ValueError("rattle_velocities needs r or xs")
        for p, name in zip(xs, "xyz"):
            check_plane(p, name, flt, vs[0].shape[0], dev)
        xp, rp = [p.data_ptr() for p in xs], None
    else:
        xp, rp = [None] * 3, _rvec(r, flt, dims, dev, "r")
    _check(_lib().rattle_velocities(
        int(flt == torch.float64), *dims,
        *_ptrs(t, ("atoms", "pi", "pj", "K", "invm")), inv.data_ptr(), *xp,
        *(p.data_ptr() for p in vs), rp, *_box(L), _stream(dev)),
        "rattle_velocities")


def shake_virial(t, xs, vs, fa, fb, inv, L, ftm2v: float,
                 acc_dtype) -> torch.Tensor:
    """(6,) constraint virial on the total force (flt)(fa + fb): one
    launch writes per-block partials, summed here."""
    dev, flt, dims = _setup(t, xs, inv)
    prec = _PREC.get((flt, acc_dtype))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc_dtype})")
    ns = xs[0].shape[0]
    for p, name in zip(vs, ("vx", "vy", "vz")):
        check_plane(p, name, flt, ns, dev)
    for p, name in zip(fa, ("fax", "fay", "faz")):
        check_plane(p, name, acc_dtype, ns, dev)
    fbp = [None] * 3
    if fb is not None:
        for p, name in zip(fb, ("fbx", "fby", "fbz")):
            check_plane(p, name, acc_dtype, ns, dev)
        fbp = [p.data_ptr() for p in fb]
    lib = _lib()
    part = torch.empty((lib.shake_partial_rows(dims[0]), 6), dtype=acc_dtype,
                       device=dev)
    _check(lib.shake_virial(
        prec, *dims, *_ptrs(t, ("atoms", "pi", "pj", "K", "invm")),
        inv.data_ptr(), *(p.data_ptr() for p in xs),
        *(p.data_ptr() for p in vs), *(p.data_ptr() for p in fa), *fbp,
        *_box(L), float(ftm2v), part.data_ptr(), _stream(dev)),
        "shake_virial")
    return part.sum(0)
