"""Launch wrappers of the rebin kernels (csrc/rebin.cu).

The plain versions of the same functions are
``neighbor.cell_slots._rebin_incremental_plain`` and the CPU branch of
``neighbor.cell_slots.rebin``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import LAUNCHES
from . import build
from .cellpair import check_plane
from ..neighbor.cell_slots import FLOAT_FIELDS, INT_FIELDS, SlotState

_P, _I = ctypes.c_void_p, ctypes.c_int
_FLT = (torch.float32, torch.float64)


def _lib():
    lib = build.load("rebin")
    if lib.rebin_incremental.argtypes is None:
        lib.rebin_incremental.argtypes = (
            [_I] + [_P] * 6 + [_I] * 6 + [_P] * 5)
        lib.rebin_incremental.restype = _I
        lib.rebin_full.argtypes = (
            [_I, _P, _P, _I, _P, _P] + [_I] * 5 + [_P] * 5)
        lib.rebin_full.restype = _I
    return lib


def _check_state(state: SlotState, numel: int):
    dev = state.x.device
    if dev.type != "cuda":
        raise ValueError(f"rebin kernel needs CUDA tensors, got {dev}")
    flt = state.x.dtype
    if flt not in _FLT:
        raise TypeError(f"unsupported slot-plane dtype {flt}")
    for name in FLOAT_FIELDS:
        check_plane(getattr(state, name), name, flt, numel, dev)
    for name in INT_FIELDS:
        check_plane(getattr(state, name), name, torch.int32, numel, dev)
    ov = state.overflow
    if ov.device != dev or ov.dtype != torch.bool or ov.dim() != 0:
        raise TypeError("overflow must be a 0-d bool tensor on the device")


def _ptrs(planes):
    return (ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes))


def _box_args(box):
    lo = (ctypes.c_double * 3)(*(float(v) for v in np.asarray(box.lo)))
    L = (ctypes.c_double * 3)(*(float(v) for v in np.asarray(box.lengths)))
    return lo, L


def _empty_planes(numel, flt, dev):
    return ([torch.empty(numel, dtype=flt, device=dev) for _ in FLOAT_FIELDS],
            [torch.empty(numel, dtype=torch.int32, device=dev)
             for _ in INT_FIELDS])


def rebin_incremental(grid, box, state: SlotState, B: int) -> SlotState:
    """In-place incremental rebin on the card (fallback decided on the
    device).  Returns ``state``, whose planes now hold the result."""
    ns = grid.nslots
    _check_state(state, ns)
    if not 1 <= B <= ns:
        raise ValueError(f"mover buffer {B} outside [1, {ns}]")
    dev, flt = state.x.device, state.x.dtype
    buf_f, buf_i = _empty_planes(B, flt, dev)
    scr_f, scr_i = _empty_planes(ns, flt, dev)
    work = torch.empty(4 + 3 * ns + 2 * B + 2 * grid.ncell,
                       dtype=torch.int32, device=dev)
    lo, L = _box_args(box)
    sf = _ptrs([getattr(state, f) for f in FLOAT_FIELDS])
    si = _ptrs([getattr(state, f) for f in INT_FIELDS])
    rc = _lib().rebin_incremental(
        int(flt == torch.float64), sf, si, _ptrs(buf_f), _ptrs(buf_i),
        _ptrs(scr_f), _ptrs(scr_i), grid.n_atoms, *grid.nc, grid.cap, B,
        lo, L, work.data_ptr(), state.overflow.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rebin kernel launch failed: CUDA error {rc}")
    LAUNCHES["rebin_incremental"] += 1
    return state


def rebin(grid, box, state: SlotState) -> SlotState:
    """Full rebin of any number of entries into a fresh slot state."""
    m = state.x.shape[0]
    _check_state(state, m)
    dev, flt = state.x.device, state.x.dtype
    out_f, out_i = _empty_planes(grid.nslots, flt, dev)
    overflow = state.overflow.clone()
    arrival = torch.empty(grid.ncell, dtype=torch.int32, device=dev)
    lo, L = _box_args(box)
    rc = _lib().rebin_full(
        int(flt == torch.float64),
        _ptrs([getattr(state, f) for f in FLOAT_FIELDS]),
        _ptrs([getattr(state, f) for f in INT_FIELDS]), m,
        _ptrs(out_f), _ptrs(out_i), grid.n_atoms, *grid.nc, grid.cap,
        lo, L, arrival.data_ptr(), overflow.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rebin kernel launch failed: CUDA error {rc}")
    LAUNCHES["rebin"] += 1
    return SlotState(overflow=overflow, therm=state.therm,
                     **dict(zip(FLOAT_FIELDS + INT_FIELDS, out_f + out_i)))
