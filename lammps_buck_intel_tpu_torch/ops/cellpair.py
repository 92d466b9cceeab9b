"""Launch wrapper of the cell-pair force kernel (csrc/cellpair.cu).

The plain version of the same function is
``models.pair.cellpair.compute_cellpair_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from . import build
from ..utils import trace
from ..models.pair.cellpair import CellPairResult, check_style
from ..models.pair.styles import VDW_MODE

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PREC = {(torch.float32, torch.float32): 0, (torch.float32, torch.float64): 1,
         (torch.float64, torch.float64): 2}
# the kernel runs one thread per slot of a cell
MAX_CAP = 1024
# styles.PairConfig.coul -> the COUL template mode of csrc/pair_terms.cuh
COUL_MODE = {"none": 0, "long": 1, "cut": 2}


def _lib():
    lib = build.load("cellpair")
    if lib.cellpair_forces.argtypes is None:
        lib.cellpair_forces.argtypes = (
            [_I] * 5 + [_P] * 8 + [_I] * 7 + [_D] * 7 + [_P] * 2
            + [_I, _P] + [_P] * 7)
        lib.cellpair_forces.restype = _I
    return lib


# (device, acc dtype) -> the reaction planes of the last grid: scratch
# that every launch overwrites, so one allocation serves every call on a
# grid, and a new one is made only when the grid changes
_react: dict = {}


def _react_planes(grid, acc_dtype, dev) -> torch.Tensor:
    # K - 1 = 9 reach_z + 4 positive tiles, three planes each
    numel = (9 * grid.reach_z + 4) * 3 * grid.nslots
    buf = _react.get((dev, acc_dtype))
    if buf is None or buf.numel() != numel:
        buf = torch.empty(numel, dtype=acc_dtype, device=dev)
        _react[dev, acc_dtype] = buf
    return buf


def check_plane(t: torch.Tensor, name: str, dtype, numel: int, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or t.numel() != numel:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected ({numel},)")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def cellpair_forces(style, grid, box, state, *, eflag: bool, acc_dtype,
                    special=None, slot_mol=None) -> CellPairResult:
    """Half-stencil (Newton) pair forces on the card: K1, then the launch
    that adds the reaction planes to each slot's force.  eflag also
    computes evdwl, ecoul and the virial (the kernel's EV variant), each
    pair once; coul/long and coul/cut styles run the kernel's COUL
    variants, which read the slot q plane;
    lj/charmm and the lj/cut family their VDW variants, lj/long and
    buck/long (coul none or long) the DISP_LONG ones; a ``special`` partner table
    (``models.pair.cellpair.SpecialTable``) its SPECIAL variant; a
    ``slot_mol`` plane (int32 molecule ids, -1 on empty slots) excludes
    every pair of one molecule.  While the tracer is on the kernel adds
    its counters (candidates tested, pairs in range, evaluate lane slots)
    into ``trace.device_counts("cellpair", device)``."""
    check_style(style)
    dev = state.x.device
    if dev.type != "cuda":
        raise ValueError(f"cellpair kernel needs CUDA tensors, got {dev}")
    flt = state.x.dtype
    prec = _PREC.get((flt, acc_dtype))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc_dtype})")
    if grid.cap > MAX_CAP:
        raise ValueError(f"cell capacity {grid.cap} > {MAX_CAP}")
    ns = grid.nslots
    for name in ("x", "y", "z"):
        check_plane(getattr(state, name), name, flt, ns, dev)
    coul = COUL_MODE[style.cfg.coul]
    if coul:
        check_plane(state.q, "q", flt, ns, dev)
    for name in ("typ", "aid"):
        check_plane(getattr(state, name), name, torch.int32, ns, dev)
    if slot_mol is not None:
        check_plane(slot_mol, "slot_mol", torch.int32, ns, dev)
    disp_long = style.cfg.disp == "long"
    if disp_long and (style.cfg.vdw not in ("lj", "buck")
                      or style.cfg.coul not in ("none", "long")):
        raise NotImplementedError(
            "the cell-pair kernel's DISP_LONG variants are lj/long and "
            f"buck/long with coul none or long, not {style.cfg.vdw} with "
            f"coul {style.cfg.coul}")
    g6 = float(style.g_ewald_6)
    disp = (ctypes.c_double * 3)(g6 ** 2, g6 ** 6, g6 ** 8)
    coef = style.tables_on(flt, dev)
    ntypes = style.tables.shape[0]
    sp_ptr, sp_width, fac_ptr = None, 0, None
    if special is not None:
        sp_width = special.width
        if sp_width * grid.n_atoms >= 2**31:
            raise ValueError("special table too large for int32 offsets")
        check_plane(special.packed, "special.packed", torch.int32,
                    grid.n_atoms * sp_width, dev)
        fac = style.special_on(flt, dev)
        sp_ptr, fac_ptr = special.packed.data_ptr(), fac.data_ptr()
    fx, fy, fz = (torch.empty(ns, dtype=acc_dtype, device=dev)
                  for _ in range(3))
    react = _react_planes(grid, acc_dtype, dev)
    partial = (torch.empty((grid.ncell, 8), dtype=acc_dtype, device=dev)
               if eflag else None)
    L = [float(v) for v in box.lengths]
    counts = trace.device_counts("cellpair", dev)
    rc = _lib().cellpair_forces(
        prec, int(eflag), int(coul), VDW_MODE[style.cfg.vdw], int(disp_long),
        state.x.data_ptr(), state.y.data_ptr(),
        state.z.data_ptr(), state.q.data_ptr() if coul else None,
        state.typ.data_ptr(), state.aid.data_ptr(),
        None if slot_mol is None else slot_mol.data_ptr(), coef.data_ptr(),
        ntypes, grid.n_atoms, *grid.nc, grid.cap, grid.reach_z, *L,
        float(style.g_ewald), float(style.qqrd2e), float(style.inner_sq),
        float(style.denom_lj), ctypes.cast(disp, _P), sp_ptr, sp_width,
        fac_ptr, fx.data_ptr(), fy.data_ptr(), fz.data_ptr(),
        react.data_ptr(), partial.data_ptr() if eflag else None,
        None if counts is None else counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cellpair kernel launch failed: CUDA error {rc} "
                           f"(cap {grid.cap}, {flt} / {acc_dtype})")
    LAUNCHES["cellpair"] += 1
    zero = torch.zeros((), dtype=acc_dtype, device=dev)
    if not eflag:
        return CellPairResult(fx, fy, fz, zero, zero,
                              torch.zeros(6, dtype=acc_dtype, device=dev))
    tot = partial.sum(0)
    return CellPairResult(fx, fy, fz, tot[0], tot[1], tot[2:8])
