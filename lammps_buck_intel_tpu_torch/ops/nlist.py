"""Launch wrappers of the neighbor-list kernels (csrc/nlist.cu).

The plain versions of the same functions are
``neighbor.neighbor_list.build_cell_plain``,
``neighbor.neighbor_list.build_dense_plain``,
``models.pair.driver.compute_pair_plain`` and
``models.pair.driver.compute_pair_peratom_plain``.  Lists are K-major on the card:
``NeighborList.idx`` and ``.sb`` are (N, K) views of contiguous (K, N)
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from . import build
from .cellpair import COUL_MODE, check_plane
from ..models.pair.styles import VDW_MODE

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PREC = {(torch.float32, torch.float32): 0, (torch.float32, torch.float64): 1,
         (torch.float64, torch.float64): 2}


def _lib():
    lib = build.load("nlist")
    if lib.nlist_build.argtypes is None:
        lib.nlist_partial_rows.argtypes = [_I]
        lib.nlist_build.argtypes = ([_I] + [_P] * 4 + [_I] * 5 + [_P, _P, _D, _I]
                                    + [_P, _P, _I] + [_P] * 5)
        lib.nlist_dense.argtypes = ([_I] + [_P] * 4 + [_I, _D, _I, _P, _P, _I]
                                    + [_P] * 5)
        lib.nlist_pair.argtypes = ([_I] * 6 + [_P] * 7 + [_I, _I] + [_P] * 3
                                   + [_I] + [_D] * 4 + [_P] * 7)
        lib.nlist_pair_peratom.argtypes = ([_I] * 5 + [_P] * 7 + [_I, _I]
                                           + [_P] * 3 + [_I] + [_D] * 4
                                           + [_P] * 5)
        for fn in (lib.nlist_partial_rows, lib.nlist_build, lib.nlist_dense,
                   lib.nlist_pair, lib.nlist_pair_peratom):
            fn.restype = _I
    return lib


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _positions(xs):
    dev, flt, n = xs[0].device, xs[0].dtype, xs[0].shape[0]
    if dev.type != "cuda":
        raise ValueError(f"nlist kernels need CUDA tensors, got {dev}")
    if flt not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported position dtype {flt}")
    for p, name in zip(xs, "xyz"):
        check_plane(p, name, flt, n, dev)
    return dev, flt, n


def _special_args(special, n: int, dev):
    if special is None:
        return None, None, 0
    sp_i, sp_c = special
    nsp = sp_i.shape[1]
    for t, name in ((sp_i, "special_idx"), (sp_c, "special_code")):
        check_plane(t.view(-1), name, torch.int32, n * nsp, dev)
    return sp_i.data_ptr(), sp_c.data_ptr(), nsp


def _list_outputs(kmax: int, n: int, dev):
    return (torch.empty((kmax, n), dtype=torch.int32, device=dev),
            torch.empty((kmax, n), dtype=torch.int8, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def build_dense(xs, boxL: torch.Tensor, spec, special):
    """The dense O(N^2) build on the card (K9c): returns (idx_t (K, N)
    int32, sb_t (K, N) int8, nnei (N,) int32, overflow (1,) int32) as
    ``build_cell``, the columns in ascending j.  boxL: (3,) box lengths in
    the planes' dtype; special as in ``build_cell``."""
    dev, flt, n = _positions(xs)
    check_plane(boxL, "boxL", flt, 3, dev)
    kmax = min(spec.kmax, n)
    idx_t, sb_t, nnei, overflow = _list_outputs(kmax, n, dev)
    sp_i, sp_c, nsp = _special_args(special, n, dev)
    _check(_lib().nlist_dense(
        int(flt == torch.float64), *(p.data_ptr() for p in xs),
        boxL.data_ptr(), n, float(spec.cutneigh) ** 2, kmax, sp_i, sp_c, nsp,
        idx_t.data_ptr(), sb_t.data_ptr(), nnei.data_ptr(),
        overflow.data_ptr(), _stream(dev)), "nlist_dense")
    return idx_t, sb_t, nnei, overflow


def build_cell(xs, geo: torch.Tensor, spec, special):
    """The binned build on the card: returns (idx_t (K, N) int32, sb_t (K,
    N) int8, nnei (N,) int32, overflow (1,) int32, 1 where a cell or a row
    overflowed).  geo: (6,) lo and lengths of the box, in the planes'
    dtype; special: None or the (N, S) int32 (special_idx, special_code)
    pair."""
    dev, flt, n = _positions(xs)
    check_plane(geo, "geo", flt, 6, dev)
    ncx, ncy, ncz = spec.nc
    ncell, cap, kmax = ncx * ncy * ncz, spec.cell_cap, spec.kmax
    count = torch.zeros(ncell, dtype=torch.int32, device=dev)
    cells = torch.empty(ncell * cap, dtype=torch.int32, device=dev)
    idx_t, sb_t, nnei, overflow = _list_outputs(kmax, n, dev)
    sp_i, sp_c, nsp = _special_args(special, n, dev)
    _check(_lib().nlist_build(
        int(flt == torch.float64), *(p.data_ptr() for p in xs),
        geo.data_ptr(), n, ncx, ncy, ncz, cap, count.data_ptr(),
        cells.data_ptr(), float(spec.cutneigh) ** 2, kmax, sp_i, sp_c, nsp,
        idx_t.data_ptr(), sb_t.data_ptr(), nnei.data_ptr(),
        overflow.data_ptr(), _stream(dev)), "nlist_build")
    return idx_t, sb_t, nnei, overflow


def compute_pair(style, xs, typ, q, boxL, nl, *, eflag: bool, acc_dtype,
                 use_special: bool):
    """The pair pass on the card: ((fx, fy, fz) acc, evdwl, ecoul, virial
    (6,)), energies and virial halved (each pair is visited twice)."""
    dev, flt, n = _positions(xs)
    prec = _PREC.get((flt, acc_dtype))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc_dtype})")
    lib = _lib()
    out = [torch.empty(n, dtype=acc_dtype, device=dev) for _ in range(3)]
    part = torch.empty((lib.nlist_partial_rows(n), 8), dtype=acc_dtype,
                       device=dev)
    args = _pair_args(style, xs, typ, q, boxL, nl, dev, flt, n)
    _check(lib.nlist_pair(
        prec, int(eflag), *args[:3], int(use_special), *args[3:],
        *(f.data_ptr() for f in out), part.data_ptr(),
        _stream(dev)), "nlist_pair")
    tot = part.sum(0) * 0.5
    return tuple(out), tot[0], tot[1], tot[2:8]


def compute_pair_peratom(style, xs, typ, q, boxL, nl, *, acc_dtype,
                         use_special: bool):
    """K9d, the per-atom pass on the card: (eatom (N,), vatom (N, 6)) in
    acc, half of every pair term on each atom's row; (flt, acc) = (f32,
    f32) or (f64, f64)."""
    dev, flt, n = _positions(xs)
    prec = {(torch.float32, torch.float32): 0,
            (torch.float64, torch.float64): 2}.get((flt, acc_dtype))
    if prec is None:
        raise TypeError(f"the per-atom pass takes (f32, f32) or (f64, f64), "
                        f"not ({flt}, {acc_dtype})")
    eatom = torch.empty(n, dtype=acc_dtype, device=dev)
    vatom = torch.empty((n, 6), dtype=acc_dtype, device=dev)
    args = _pair_args(style, xs, typ, q, boxL, nl, dev, flt, n)
    _check(_lib().nlist_pair_peratom(
        prec, *args[:3], int(use_special), *args[3:], eatom.data_ptr(),
        vatom.data_ptr(), _stream(dev)), "nlist_pair_peratom")
    return eatom, vatom


def _pair_args(style, xs, typ, q, boxL, nl, dev, flt, n):
    """The arguments the two pair passes share after the variant flags:
    (coul, vdw, disp_long, then from x to special_fac), the inputs
    checked."""
    cfg = style.cfg
    disp_long = cfg.disp == "long"
    if disp_long and (cfg.vdw not in ("lj", "buck")
                      or cfg.coul not in ("none", "long")):
        raise NotImplementedError(
            "the list pair pass's DISP_LONG variants are lj/long and "
            f"buck/long with coul none or long, not {cfg.vdw} with coul "
            f"{cfg.coul}")
    check_plane(typ, "typ", torch.int32, n, dev)
    check_plane(boxL, "boxL", flt, 3, dev)
    coul = COUL_MODE[cfg.coul]
    if coul:
        check_plane(q, "q", flt, n, dev)
    idx_t, sb_t = nl.idx.t(), nl.sb.t()
    kmax = idx_t.shape[0]
    for t, name, dt in ((idx_t, "idx", torch.int32), (sb_t, "sb", torch.int8)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be K-major (a view of a "
                             "contiguous (K, N) tensor)")
        check_plane(t.view(-1), name, dt, kmax * n, dev)
    check_plane(nl.nnei, "nnei", torch.int32, n, dev)
    coef = style.tables_on(flt, dev)
    fac = style.special_on(flt, dev)
    g6 = float(style.g_ewald_6)
    disp = (ctypes.c_double * 3)(g6 ** 2, g6 ** 6, g6 ** 8)
    return (coul, VDW_MODE[cfg.vdw], int(disp_long),
            *(p.data_ptr() for p in xs), q.data_ptr() if coul else None,
            typ.data_ptr(), boxL.data_ptr(), coef.data_ptr(),
            style.tables.shape[0], n, idx_t.data_ptr(), sb_t.data_ptr(),
            nl.nnei.data_ptr(), kmax, float(style.g_ewald),
            float(style.qqrd2e), float(style.inner_sq),
            float(style.denom_lj), ctypes.cast(disp, _P),
            fac.data_ptr())
