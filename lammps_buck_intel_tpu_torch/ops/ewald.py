"""Launch wrappers of the Ewald kernels (csrc/ewald.cu): K11a ``ewald_sk``,
K11b ``ewald_force``, K11pa ``ewald_peratom`` and K11 traced
``ewald_traced`` (the tables of a box on the card; its plain version is
``models.kspace.ewald.traced_tables_plain``).

The plain version of the pair is ``models.kspace.ewald.
ewald_compute_plain``, of K11pa (after K11a)
``ewald_compute_peratom_plain``.  Each kernel splits its outer loop (the
atoms for K11a, the k vectors for K11b and K11pa) into ranges so that
about four blocks run on every SM, and adds the ranges in a fixed order:
the results do not depend on the order blocks run in.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import LAUNCHES
from . import build
from .cellpair import check_plane

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PREC = {(torch.float32, torch.float32): 0, (torch.float32, torch.float64): 1,
         (torch.float64, torch.float64): 2}
_THREADS = 128      # threads per block of the kernels (csrc/ewald.cu)
_ATOM_TILE = 256    # atoms per shared tile of K11a
_BLOCKS_PER_SM = 4


class SkResult(NamedTuple):
    s_re: torch.Tensor   # (K,) acc, sum_i q_i cos(k . x_i)
    s_im: torch.Tensor   # (K,) acc, sum_i q_i sin(k . x_i)
    wre: torch.Tensor    # (K,) flt, 2 ug Re
    wim: torch.Tensor    # (K,) flt, 2 ug Im
    sums: torch.Tensor   # (7,) acc: sum ug |S|^2, the six virial sums


def _lib():
    lib = build.load("ewald")
    if lib.ewald_sk.argtypes is None:
        lib.ewald_sum_rows.argtypes = [_I]
        lib.ewald_sk.argtypes = ([_I] + [_P] * 4 + [_I] + [_P] * 6
                                 + [_I, _I, _D] + [_P] * 5)
        lib.ewald_force.argtypes = ([_I] + [_P] * 4 + [_I] + [_P] * 5
                                    + [_I, _I, _D] + [_P] * 5)
        lib.ewald_peratom.argtypes = ([_I] + [_P] * 4 + [_I] + [_P] * 6
                                      + [_I, _I] + [_D] * 4 + [_P] * 4)
        lib.ewald_traced.argtypes = [_I, _P, _I, _P, _D] + [_P] * 5
        for fn in (lib.ewald_sum_rows, lib.ewald_sk, lib.ewald_force,
                   lib.ewald_peratom, lib.ewald_traced):
            fn.restype = _I
    return lib


def _splits(blocks: int, most: int, dev) -> int:
    """Ranges of the split loop: enough for _BLOCKS_PER_SM blocks an SM,
    at most ``most``."""
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    want = -(-_BLOCKS_PER_SM * nsm // blocks)
    return max(1, min(most, want))


def _inputs(xs, q, c, acc_dtype):
    dev, flt, n = xs[0].device, xs[0].dtype, xs[0].shape[0]
    if dev.type != "cuda":
        raise ValueError(f"ewald kernels need CUDA tensors, got {dev}")
    prec = _PREC.get((flt, acc_dtype))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc_dtype})")
    for p, name in zip(xs, "xyz"):
        check_plane(p, name, flt, n, dev)
    check_plane(q, "q", flt, n, dev)
    rows = c["kv_rows"]
    K = rows.shape[1]
    if rows.shape != (3, K) or not rows.is_contiguous():
        raise ValueError(f"kv_rows has shape {tuple(rows.shape)}")
    for i in range(3):
        check_plane(rows[i], f"kv_rows[{i}]", flt, K, dev)
    return dev, flt, n, K, prec, rows


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ewald_sk(xs, q, c: dict, qqrd2e: float, acc_dtype) -> SkResult:
    """K11a: the structure factors, the force weights and the energy and
    virial sums of the charges q at the positions xs = (x, y, z) planes;
    c: ``Ewald.consts`` of the planes' device and dtype."""
    dev, flt, n, K, prec, rows = _inputs(xs, q, c, acc_dtype)
    check_plane(c["ug"], "ug", flt, K, dev)
    check_plane(c["ug_acc"], "ug_acc", acc_dtype, K, dev)
    check_plane(c["vfac"].view(-1), "vfac", acc_dtype, 6 * K, dev)
    lib = _lib()
    nsplit = _splits(-(-K // _THREADS), -(-n // _ATOM_TILE), dev)
    part = torch.empty((2, nsplit, K), dtype=acc_dtype, device=dev)
    s = torch.empty((2, K), dtype=acc_dtype, device=dev)
    w = torch.empty((2, K), dtype=flt, device=dev)
    sums = torch.empty((lib.ewald_sum_rows(K), 7), dtype=acc_dtype,
                       device=dev)
    rc = lib.ewald_sk(
        prec, *(p.data_ptr() for p in xs), q.data_ptr(), n,
        *(r.data_ptr() for r in rows.unbind(0)), c["ug"].data_ptr(),
        c["ug_acc"].data_ptr(), c["vfac"].data_ptr(), K, nsplit,
        float(qqrd2e), part.data_ptr(), s.data_ptr(), w.data_ptr(),
        sums.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"ewald_sk kernel launch failed: CUDA error {rc}")
    LAUNCHES["ewald_sk"] += 1
    return SkResult(s[0], s[1], w[0], w[1], sums.sum(0))


def ewald_force(xs, q, c: dict, wre: torch.Tensor, wim: torch.Tensor,
                qqrd2e: float, acc_dtype) -> tuple:
    """K11b: (fx, fy, fz) acc planes, f_i = qqrd2e q_i sum_k (sin_ik wre_k
    - cos_ik wim_k) k, from K11a's weights."""
    dev, flt, n, K, prec, rows = _inputs(xs, q, c, acc_dtype)
    check_plane(wre, "wre", flt, K, dev)
    check_plane(wim, "wim", flt, K, dev)
    nsplit = _splits(-(-n // _THREADS), -(-K // _THREADS), dev)
    part = torch.empty((nsplit, 3, n), dtype=acc_dtype, device=dev)
    f = [torch.empty(n, dtype=acc_dtype, device=dev) for _ in range(3)]
    rc = _lib().ewald_force(
        prec, *(p.data_ptr() for p in xs), q.data_ptr(), n,
        *(r.data_ptr() for r in rows.unbind(0)), wre.data_ptr(),
        wim.data_ptr(), K, nsplit, float(qqrd2e), part.data_ptr(),
        *(t.data_ptr() for t in f), _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"ewald_force kernel launch failed: CUDA error {rc}")
    LAUNCHES["ewald_force"] += 1
    return tuple(f)


def ewald_peratom(xs, q, c: dict, s_re: torch.Tensor, s_im: torch.Tensor,
                  qqrd2e: float, acc_dtype, self_c: float, bg_c: float,
                  qsum: float):
    """K11pa: (eatom (N,), vatom (N, 6)) acc, the per-atom energy and virial
    from K11a's S(k) (s_re, s_im acc, rounded to flt here as the JAX
    package rounds them); c: ``Ewald.consts`` (its ``peratom_w``); self_c =
    g / sqrt(pi), bg_c = pi / (2 g^2 V)."""
    dev, flt, n, K, prec, rows = _inputs(xs, q, c, acc_dtype)
    re, im = s_re.to(flt).contiguous(), s_im.to(flt).contiguous()
    for t, name in ((re, "re"), (im, "im")):
        check_plane(t, name, flt, K, dev)
    w = c["peratom_w"]
    check_plane(w.view(-1), "peratom_w", flt, 7 * K, dev)
    nsplit = _splits(-(-n // _THREADS), -(-K // _THREADS), dev)
    part = torch.empty((nsplit, 7, n), dtype=acc_dtype, device=dev)
    eatom = torch.empty(n, dtype=acc_dtype, device=dev)
    vatom = torch.empty((n, 6), dtype=acc_dtype, device=dev)
    rc = _lib().ewald_peratom(
        prec, *(p.data_ptr() for p in xs), q.data_ptr(), n,
        *(r.data_ptr() for r in rows.unbind(0)), re.data_ptr(),
        im.data_ptr(), w.data_ptr(), K, nsplit, float(qqrd2e),
        float(self_c), float(bg_c), float(qsum), part.data_ptr(),
        eatom.data_ptr(), vatom.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"ewald_peratom kernel launch failed: CUDA error {rc}")
    LAUNCHES["ewald_peratom"] += 1
    return eatom, vatom


def ewald_traced(m_rows: torch.Tensor, boxL: torch.Tensor, g_ewald: float,
                 acc_dtype) -> dict:
    """K11 traced: the tables K11a and K11b read, for the box lengths boxL
    (3,) on the card and the fixed m triples m_rows (3, K) (both flt):
    {"kv_rows" (3, K) flt, "ug" (K,) flt, "ug_acc" (K,) acc, "vfac" (6,
    K) acc}."""
    dev, flt = m_rows.device, m_rows.dtype
    if dev.type != "cuda":
        raise ValueError(f"ewald kernels need CUDA tensors, got {dev}")
    prec = _PREC.get((flt, acc_dtype))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc_dtype})")
    K = m_rows.shape[1]
    if m_rows.shape != (3, K) or not m_rows.is_contiguous():
        raise ValueError(f"m_rows has shape {tuple(m_rows.shape)}")
    check_plane(boxL, "boxL", flt, 3, dev)
    kv = torch.empty((3, K), dtype=flt, device=dev)
    ug = torch.empty(K, dtype=flt, device=dev)
    ug_acc = torch.empty(K, dtype=acc_dtype, device=dev)
    vfac = torch.empty((6, K), dtype=acc_dtype, device=dev)
    rc = _lib().ewald_traced(prec, m_rows.data_ptr(), K, boxL.data_ptr(),
                             float(g_ewald) ** 2, kv.data_ptr(),
                             ug.data_ptr(), ug_acc.data_ptr(),
                             vfac.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"ewald_traced kernel launch failed: CUDA error {rc}")
    LAUNCHES["ewald_traced"] += 1
    return dict(kv_rows=kv, ug=ug, ug_acc=ug_acc, vfac=vfac)
