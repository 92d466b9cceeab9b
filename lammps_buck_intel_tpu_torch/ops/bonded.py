"""Launch wrappers of the bonded kernels (csrc/bonded.cu).

The plain version of the same function is
``models.bonded.harmonic.compute_bonded_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from . import build
from .cellpair import check_plane
from ..models.bonded.harmonic import BondedResult

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PREC = {(torch.float32, torch.float32): 0, (torch.float32, torch.float64): 1,
         (torch.float64, torch.float64): 2}
# threads per block in csrc/bonded.cu: one row of partials per block
THREADS = 128


def _lib():
    lib = build.load("bonded")
    if lib.bonded_bond_angle.argtypes is None:
        head, tail = [_I, _I] + [_P] * 4, [_D] * 3 + [_P] * 6
        lib.bonded_bond_angle.argtypes = (
            head + [_P, _I, _P, _P, _I, _P] + tail)
        lib.dihedral_charmm.argtypes = head + [_P, _I, _P, _P, _P] + tail
        lib.improper_harmonic.argtypes = head + [_P, _I, _P] + tail
        for fn in (lib.bonded_bond_angle, lib.dihedral_charmm,
                   lib.improper_harmonic):
            fn.restype = _I
    return lib


def _partials(nterms: int, ncols: int, eflag: bool, acc_dtype, dev):
    if not eflag:
        return None, None
    blocks = (nterms + THREADS - 1) // THREADS
    p = torch.empty((blocks, ncols), dtype=acc_dtype, device=dev)
    return p, p.data_ptr()


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def compute_bonded(style, xs, box, *, eflag: bool, acc_dtype, inv=None,
                   out=None) -> BondedResult:
    """Bonded forces on the card: one launch each of bonded_bond_angle,
    dihedral_charmm and improper_harmonic (those with terms), which add
    their forces to ``out`` with atomics; eflag also reduces the energies
    and the virial (per-block partials, summed here)."""
    dev, flt = xs[0].device, xs[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"bonded kernels need CUDA tensors, got {dev}")
    prec = _PREC.get((flt, acc_dtype))
    if prec is None:
        raise TypeError(f"unsupported (flt, acc) = ({flt}, {acc_dtype})")
    m = xs[0].shape[0]
    for p, name in zip(xs, "xyz"):
        check_plane(p, name, flt, m, dev)
    if out is None:
        out = tuple(torch.zeros(m, dtype=acc_dtype, device=dev)
                    for _ in range(3))
    for p, name in zip(out, ("fx", "fy", "fz")):
        check_plane(p, name, acc_dtype, m, dev)
    if inv is not None:
        if inv.device != dev or inv.dtype != torch.int32 \
                or not inv.is_contiguous():
            raise TypeError("inv must be a contiguous int32 tensor on the "
                            "device of the planes")
    t = style.tables_on(dev, flt)
    nb, na = len(style.bonds), len(style.angles)
    nd, ni = len(style.dihedrals), len(style.impropers)
    head = [xs[0].data_ptr(), xs[1].data_ptr(), xs[2].data_ptr(),
            None if inv is None else inv.data_ptr()]
    if isinstance(box, torch.Tensor):
        # the variable-cell path: the kernels read the lengths on the card
        check_plane(box, "box lengths", flt, 3, dev)
        L = [1.0, 1.0, 1.0, box.data_ptr()]
    else:
        L = [float(v) for v in box.lengths] + [None]
    forces = [p.data_ptr() for p in out]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    zero = torch.zeros((), dtype=acc_dtype, device=dev)
    ebond = eangle = edihed = eimp = e14_lj = e14_coul = zero
    virial = torch.zeros(6, dtype=acc_dtype, device=dev)

    if nb + na:
        part, ptr = _partials(nb + na, 8, eflag, acc_dtype, dev)
        _check(lib.bonded_bond_angle(
            prec, int(eflag), *head, t["bonds"].data_ptr(), nb,
            t["bond_coef"].data_ptr(), t["angles"].data_ptr(), na,
            t["angle_coef"].data_ptr(), *L, *forces, ptr, stream),
            "bonded_bond_angle")
        if eflag:
            tot = part.sum(0)
            ebond, eangle, virial = tot[0], tot[1], virial + tot[2:8]
    if nd:
        part, ptr = _partials(nd, 9, eflag, acc_dtype, dev)
        _check(lib.dihedral_charmm(
            prec, int(eflag), *head, t["dihedrals"].data_ptr(), nd,
            t["dihedral_coef"].data_ptr(), t["dihedral_mult"].data_ptr(),
            None if t["d14"] is None else t["d14"].data_ptr(), *L, *forces,
            ptr, stream), "dihedral_charmm")
        if eflag:
            tot = part.sum(0)
            edihed, e14_lj, e14_coul = tot[0], tot[1], tot[2]
            virial = virial + tot[3:9]
    if ni:
        part, ptr = _partials(ni, 7, eflag, acc_dtype, dev)
        _check(lib.improper_harmonic(
            prec, int(eflag), *head, t["impropers"].data_ptr(), ni,
            t["improper_coef"].data_ptr(), *L, *forces, ptr, stream),
            "improper_harmonic")
        if eflag:
            tot = part.sum(0)
            eimp, virial = tot[0], virial + tot[1:7]
    return BondedResult(fx=out[0], fy=out[1], fz=out[2], ebond=ebond,
                        eangle=eangle, virial=virial, edihed=edihed,
                        eimp=eimp, e14_lj=e14_lj, e14_coul=e14_coul)
