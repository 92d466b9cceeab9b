"""Pair force pass over a full neighbor list: gather, per-pair terms,
row sums.

Counterpart of ``lammps_buck_intel_tpu.models.pair.driver`` (``PairResult``,
``gather_coefs``, ``_select_small``, ``compute_pair``) for the port's pair
styles (buck, buck/coul/{long,cut}, lj/charmm/coul/{long,cut}, the lj/cut
family, and buck/long and lj/long with coul none or long), with special-bond codes
from the list and the box as a (3,) tensor of lengths (the variable cell of
the NPT engine, never read back to the host).  Each pair is visited from
both sides, so forces need no scatter and energies and the virial are
halved.  The per-pair physics is ``styles.pair_terms``.

On CUDA planes ``compute_pair`` launches csrc/nlist.cu's pair kernel
(``ops.nlist.compute_pair``), on CPU planes it runs
``compute_pair_plain``.  ``compute_pair_peratom`` (per-atom energies and
virials, the tallies of compute pe/atom and stress/atom) launches the same
kernel's per-atom variant (K9d, ``ops.nlist.compute_pair_peratom``) on
CUDA planes and runs ``compute_pair_peratom_plain`` on CPU planes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...core.box import minimum_image_planes
from .styles import COEF_NAMES, PairStyle, check_ported, pair_terms

# atoms per chunk of the plain pass: bounds the (chunk, K) temporaries
_CHUNK = 1 << 15


class PairResult(NamedTuple):
    fx: torch.Tensor      # (N,) forces, acc dtype
    fy: torch.Tensor
    fz: torch.Tensor
    evdwl: torch.Tensor   # () scalar
    ecoul: torch.Tensor   # ()
    virial: torch.Tensor  # (6,) xx yy zz xy xz yz


def _select_small(table_1d: np.ndarray, key: torch.Tensor, dtype):
    """out[p] = table_1d[key[p]] for a tiny host table; a python float when
    every entry is the same."""
    vals = [float(v) for v in np.asarray(table_1d)]
    if all(v == vals[0] for v in vals):
        return vals[0]
    t = torch.as_tensor(vals, dtype=torch.float64).to(key.device, dtype)
    return t[key.long()]


def gather_coefs(tables: np.ndarray, ti: torch.Tensor, tj, dtype) -> dict:
    """(T, T, NCOEF) host tables + type indices -> per-pair coefficient
    planes (python floats for a single type)."""
    ntypes = tables.shape[0]
    flat = np.asarray(tables).reshape(ntypes * ntypes, tables.shape[-1])
    if ntypes == 1:
        return {name: float(flat[0, ci]) for ci, name in enumerate(COEF_NAMES)}
    key = ti.long() * ntypes + tj.long()
    return {name: _select_small(flat[:, ci], key, dtype)
            for ci, name in enumerate(COEF_NAMES)}


def compute_pair_plain(style: PairStyle, x: torch.Tensor, typ, q, boxL, nl,
                       *, eflag: bool = True, acc_dtype=torch.float32,
                       use_special: bool = True) -> PairResult:
    """Plain torch version (any device): x (3, N) positions, typ (N,)
    int32, q (N,) charges, boxL (3,) lengths, nl a NeighborList."""
    check_ported(style)
    flt, dev = x.dtype, x.device
    n = x.shape[1]
    out = [torch.empty(n, dtype=acc_dtype, device=dev) for _ in range(3)]
    ev = torch.zeros(2, dtype=acc_dtype, device=dev)
    vir = torch.zeros(6, dtype=acc_dtype, device=dev)
    for a0 in range(0, n, _CHUNK):
        a1 = min(n, a0 + _CHUNK)
        j = nl.idx[a0:a1].long()
        mask = j < n
        j_safe = torch.clamp(j, max=n - 1)
        d = list(minimum_image_planes(
            *(x[ax, a0:a1, None] - x[ax][j_safe] for ax in range(3)), boxL))
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        rsq = torch.where(mask, rsq, torch.full_like(rsq, 1e30))
        coef = gather_coefs(style.tables, typ[a0:a1, None], typ[j_safe], flt)
        if style.cfg.has_coul:
            qi, qj = q[a0:a1, None], q[j_safe]
        else:
            qi = qj = 0.0
        if use_special:
            sb = nl.sb[a0:a1].long()
            f_lj = _select_small(style.special_lj, sb, flt)
            f_coul = _select_small(style.special_coul, sb, flt)
        else:
            f_lj = f_coul = 1.0
        fs, evdwl, ecoul = pair_terms(style, rsq, coef, qi, qj, f_lj, f_coul,
                                      eflag=eflag)
        fs = torch.where(mask, fs, torch.zeros_like(fs))
        for c in range(3):
            out[c][a0:a1] = (fs * d[c]).to(acc_dtype).sum(1)
        if eflag:
            zero = torch.zeros_like(evdwl)
            ev = ev + torch.stack([
                torch.where(mask, evdwl, zero).to(acc_dtype).sum(),
                torch.where(mask, ecoul, zero).to(acc_dtype).sum()])
        w = fs * 0.5
        vir = vir + torch.stack([
            (w * d[a] * d[b]).to(acc_dtype).sum()
            for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])
    return PairResult(out[0], out[1], out[2], 0.5 * ev[0], 0.5 * ev[1], vir)


def compute_pair(style: PairStyle, x: torch.Tensor, typ, q, boxL, nl, *,
                 eflag: bool = True, acc_dtype=torch.float32,
                 use_special: bool = True) -> PairResult:
    """Forces on every atom from its list and the 6-virial (the barostat
    reads it every step), with eflag evdwl and ecoul, each in
    ``acc_dtype``.  x: (3, N) position
    planes; boxL: (3,) box lengths on x's device (the minimum image of the
    current, possibly dilated, box); nl: a ``neighbor_list.NeighborList``
    built on x's device; use_special: apply the special-bond factors of the
    list's codes."""
    if x.is_cuda:
        from ...ops import nlist as nlist_ops

        check_ported(style)
        f, evdwl, ecoul, virial = nlist_ops.compute_pair(
            style, tuple(x.unbind(0)), typ, q, boxL, nl, eflag=eflag,
            acc_dtype=acc_dtype, use_special=use_special)
        return PairResult(*f, evdwl, ecoul, virial)
    if x.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {x.device}")
    return compute_pair_plain(style, x, typ, q, boxL, nl, eflag=eflag,
                              acc_dtype=acc_dtype, use_special=use_special)


def compute_pair_peratom_plain(style: PairStyle, x: torch.Tensor, typ, q,
                               boxL, nl, *, acc_dtype=torch.float32,
                               use_special: bool = True):
    """Plain torch version of ``compute_pair_peratom`` (any device), the JAX
    ``compute_pair_peratom`` over chunks of atoms."""
    check_ported(style)
    flt, dev = x.dtype, x.device
    n = x.shape[1]
    eatom = torch.empty(n, dtype=acc_dtype, device=dev)
    vatom = torch.empty((n, 6), dtype=acc_dtype, device=dev)
    for a0 in range(0, n, _CHUNK):
        a1 = min(n, a0 + _CHUNK)
        j = nl.idx[a0:a1].long()
        mask = j < n
        j_safe = torch.clamp(j, max=n - 1)
        d = list(minimum_image_planes(
            *(x[ax, a0:a1, None] - x[ax][j_safe] for ax in range(3)), boxL))
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        rsq = torch.where(mask, rsq, torch.full_like(rsq, 1e30))
        coef = gather_coefs(style.tables, typ[a0:a1, None], typ[j_safe], flt)
        if style.cfg.has_coul:
            qi, qj = q[a0:a1, None], q[j_safe]
        else:
            qi = qj = 0.0
        if use_special:
            sb = nl.sb[a0:a1].long()
            f_lj = _select_small(style.special_lj, sb, flt)
            f_coul = _select_small(style.special_coul, sb, flt)
        else:
            f_lj = f_coul = 1.0
        fs, evdwl, ecoul = pair_terms(style, rsq, coef, qi, qj, f_lj, f_coul,
                                      eflag=True)
        zero = torch.zeros_like(fs)
        epair = torch.where(mask, evdwl + ecoul, zero).to(acc_dtype)
        eatom[a0:a1] = 0.5 * epair.sum(1)
        w = torch.where(mask, fs, zero) * 0.5
        vatom[a0:a1] = torch.stack([
            (w * d[a] * d[b]).to(acc_dtype).sum(1)
            for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))],
            -1)
    return eatom, vatom


def compute_pair_peratom(style: PairStyle, x: torch.Tensor, typ, q, boxL,
                         nl, *, acc_dtype=torch.float32,
                         use_special: bool = True):
    """Per-atom pair energy and virial (the eflag_atom / vflag_atom contract
    of pair_buck_intel.cpp:303-322): each atom receives half of every pair
    term on its row of the full list.  Returns (eatom (N,), vatom (N, 6))
    in ``acc_dtype``; arguments as ``compute_pair``.  CUDA planes launch
    K9d, CPU planes run ``compute_pair_peratom_plain``."""
    if x.is_cuda:
        from ...ops import nlist as nlist_ops

        check_ported(style)
        return nlist_ops.compute_pair_peratom(
            style, tuple(x.unbind(0)), typ, q, boxL, nl, acc_dtype=acc_dtype,
            use_special=use_special)
    if x.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {x.device}")
    return compute_pair_peratom_plain(style, x, typ, q, boxL, nl,
                                      acc_dtype=acc_dtype,
                                      use_special=use_special)
