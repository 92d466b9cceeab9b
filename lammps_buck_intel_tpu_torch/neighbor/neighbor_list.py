"""Fixed-shape neighbor lists in atom order, for the neighbor-list engines.

Counterpart of ``lammps_buck_intel_tpu.neighbor.neighbor_list``: full
lists (every pair stored from both sides), a static per-atom capacity K
with the sentinel index N for padding, special-bond codes as data (0 none,
1/2/3 for 1-2/1-3/1-4) and a sticky overflow flag that a capacity overrun
raises, never a silent drop.  ``make_spec`` sizes the capacities on the
host (the get_max_nbors analog), ``grow`` bumps them, ``build_with_retry``
grows at set-up until the build fits.

Positions are (3, N) planes and the box comes as its lower corner ``lo``
and lengths ``L``, (3,) tensors on the planes' device, so the NPT engine
builds lists under a box that never leaves the card (the static-box
``Simulation`` holds its box there as constant tensors).

``build_cell`` (the binned build) and ``build_dense`` (the O(N^2) build of
N <= 512 or fewer than 3 cells per axis) launch the CUDA builds of
csrc/nlist.cu on CUDA planes and run ``build_cell_plain`` /
``build_dense_plain`` on CPU planes.  They keep the candidates within
cutneigh in scan order: the binned build the 27 cells around the atom's
own in the JAX stencil order, each cell's atoms in ascending id; the dense
build ascending j.  The JAX package keeps the K nearest instead (top_k on
rsq): without overflow both keep the same set, in another column order,
and overflow raises.  The list is K-major on both: ``idx`` and ``sb`` are
(N, K) views of contiguous (K, N) tensors, so the kernels' neighbouring
threads read neighbouring words.  ``needs_rebuild`` (the displacement
test of LAMMPS' ``check yes``) is a plain function: neither engine calls
it, as the JAX engines do not; ``check yes`` runs as the vmax cadence.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

# atoms per chunk of the plain build: bounds the (chunk, 27 cap)
# candidate temporaries
_CHUNK = 1 << 13


class NeighborList(NamedTuple):
    """idx: (N, K) int32 neighbor indices, sentinel N for padding.
    sb: (N, K) int8 special-bond code (0 = plain pair).
    nnei: (N,) int32 neighbors found (may exceed K on overflow).
    overflow: () bool tensor, any capacity exceeded.
    (The JAX list's x0, the positions at build time, feeds
    ``needs_rebuild``; the engines update positions in place, so a caller
    of ``needs_rebuild`` keeps its own copy.)"""

    idx: torch.Tensor
    sb: torch.Tensor
    nnei: torch.Tensor
    overflow: torch.Tensor

    @property
    def kmax(self) -> int:
        return self.idx.shape[1]


@dataclasses.dataclass(frozen=True)
class NeighborSpec:
    """Static build configuration.

    cutneigh: interaction cutoff + skin (times any headroom).
    kmax: neighbor capacity per atom.
    nc: cells per axis, or None for the dense build.
    cell_cap: max atoms per cell.
    (The JAX spec's tile sizes its TPU candidate loop; no build here
    reads one.)"""

    cutneigh: float
    kmax: int
    nc: Optional[tuple]
    cell_cap: int

    @property
    def dense(self) -> bool:
        return self.nc is None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# the sizing's margin over the mean density (the JAX package's default)
_SAFETY = 1.45


def make_spec(n_atoms: int, box_lengths, cutneigh: float) -> NeighborSpec:
    """Host-side capacity sizing, the JAX package's rule for an orthogonal
    box: cells per axis floor(L / cutneigh); the dense build for N <= 512
    or fewer than 3 cells per axis; K from the mean density times
    ``_SAFETY``, in steps of 8."""
    L = np.asarray(box_lengths, dtype=np.float64)
    vol = float(np.prod(L))
    density = n_atoms / vol
    nc = tuple(int(max(1, np.floor(w / cutneigh))) for w in L)
    # fewer than 3 cells per axis makes the 27-cell stencil visit a cell
    # twice through the periodic wrap
    use_dense = n_atoms <= 512 or min(nc) < 3
    expect = density * (4.0 / 3.0) * math.pi * cutneigh**3
    kmax = min(_round_up(max(8, int(expect * _SAFETY) + 4), 8), n_atoms)
    if use_dense:
        return NeighborSpec(cutneigh=float(cutneigh), kmax=int(kmax), nc=None,
                            cell_cap=0)
    cell_vol = vol / float(np.prod(nc))
    cell_cap = _round_up(max(4, int(density * cell_vol * _SAFETY) + 4), 4)
    return NeighborSpec(cutneigh=float(cutneigh), kmax=int(kmax), nc=nc,
                        cell_cap=int(cell_cap))


def grow(spec: NeighborSpec, observed_max: Optional[int] = None
         ) -> NeighborSpec:
    """Overflow response: bump K (past the observed maximum when given)
    and the cell capacity, in quantized steps."""
    target = int(spec.kmax * 1.25) + 8
    if observed_max is not None:
        target = max(target, int(observed_max * 1.1) + 8)
    return dataclasses.replace(
        spec, kmax=_round_up(target, 8),
        cell_cap=(_round_up(int(spec.cell_cap * 1.25) + 4, 4)
                  if spec.cell_cap else 0))


# 27-cell stencil in the JAX package's order (z fastest)
_OFFSETS = np.array([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], dtype=np.int64)


def _special_codes(idx, special_idx, special_code):
    """(..., K) neighbor ids x (..., S) partners -> (..., K) int8 codes,
    the sum of the codes of the partner entries equal to each id."""
    if special_idx is None or special_idx.shape[-1] == 0:
        return torch.zeros(idx.shape, dtype=torch.int8, device=idx.device)
    match = idx[..., :, None] == special_idx[..., None, :].to(idx.dtype)
    codes = torch.where(match, special_code[..., None, :].to(torch.int32),
                        0).sum(-1)
    return codes.to(torch.int8)


def _image_div(d, L):
    """The build's minimum image d - round(d / L) L (a division, as the JAX
    package's core/box.py minimum_image)."""
    return d - torch.round(d / L) * L


def _kmajor(idx, sb):
    """(N, K) views of contiguous (K, N) copies."""
    return idx.t().contiguous().t(), sb.t().contiguous().t()


def build_dense_plain(x: torch.Tensor, lo: torch.Tensor, L: torch.Tensor,
                      spec: NeighborSpec, special=None) -> NeighborList:
    """O(N^2) masked build in torch ops (any device): the minimum-imaged
    rsq of every pair, then per atom the first K j != i within cutneigh
    in ascending j (K9c's columns; the JAX package's top_k keeps the same
    set without overflow)."""
    n = x.shape[1]
    k = min(spec.kmax, n)
    Lt = L.to(x.dtype)
    d = [_image_div(x[a][:, None] - x[a][None, :], Lt[a]) for a in range(3)]
    rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    cutsq = torch.tensor(spec.cutneigh ** 2, dtype=x.dtype, device=x.device)
    valid = (rsq <= cutsq) & ~torch.eye(n, dtype=torch.bool, device=x.device)
    pick = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)[:, :k]
    keep = torch.gather(valid, 1, pick)
    idx = torch.where(keep, pick, n).to(torch.int32)
    nnei = valid.sum(1).to(torch.int32)
    sp_i, sp_c = special if special is not None else (None, None)
    sb = _special_codes(idx, sp_i, sp_c)
    idx, sb = _kmajor(idx, sb)
    return NeighborList(idx=idx, sb=sb, nnei=nnei,
                        overflow=(nnei > k).any())


def build_dense(x: torch.Tensor, lo: torch.Tensor, L: torch.Tensor,
                spec: NeighborSpec, special=None) -> NeighborList:
    """The dense build: the CUDA kernel (K9c) on CUDA planes, the plain
    version on CPU planes; arguments as ``build_cell`` (``lo`` is not
    read: the minimum image needs only the lengths)."""
    if x.is_cuda:
        from ..ops import nlist as nlist_ops

        idx_t, sb_t, nnei, flag = nlist_ops.build_dense(
            tuple(x.unbind(0)), L.to(x.dtype), spec, special)
        return NeighborList(idx=idx_t.t(), sb=sb_t.t(), nnei=nnei,
                            overflow=flag[0] > 0)
    if x.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {x.device}")
    return build_dense_plain(x, lo, L, spec, special)


def build_cell_plain(x: torch.Tensor, lo: torch.Tensor, L: torch.Tensor,
                     spec: NeighborSpec, special=None) -> NeighborList:
    """Binned build in torch ops (any device): fold into [0, 1), cell per
    atom, a stable sort into (ncell, cap) slots, then per atom the 27
    cells' candidates within cutneigh in scan order."""
    dev, flt = x.device, x.dtype
    n = x.shape[1]
    ncx, ncy, ncz = spec.nc
    ncell, cap, k = ncx * ncy * ncz, spec.cell_cap, spec.kmax
    nc = torch.tensor(spec.nc, dtype=torch.int64, device=dev)
    lo_t, Lt = lo.to(flt)[:, None], L.to(flt)[:, None]
    s = (x - lo_t) / Lt
    s = s - torch.floor(s)
    ci = torch.minimum(torch.clamp((s * nc[:, None].to(flt)).to(torch.int64),
                                   min=0), nc[:, None] - 1)
    cid = (ci[0] * ncy + ci[1]) * ncz + ci[2]
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    count = torch.bincount(cid, minlength=ncell)
    starts = torch.cumsum(count, 0) - count
    rank = torch.arange(n, device=dev) - starts[cid_sorted]
    ok = rank < cap
    cells = torch.full((ncell * cap + 1,), n, dtype=torch.int64, device=dev)
    slot = torch.where(ok, cid_sorted * cap + rank, ncell * cap)
    cells[slot] = order
    cells = cells[:ncell * cap].view(ncell, cap)
    cell_overflow = (~ok).any()

    offs = torch.as_tensor(_OFFSETS, device=dev)
    cutsq = torch.tensor(spec.cutneigh ** 2, dtype=flt, device=dev)
    x_pad = torch.cat([x, torch.zeros((3, 1), dtype=flt, device=dev)], 1)
    sp_i, sp_c = special if special is not None else (None, None)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    sb = torch.empty((n, k), dtype=torch.int8, device=dev)
    nnei = torch.empty(n, dtype=torch.int32, device=dev)
    for a0 in range(0, n, _CHUNK):
        a1 = min(n, a0 + _CHUNK)
        ai = torch.arange(a0, a1, device=dev)
        nbc = torch.remainder(ci[:, a0:a1].t()[:, None, :] + offs[None],
                              nc)                             # (T, 27, 3)
        nbid = (nbc[..., 0] * ncy + nbc[..., 1]) * ncz + nbc[..., 2]
        cand = cells[nbid].reshape(a1 - a0, 27 * cap)          # (T, 27 cap)
        rsq = 0.0
        for ax in range(3):
            d = _image_div(x[ax, a0:a1, None] - x_pad[ax][cand], Lt[ax])
            rsq = d * d if ax == 0 else rsq + d * d
        valid = (cand != n) & (cand != ai[:, None]) & (rsq <= cutsq)
        # the first k valid candidates in scan order
        pick = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
        pick = pick[:, :k]
        keep = torch.gather(valid, 1, pick)
        rows = torch.where(keep, torch.gather(cand, 1, pick), n)
        idx[a0:a1] = rows.to(torch.int32)
        nnei[a0:a1] = valid.sum(1).to(torch.int32)
        sb[a0:a1] = _special_codes(
            rows, None if sp_i is None else sp_i[a0:a1],
            None if sp_c is None else sp_c[a0:a1])
    idx, sb = _kmajor(idx, sb)
    return NeighborList(idx=idx, sb=sb, nnei=nnei,
                        overflow=cell_overflow | (nnei > k).any())


def build_cell(x: torch.Tensor, lo: torch.Tensor, L: torch.Tensor,
               spec: NeighborSpec, special=None) -> NeighborList:
    """The binned build: the CUDA kernels on CUDA planes, the plain version
    on CPU planes.  x: (3, N) positions; lo, L: (3,) box corner and
    lengths; special: None or the (N, S) int32 (partner ids, codes)."""
    if x.is_cuda:
        from ..ops import nlist as nlist_ops

        geo = torch.cat([lo.to(x.dtype), L.to(x.dtype)])
        idx_t, sb_t, nnei, flag = nlist_ops.build_cell(
            tuple(x.unbind(0)), geo, spec, special)
        return NeighborList(idx=idx_t.t(), sb=sb_t.t(), nnei=nnei,
                            overflow=flag[0] > 0)
    if x.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {x.device}")
    return build_cell_plain(x, lo, L, spec, special)


def build(x: torch.Tensor, lo: torch.Tensor, L: torch.Tensor,
          spec: NeighborSpec, special=None) -> NeighborList:
    if spec.dense:
        return build_dense(x, lo, L, spec, special)
    return build_cell(x, lo, L, spec, special)


def exclude_molecule(nl: NeighborList, mol: torch.Tensor) -> NeighborList:
    """The list without the pairs of one molecule (the same-molecule
    exclusion of fix rigid/small and exclude_intra, which the JAX build
    applies as it builds): each row's kept columns moved to its front in
    their order, the sentinel N after them, nnei their count.  Torch ops on
    any device; mol: (N,) molecule ids."""
    n, k = nl.idx.shape
    idx = nl.idx.long()
    live = (torch.arange(k, device=idx.device)[None, :]
            < torch.clamp(nl.nnei, max=k)[:, None].long()) & (idx < n)
    m = mol.long()
    keep = live & (m[torch.clamp(idx, max=n - 1)] != m[:, None])
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    kept = torch.gather(keep, 1, order)
    idx = torch.where(kept, torch.gather(idx, 1, order), n).to(torch.int32)
    sb = torch.where(kept, torch.gather(nl.sb, 1, order),
                     torch.zeros_like(nl.sb))
    idx, sb = _kmajor(idx, sb)
    return NeighborList(idx=idx, sb=sb, nnei=keep.sum(1).to(torch.int32),
                        overflow=nl.overflow)


def needs_rebuild(x: torch.Tensor, L: torch.Tensor, x0: torch.Tensor,
                  half_skin_sq: float) -> torch.Tensor:
    """``neigh_modify check yes``'s displacement test (the JAX package's
    ``needs_rebuild``): () bool, any atom moved more than skin / 2 since
    the build, the displacement x - x0 ((3, N) planes) minimum-imaged in
    the box lengths L.  Torch ops on any device; no engine calls it (the
    engines' ``check yes`` is the vmax cadence)."""
    Lt = L.to(x.dtype)
    d = [_image_div(x[a] - x0[a], Lt[a]) for a in range(3)]
    dsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return dsq.max() > half_skin_sq


def build_with_retry(x, lo, L, spec: NeighborSpec, special=None,
                     max_retries: int = 5):
    """Host-side overflow loop at set-up: grow the capacities until the
    build fits; returns (list, spec)."""
    for _ in range(max_retries):
        nl = build(x, lo, L, spec, special)
        if not bool(nl.overflow):
            return nl, spec
        spec = grow(spec, observed_max=int(nl.nnei.max()))
    raise RuntimeError(
        "neighbor list overflow persists after retries; pathological density?")
