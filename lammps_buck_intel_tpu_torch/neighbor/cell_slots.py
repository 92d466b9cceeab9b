"""Sorted cell-slot atom layout and its rebin.

Counterpart of ``lammps_buck_intel_tpu.neighbor.cell_slots``.  Atoms live
in a fixed (ncell * cap) slot array, grouped by cell and padded with
empty slots (``aid == n_atoms``).  Cells are at least cutoff + skin wide
(cutneigh / reach_z tall in z), so the pair kernel only ever looks at a
cell's stencil of neighbour cells.  Between rebins atoms may drift up to
skin/2; the runner's rebin cadence enforces that bound.

``rebin_incremental`` is the per-block rebin.  On a CUDA tensor it
launches the hand-written kernel of csrc/rebin.cu; on a CPU tensor it
runs the plain torch version below, the same algorithm as the JAX
package's.  ``rebin`` (the full counting sort used at set-up and after a
capacity grow; the incremental rebin's fallback) dispatches the same
way.  Slot order inside a cell differs between the kernel (atomic
arrival order) and the plain version; every comparison is made in atom
order (``to_atoms``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.box import Box


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static grid geometry.

    nc: cells per axis (>= 3 each, >= 3 * reach_z in z).  cap: slots per
    cell.  reach_z: z refinement; cells are cutneigh/reach_z tall and the
    pair stencil spans (3, 3, 2 * reach_z + 1) cells.
    """

    nc: tuple[int, int, int]
    cap: int
    n_atoms: int
    reach_z: int = 1

    @property
    def ncell(self) -> int:
        return self.nc[0] * self.nc[1] * self.nc[2]

    @property
    def nslots(self) -> int:
        return self.ncell * self.cap

    def coarse(self) -> "CellGrid":
        """The reach-1 view of the same slot planes: reach_z z-adjacent
        cells are contiguous rows and merge into one cell of reach_z * cap
        slots.  Identity when reach_z == 1.  The PPPM mesh is aligned to
        these cell counts."""
        if self.reach_z == 1:
            return self
        return CellGrid(
            nc=(self.nc[0], self.nc[1], self.nc[2] // self.reach_z),
            cap=self.cap * self.reach_z, n_atoms=self.n_atoms)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_grid(
    n_atoms: int,
    box_lengths,
    cutneigh: float,
    cap: Optional[int] = None,
    safety: float = 1.6,
    reach_z: int = 1,
) -> Optional[CellGrid]:
    """Host-side sizing.  Returns None when the box is too small for a
    3^3 grid.  The guard also keeps the pair kernel's periodic shift
    exact: every axis has nc >= 2 * |offset| + 1."""
    L = np.asarray(box_lengths, np.float64)
    nc = [int(max(1, np.floor(l / cutneigh))) for l in L]
    if min(nc) < 3:
        return None
    nc[2] *= reach_z
    nc = tuple(nc)
    if cap is None:
        mean = n_atoms / (nc[0] * nc[1] * nc[2])
        cap = _round_up(max(8, int(mean * safety) + 4), 8)
    return CellGrid(nc=nc, cap=int(cap), n_atoms=n_atoms, reach_z=reach_z)


def grow(grid: CellGrid, observed_max: Optional[int] = None) -> CellGrid:
    target = int(grid.cap * 1.25) + 8
    if observed_max is not None:
        target = max(target, int(observed_max * 1.15) + 4)
    return dataclasses.replace(grid, cap=_round_up(target, 8))


class SlotState(NamedTuple):
    """All-(NS,) planes on one device.  aid == n_atoms marks an empty
    slot.  Float planes have the precision's ``flt`` dtype; ix/iy/iz,
    typ and aid are int32; ``overflow`` is a sticky 0-d bool tensor;
    ``therm`` is the (2, M) Nose-Hoover chain (eta, eta_dot) of an NVT
    run, None under NVE: no rebin touches it, every rebin carries it."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    fz: torch.Tensor
    ix: torch.Tensor   # image flags
    iy: torch.Tensor
    iz: torch.Tensor
    typ: torch.Tensor
    q: torch.Tensor
    aid: torch.Tensor  # original atom index; n_atoms = empty
    overflow: torch.Tensor
    therm: Optional[torch.Tensor] = None

    def clone(self) -> "SlotState":
        return SlotState(*(None if t is None else t.clone() for t in self))


# The planes a rebin moves, in the order the rebin kernel takes them.
FLOAT_FIELDS = ("x", "y", "z", "vx", "vy", "vz", "fx", "fy", "fz", "q")
INT_FIELDS = ("ix", "iy", "iz", "typ", "aid")
MOVE_FIELDS = FLOAT_FIELDS + INT_FIELDS


def _wrap_plane(p, i, lo, L):
    # a true division: torch on CUDA turns division by a python scalar
    # into multiplication by its reciprocal, which can round differently
    rel = (p - lo) / torch.tensor(L, dtype=p.dtype, device=p.device)
    nshift = torch.floor(rel)
    return p - nshift * L, i + nshift.to(i.dtype)


def wrap_state(box: Box, state: SlotState) -> SlotState:
    """Wrap positions into the box, updating image flags (out of place)."""
    lo = [float(v) for v in np.asarray(box.lo)]
    L = [float(v) for v in np.asarray(box.lengths)]
    x, ix = _wrap_plane(state.x, state.ix, lo[0], L[0])
    y, iy = _wrap_plane(state.y, state.iy, lo[1], L[1])
    z, iz = _wrap_plane(state.z, state.iz, lo[2], L[2])
    return state._replace(x=x, y=y, z=z, ix=ix, iy=iy, iz=iz)


def cell_index(p, lo_a: float, L_a: float, nc_a: int):
    c = torch.floor((p - lo_a) * (nc_a / L_a)).to(torch.int32)
    return torch.clamp(c, 0, nc_a - 1)


def _slot_cid(grid: CellGrid, box: Box, state: SlotState):
    """(M,) current cell id of every entry (== ncell when invalid)."""
    ncx, ncy, ncz = grid.nc
    lo = [float(v) for v in np.asarray(box.lo)]
    L = [float(v) for v in np.asarray(box.lengths)]
    cx = cell_index(state.x, lo[0], L[0], ncx)
    cy = cell_index(state.y, lo[1], L[1], ncy)
    cz = cell_index(state.z, lo[2], L[2], ncz)
    cid = (cx * ncy + cy) * ncz + cz
    return torch.where(state.aid < grid.n_atoms, cid,
                       torch.full_like(cid, grid.ncell))


def _scatter(field, target, ns: int, fill):
    """out[target] = field over (ns,) planes; target == ns is dropped."""
    out = torch.full((ns + 1,), fill, dtype=field.dtype, device=field.device)
    out[target] = field
    return out[:ns]


def _bin_to_slots_plain(state: SlotState, cid, ncell: int, cap: int,
                        n: int) -> SlotState:
    ns = ncell * cap
    cid_sorted, order = torch.sort(cid, stable=True)
    starts = torch.searchsorted(
        cid_sorted, torch.arange(ncell, dtype=cid.dtype, device=cid.device))
    m = cid.shape[0]
    rank = (torch.arange(m, dtype=torch.int32, device=cid.device)
            - starts[torch.clamp(cid_sorted, max=ncell - 1)].to(torch.int32))
    valid = cid_sorted < ncell
    ok = valid & (rank < cap)
    target = torch.where(ok, cid_sorted.long() * cap + rank,
                         torch.full_like(rank, ns, dtype=torch.long))
    overflow = state.overflow | torch.any(valid & (rank >= cap))
    planes = {f: _scatter(getattr(state, f)[order], target, ns,
                          n if f == "aid" else 0)
              for f in MOVE_FIELDS}
    return SlotState(overflow=overflow, therm=state.therm, **planes)


def rebin(grid: CellGrid, box: Box, state: SlotState) -> SlotState:
    """Full rebin: wrap every entry, then counting-sort them into a fresh
    (ncell * cap,) slot state.  Works on any leading length M (N at
    set-up, NS of an older grid after a capacity grow).  Entries beyond a
    cell's capacity are dropped and set the sticky overflow flag."""
    if state.x.is_cuda:
        from ..ops import rebin as rebin_ops

        return rebin_ops.rebin(grid, box, state)
    _require_cpu(state.x)
    state = wrap_state(box, state)
    cid = _slot_cid(grid, box, state)
    return _bin_to_slots_plain(state, cid, grid.ncell, grid.cap,
                               grid.n_atoms)


def move_capacity(grid: CellGrid) -> int:
    """Mover-buffer size B for rebin_incremental: 1/16 of the slots,
    at least 2048, rounded to 512.  More movers fall back to the full
    counting sort."""
    return min(grid.nslots, _round_up(max(2048, grid.nslots // 16), 512))


def rebin_incremental(grid: CellGrid, box: Box, state: SlotState,
                      bufcap: Optional[int] = None) -> SlotState:
    """Move only the entries whose cell changed (counting-sort rebin).

    Requires ``state`` to be slot-shaped (NS,) and cell-consistent up to
    the movers, the invariant every earlier rebin establishes.  Mover
    slots are vacated (aid = n, q = 0) and the movers placed into free
    slots of their new cells; more than ``bufcap`` movers fall back to
    the full counting sort.  A cell with too few free slots sets the
    sticky overflow flag.

    CUDA tensors: the kernel updates the planes IN PLACE and returns the
    same tensors.  CPU tensors: the plain version returns new planes.
    """
    if state.x.shape[0] != grid.nslots:
        return rebin(grid, box, state)
    B = bufcap or move_capacity(grid)
    if state.x.is_cuda:
        from ..ops import rebin as rebin_ops

        return rebin_ops.rebin_incremental(grid, box, state, B)
    _require_cpu(state.x)
    return _rebin_incremental_plain(grid, box, state, B)


def _require_cpu(t: torch.Tensor):
    if t.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {t.device}")


def _rebin_incremental_plain(grid: CellGrid, box: Box, state: SlotState,
                             B: int) -> SlotState:
    """The JAX package's algorithm in torch ops (any device)."""
    ns = grid.nslots
    n = grid.n_atoms
    ncell = grid.ncell
    cap = grid.cap
    dev = state.x.device

    state = wrap_state(box, state)
    cid = _slot_cid(grid, box, state)
    slot_cell = torch.arange(ncell, dtype=torch.int32,
                             device=dev).repeat_interleave(cap)
    valid = state.aid < n
    moved = valid & (cid != slot_cell)
    if int(moved.sum()) > B:
        return _bin_to_slots_plain(state, cid, ncell, cap, n)

    # 1) compact mover slot indices into the buffer (slot order)
    dest = torch.cumsum(moved.to(torch.int32), 0) - 1
    dest = torch.where(moved & (dest < B), dest, torch.full_like(dest, B))
    src = torch.full((B + 1,), ns, dtype=torch.int64, device=dev)
    src[dest.long()] = torch.arange(ns, dtype=torch.int64, device=dev)
    src = src[:B]
    buf_ok = src < ns
    src_c = torch.clamp(src, max=ns - 1)
    tgt_cid = torch.where(buf_ok, cid[src_c],
                          torch.full_like(cid[src_c], ncell))
    # mover payloads, gathered BEFORE vacating clobbers aid/q
    mover_vals = {f: getattr(state, f)[src_c] for f in MOVE_FIELDS}

    # 2) vacate mover slots (stale q is zeroed: PPPM reads q unmasked)
    aid = torch.where(moved, torch.full_like(state.aid, n), state.aid)
    q = torch.where(moved, torch.zeros_like(state.q), state.q)
    st = state._replace(aid=aid, q=q)

    # 3) per-cell free-slot table: free positions first, cap sentinels after
    free = (st.aid >= n).reshape(ncell, cap)
    free_count = free.to(torch.int32).sum(1)
    slot_in_cell = torch.arange(cap, dtype=torch.int32,
                                device=dev).expand(ncell, cap)
    free_pos = torch.sort(
        torch.where(free, slot_in_cell, torch.full_like(slot_in_cell, cap)),
        dim=1).values.reshape(-1)

    # 4) order movers by target cell; rank within cell
    cid_s, order = torch.sort(tgt_cid, stable=True)
    ok_s = cid_s < ncell
    starts = torch.searchsorted(
        cid_s, torch.arange(ncell, dtype=cid_s.dtype, device=dev))
    cs_safe = torch.clamp(cid_s, max=ncell - 1).long()
    rank = (torch.arange(B, dtype=torch.int64, device=dev)
            - starts[cs_safe])

    # 5) place: r-th arrival in cell c -> c*cap + free_pos[c, r]
    fits = ok_s & (rank < free_count[cs_safe])
    fslot = free_pos[torch.where(fits, cs_safe * cap + rank,
                                 torch.full_like(rank, ns - 1))]
    target = torch.where(fits & (fslot < cap), cs_safe * cap + fslot,
                         torch.full_like(rank, ns))
    overflow = st.overflow | torch.any(ok_s & ~fits)

    upd = {}
    for f in MOVE_FIELDS:
        plane = torch.cat([getattr(st, f), getattr(st, f)[:1]])
        plane[target] = mover_vals[f][order]
        upd[f] = plane[:ns]
    return SlotState(overflow=overflow, therm=state.therm, **upd)


def from_atoms(grid: CellGrid, box: Box, x, v, image, typ, q,
               dtype=torch.float32, tchain: int = 0) -> SlotState:
    """Initial binning from (N, 3)/(N,) atom-ordered tensors; the slot
    state lives on the device of ``x``.  tchain > 0 starts a Nose-Hoover
    chain of that length at rest."""
    n = grid.n_atoms
    dev = x.device
    x = x.to(dtype)
    v = v.to(dtype)
    image = image.to(torch.int32)
    zeros = torch.zeros((n,), dtype=dtype, device=dev)
    st = SlotState(
        x=x[:, 0].contiguous(), y=x[:, 1].contiguous(),
        z=x[:, 2].contiguous(),
        vx=v[:, 0].contiguous(), vy=v[:, 1].contiguous(),
        vz=v[:, 2].contiguous(),
        fx=zeros, fy=zeros.clone(), fz=zeros.clone(),
        ix=image[:, 0].contiguous(), iy=image[:, 1].contiguous(),
        iz=image[:, 2].contiguous(),
        typ=typ.to(torch.int32).contiguous(),
        q=q.to(dtype).contiguous(),
        aid=torch.arange(n, dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        therm=(torch.zeros((2, tchain), dtype=dtype, device=dev)
               if tchain else None),
    )
    return rebin(grid, box, st)


def to_atoms(grid: CellGrid, state: SlotState) -> dict:
    """Scatter slots back to atom order: dict of (N, 3)/(N,) tensors."""
    n = grid.n_atoms
    idx = torch.clamp(state.aid, max=n).long()

    def unscat(plane):
        out = torch.zeros((n + 1,), dtype=plane.dtype, device=plane.device)
        out[idx] = plane
        return out[:n]

    def stack(*planes):
        return torch.stack([unscat(p) for p in planes], -1)

    return dict(x=stack(state.x, state.y, state.z),
                v=stack(state.vx, state.vy, state.vz),
                f=stack(state.fx, state.fy, state.fz),
                image=stack(state.ix, state.iy, state.iz),
                typ=unscat(state.typ), q=unscat(state.q))
