"""Cell-pair force evaluation over the sorted slot layout.

Counterpart of ``lammps_buck_intel_tpu.models.pair.cellpair``.  Both
evaluate the Newton half stencil, as the JAX package's
``compute_cell_tiles_newton`` does: each cell pairs its slots with the
cells of ``half_offsets(reach_z)`` (the own cell, then the K - 1
lexicographically positive offsets; K = 9 reach_z + 5), in the own cell
only slot j > slot i, so each pair is decided and evaluated once, with d
= x_i - (x_j + shift) from the walking cell's slot i.  Slot i takes +fs d
and slot j the reaction -fs d; energy and virial count each pair once.
The kernel routes the reactions back through reaction planes and a second
launch, with no float atomics, so its forces are deterministic
(csrc/cellpair.cu); the plain version scatters them with ``index_add_``.

``compute_cellpair`` dispatches on the device of the planes: CUDA
tensors launch the hand-written kernel (csrc/cellpair.cu through
``ops.cellpair``), CPU tensors run ``compute_cellpair_plain``.  Styles:
buck, buck/coul/long, buck/coul/cut, lj/charmm/coul/{long,cut}, lj/cut,
lj/cut/coul/{long,cut} and lj/long (the Coulomb terms read the slot ``q``
plane).  Special bonds: the JAX package gathers each
slot's partner ids per rebin and matches them against every candidate;
the port keeps the partner table in atom order on the device
(``SpecialTable``), and a slot reads its row through its atom id.
Same-molecule exclusion (fix rigid/small, ``neigh_modify exclude
molecule/intra``): a slot plane of molecule ids, gathered once per rebin
(``slot_mol_gather``, as in the JAX package), with which a pair of one
molecule is skipped.  The uniform-special shortcut and tilted boxes are
ROADMAP queue 1 items 12 and 14.

While the tracer is on (``utils/trace.py``), both forms count into
``trace.device_counts("cellpair", device)``: the candidates tested (cap
for each active slot and tile of the half stencil) and the pairs in
range (each pair once), which the plain version counts from its own
mask.
The lane slots of the evaluate rounds are the kernel's alone.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...core.box import Box
from ...neighbor.cell_slots import CellGrid, SlotState
from ...utils import trace
from .styles import COEF_NAMES, PairStyle, check_ported, pair_terms

# Largest type count the kernel's shared coefficient table holds.
MAX_TYPES = 8


class SpecialTable(NamedTuple):
    """1-2/1-3/1-4 partner table in atom order on one device.

    idx, code: (N + 1, S) int32; row N is the sentinel of empty slots
    (idx -1, code 0), as in the JAX package's padded tables.  packed:
    (N * S,) int32, ``idx * 4 + code`` (-1 where there is no partner), the
    form the kernel reads."""

    idx: torch.Tensor
    code: torch.Tensor
    packed: torch.Tensor

    @property
    def width(self) -> int:
        return self.idx.shape[1]


def make_special_table(special_idx: np.ndarray, special_code: np.ndarray,
                       device) -> Optional[SpecialTable]:
    """The device table from ``Topology.special_idx`` / ``special_code``
    ((N, S) host numpy); None when no atom has a partner."""
    idx = np.asarray(special_idx, np.int32)
    code = np.asarray(special_code, np.int32)
    n, width = idx.shape
    if width == 0:
        return None
    if n >= 2**29:
        raise ValueError("special table packs atom ids into 29 bits")
    packed = np.where(idx >= 0, idx * 4 + code, -1).astype(np.int32)
    idx = np.concatenate([idx, np.full((1, width), -1, np.int32)])
    code = np.concatenate([code, np.zeros((1, width), np.int32)])
    return SpecialTable(
        idx=torch.as_tensor(idx).to(device),
        code=torch.as_tensor(code).to(device),
        packed=torch.as_tensor(packed.reshape(-1)).to(device))


class CellPairResult(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    fz: torch.Tensor
    evdwl: torch.Tensor
    ecoul: torch.Tensor
    virial: torch.Tensor


def half_offsets(reach_z: int = 1) -> np.ndarray:
    """(K, 3) self + lexicographically-positive cell offsets of the
    Newton half stencil (the JAX package's kernel): ox, oy in {-1, 0, 1},
    oz in [-reach_z, reach_z], self first.  K = 9r + 5."""
    offs = [(0, 0, 0)]
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in range(-reach_z, reach_z + 1):
                if (ox, oy, oz) > (0, 0, 0):
                    offs.append((ox, oy, oz))
    return np.asarray(offs, np.int64)


def half_stencil_tables(nc: tuple, offs: np.ndarray):
    """Static per-(cell, offset) tables for any offset list.

    Returns (half (ncell, K) cell ids of cell + off, inv (ncell, K) cell
    ids of cell - off, shifts (ncell, K, 3) in {-1, 0, +1}: the true j
    position is the stored position + shift * L).  The shift replaces
    per-pair minimum-image rounding; it is exact for nc >= 2*|off|+1 on
    every axis, which ``make_grid`` guarantees.
    """
    ncx, ncy, ncz = nc
    ci, cj, ck = np.meshgrid(
        np.arange(ncx), np.arange(ncy), np.arange(ncz), indexing="ij")
    cells = np.stack([ci.reshape(-1), cj.reshape(-1), ck.reshape(-1)], -1)
    ncv = np.asarray(nc)
    K = offs.shape[0]
    ncell = cells.shape[0]
    half = np.zeros((ncell, K), np.int32)
    inv = np.zeros((ncell, K), np.int32)
    shifts = np.zeros((ncell, K, 3), np.float64)
    for k in range(K):
        tgt = cells + offs[k]
        shifts[:, k, :] = (tgt >= ncv).astype(np.float64) - (tgt < 0)
        w = np.mod(tgt, ncv)
        half[:, k] = (w[:, 0] * ncy + w[:, 1]) * ncz + w[:, 2]
        wi = np.mod(cells - offs[k], ncv)
        inv[:, k] = (wi[:, 0] * ncy + wi[:, 1]) * ncz + wi[:, 2]
    return half, inv, shifts


def candidate_mask(cap: int, K: int, device) -> torch.Tensor:
    """(cap, K * cap) bool: which of a cell's half-stencil candidates a
    slot takes, all but those of the own cell (tile 0, the first cap
    columns) at or below its own slot."""
    m = torch.ones((cap, K * cap), dtype=torch.bool, device=device)
    m[:, :cap] = torch.ones((cap, cap), dtype=torch.bool,
                            device=device).triu(1)
    return m


def slot_mol_gather(excl_mol_pad: torch.Tensor, aid: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Padded atom-order molecule table (N + 1,) int32 -> the (NS,) slot
    plane (row N is the -1 sentinel of empty slots)."""
    return excl_mol_pad[torch.clamp(aid, max=n).long()]


def check_style(style: PairStyle):
    """Raise for what neither the kernel nor the plain version covers."""
    check_ported(style)
    ntypes = style.tables.shape[0]
    if ntypes > MAX_TYPES:
        raise ValueError(
            f"{ntypes} atom types: the cell-pair kernel holds at most "
            f"{MAX_TYPES}")


def _chunk_cells(cap: int, K: int, ncell: int,
                 budget_elems: int = 1 << 24) -> int:
    """Cells per plain-version chunk: bounds the (chunk, cap, K*cap) pair
    temporaries (about a dozen live at once)."""
    return max(1, min(ncell, budget_elems // max(cap * K * cap, 1)))


def range_cutsq(style: PairStyle, dtype, device) -> torch.Tensor:
    """(ntypes, ntypes) each type pair's range in ``dtype``: cut_ljsq, or
    the larger of it and cut_coulsq with a Coulomb term (rsq below it is
    exactly the pair's in_lj or in_coul)."""
    t = torch.as_tensor(style.tables, device=device).to(dtype)
    lj = t[..., COEF_NAMES.index("cut_ljsq")]
    if not style.cfg.has_coul:
        return lj
    return torch.maximum(lj, t[..., COEF_NAMES.index("cut_coulsq")])


def compute_cellpair_plain(style: PairStyle, grid: CellGrid, box: Box,
                           state: SlotState, *, eflag: bool = False,
                           vflag: bool = False, acc_dtype=torch.float32,
                           special: Optional[SpecialTable] = None,
                           slot_mol: Optional[torch.Tensor] = None
                           ) -> CellPairResult:
    """Plain torch half-stencil evaluation as dense cell tiles, chunked
    over cells (any device): each pair once, its force on slot i and the
    reaction on slot j.  With ``special``, a pair whose j atom is among
    slot i's partners takes the style's factors of its code; with
    ``slot_mol``, a pair of one molecule is skipped."""
    check_style(style)
    ncell, cap, n = grid.ncell, grid.cap, grid.n_atoms
    flt = state.x.dtype
    dev = state.x.device
    offs = half_offsets(grid.reach_z)
    K = offs.shape[0]
    nbr, _, shifts = half_stencil_tables(grid.nc, offs)
    L = np.asarray(box.lengths, np.float64)
    nbr_t = torch.as_tensor(nbr, dtype=torch.long, device=dev)
    # f64 product rounded once to flt, as the JAX package does
    shift_t = torch.as_tensor(shifts * L, device=dev).to(flt)
    own = candidate_mask(cap, K, dev)

    ntypes = style.tables.shape[0]
    flat = style.tables.reshape(ntypes * ntypes, -1)
    if ntypes == 1:
        coef1 = {name: float(flat[0, c]) for c, name in enumerate(COEF_NAMES)}
    else:
        coef_t = torch.as_tensor(flat, device=dev).to(flt)

    pos = [state.x.view(ncell, cap), state.y.view(ncell, cap),
           state.z.view(ncell, cap)]
    aid = state.aid.view(ncell, cap)
    typ = state.typ.view(ncell, cap)
    coul = style.cfg.has_coul
    q = state.q.view(ncell, cap)
    mol = slot_mol.view(ncell, cap) if slot_mol is not None else None
    f_out = [torch.zeros(ncell * cap, dtype=acc_dtype, device=dev)
             for _ in range(3)]
    ev = torch.zeros((), dtype=acc_dtype, device=dev)
    ec = torch.zeros((), dtype=acc_dtype, device=dev)
    vir = torch.zeros((6,), dtype=acc_dtype, device=dev)
    if special is not None:
        rows = torch.clamp(state.aid, max=n).long()
        sp_idx = special.idx[rows].view(ncell, cap, special.width)
        sp_code = special.code[rows].view(ncell, cap, special.width)
        sp_lj = torch.as_tensor(style.special_lj, device=dev).to(flt)
        sp_coul = torch.as_tensor(style.special_coul, device=dev).to(flt)
    counts = trace.device_counts("cellpair", dev)
    if counts is not None:
        cut_pair = range_cutsq(style, flt, dev)
    slots = torch.arange(cap, device=dev)
    chunk = _chunk_cells(cap, K, ncell)
    for c0 in range(0, ncell, chunk):
        c1 = min(ncell, c0 + chunk)
        C = c1 - c0
        js = nbr_t[c0:c1]                                   # (C, K)
        d = []
        for ax in range(3):
            pj = (pos[ax][js] + shift_t[c0:c1, :, ax, None]).reshape(
                C, 1, K * cap)
            d.append(pos[ax][c0:c1, :, None] - pj)          # (C, cap, K*cap)
        rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        ai = aid[c0:c1, :, None]
        aj = aid[js].reshape(C, 1, K * cap)
        mask = (ai < n) & (aj < n) & own
        if mol is not None:
            mask &= mol[c0:c1, :, None] != mol[js].reshape(C, 1, K * cap)
        if counts is not None:
            # an empty slot's type never indexes the tables in the kernel
            ti = torch.where(aid[c0:c1] < n, typ[c0:c1], 0).long()
            tj = torch.where(aid[js] < n, typ[js], 0).long().reshape(
                C, 1, K * cap)
            in_range = mask & (rsq.clamp_min(1e-12)
                               < cut_pair[ti[:, :, None], tj])
            counts[:2] += torch.tensor(
                [int((aid[c0:c1] < n).sum()) * K * cap, int(in_range.sum())],
                device=dev)
        # only candidates inside the largest cutoff contribute (every term
        # is zero beyond its own cutoff): the physics runs on those pairs
        keep = torch.nonzero((mask & (rsq < style.cutsq_max)).reshape(-1),
                             as_tuple=True)[0]
        row = keep // (K * cap)                    # slot of i in the chunk
        col = (row // cap) * (K * cap) + keep % (K * cap)   # j in (C, K*cap)
        rsq_k = rsq.reshape(-1)[keep]
        d_k = [da.reshape(-1)[keep] for da in d]
        aj_k = aid[js].reshape(-1)[col]
        # the slot of j in the whole plane
        sj_k = (js[:, :, None] * cap + slots).reshape(-1)[col]
        if ntypes == 1:
            coef = coef1
        else:
            tt = (typ[c0:c1].reshape(-1)[row] * ntypes
                  + typ[js].reshape(-1)[col]).long()
            coef = {name: coef_t[:, c][tt] for c, name in enumerate(COEF_NAMES)}
        qi = q[c0:c1].reshape(-1)[row] if coul else 0.0
        qj = q[js].reshape(-1)[col] if coul else 0.0
        f_lj = f_coul = 1.0
        if special is not None:
            sb = torch.zeros(rsq_k.shape, dtype=torch.long, device=dev)
            sp_i = sp_idx[c0:c1].reshape(C * cap, -1)[row]
            sp_c = sp_code[c0:c1].reshape(C * cap, -1)[row]
            for k in range(special.width):
                sb += torch.where(sp_i[:, k] == aj_k, sp_c[:, k], 0)
            f_lj, f_coul = sp_lj[sb], sp_coul[sb]
        fs, e, e_c = pair_terms(style, rsq_k, coef, qi, qj, f_lj, f_coul,
                                eflag=eflag)
        for ax in range(3):
            f = (fs * d_k[ax]).to(acc_dtype)
            f_out[ax].index_add_(0, c0 * cap + row, f)
            f_out[ax].index_add_(0, sj_k, -f)
        if eflag:
            ev = ev + e.to(acc_dtype).sum()
            ec = ec + e_c.to(acc_dtype).sum()
        if vflag:
            vir = vir + torch.stack([
                (fs * d_k[a] * d_k[b]).to(acc_dtype).sum()
                for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])
    return CellPairResult(fx=f_out[0], fy=f_out[1], fz=f_out[2], evdwl=ev,
                          ecoul=ec, virial=vir)


def compute_cellpair(style: PairStyle, grid: CellGrid, box: Box,
                     state: SlotState, *, eflag: bool = False,
                     vflag: bool = False, acc_dtype=torch.float32,
                     special: Optional[SpecialTable] = None,
                     slot_mol: Optional[torch.Tensor] = None
                     ) -> CellPairResult:
    """Pair forces (acc dtype, slot order) + evdwl/ecoul/virial.

    CUDA planes launch the kernel; CPU planes run the plain version.
    Without eflag/vflag the energy/virial fields are zeros.  special:
    the partner table of a molecular deck (``make_special_table``);
    slot_mol: the molecule-id plane of same-molecule exclusion
    (``slot_mol_gather``)."""
    if state.x.is_cuda:
        from ...ops import cellpair as cellpair_ops

        return cellpair_ops.cellpair_forces(
            style, grid, box, state, eflag=eflag or vflag,
            acc_dtype=acc_dtype, special=special, slot_mol=slot_mol)
    if state.x.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {state.x.device}")
    return compute_cellpair_plain(style, grid, box, state, eflag=eflag,
                                  vflag=vflag, acc_dtype=acc_dtype,
                                  special=special, slot_mol=slot_mol)
