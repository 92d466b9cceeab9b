"""Every pair of atoms inside a cutoff, once, from a plain cell list.

Cells at least ``rc`` wide along each axis of an orthorhombic periodic
box; each cell is compared with its 27 neighbours (itself included) and
a pair is kept once, for i < j.  With at least three cells an axis the
27 neighbours are distinct cells and the minimum image is the image
inside the cutoff; smaller boxes fall back to all pairs under the minimum
image (rc at most half the shortest side).  Used by the reference forces
and by the work counts behind the rooflines.
"""
from __future__ import annotations

import itertools

import torch


def wrap(x: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    return x - torch.floor(x / L) * L


def minimg(d: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    return d - torch.round(d / L) * L


def pairs(x: torch.Tensor, L, rc: float, max_pairs: int = 1 << 25):
    """Yield (i, j, d) chunks: int64 atom indices with i < j and the
    minimum-image separations d = x_i - x_j (in x's dtype) of every pair
    with |d| < rc.  x: (N, 3); L: the three box lengths."""
    dev, n = x.device, len(x)
    L = torch.as_tensor(L, dtype=torch.float64, device=dev)
    xf = wrap(x.to(torch.float64), L)
    nc = torch.clamp(torch.floor(L / rc), min=1).long()
    rc2 = rc * rc
    if bool((nc < 3).any()):
        if float(L.min()) < 2 * rc:
            raise ValueError("cutoff longer than half the box")
        for i0 in range(0, n, 2048):
            i = torch.arange(i0, min(n, i0 + 2048), device=dev)
            d = minimg(xf[i][:, None] - xf[None], L)
            r2 = (d * d).sum(-1)
            keep = (r2 < rc2) & (i[:, None] < torch.arange(n, device=dev))
            a, b = keep.nonzero(as_tuple=True)
            yield i[a], b, d[a, b].to(x.dtype)
        return
    ci = torch.minimum((xf / L * nc).long(), nc - 1)
    cell = (ci[:, 0] * nc[1] + ci[:, 1]) * nc[2] + ci[:, 2]
    ncell = int(nc.prod())
    order = torch.argsort(cell, stable=True)
    count = torch.bincount(cell, minlength=ncell)
    cap = int(count.max())
    start = torch.cumsum(count, 0) - count
    rank = torch.arange(n, device=dev) - start[cell[order]]
    table = torch.full((ncell, cap), -1, dtype=torch.long, device=dev)
    table[cell[order], rank] = order
    cc = torch.stack(torch.meshgrid(
        *[torch.arange(int(m), device=dev) for m in nc], indexing="ij"),
        -1).reshape(-1, 3)
    step = max(1, max_pairs // (cap * cap))
    for off in itertools.product((-1, 0, 1), repeat=3):
        nb = (cc + torch.tensor(off, device=dev)) % nc
        nbid = (nb[:, 0] * nc[1] + nb[:, 1]) * nc[2] + nb[:, 2]
        for c0 in range(0, ncell, step):
            a = table[c0:c0 + step]                     # (C, cap)
            b = table[nbid[c0:c0 + step]]               # (C, cap)
            ok = (a[:, :, None] >= 0) & (a[:, :, None] < b[:, None, :])
            ia, ib = a[:, :, None].expand_as(ok)[ok], \
                b[:, None, :].expand_as(ok)[ok]
            d = minimg(xf[ia] - xf[ib], L)
            keep = (d * d).sum(-1) < rc2
            yield ia[keep], ib[keep], d[keep].to(x.dtype)
