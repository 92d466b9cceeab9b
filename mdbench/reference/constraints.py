"""The bond constraints of ``fix shake`` at set-up: the positions put on
the constraints along their own bond vectors, then the velocities made
tangent to them (RATTLE), as LAMMPS' fix shake does before the first
force.  Each sweep solves every bond exactly for its two atoms; sweeps
repeat until the largest relative error is below 1e-13, which one sweep
reaches when no two constraints share an atom."""
from __future__ import annotations

import torch

from .neighbors import minimg


def settle(x, v, i, j, r0, minv, L, sweeps: int = 50):
    """(x, v) on the constraints i-j of length r0; minv: (N,) 1/m."""
    x, v = x.clone(), v.clone()
    w = minv[i] + minv[j]
    for _ in range(sweeps):
        r = minimg(x[i] - x[j], L)
        d = torch.linalg.norm(r, dim=-1)
        if float(((d - r0).abs() / r0).max()) < 1e-13:
            break
        lam = ((r0 / d - 1.0) / w)[:, None] * r
        x.index_add_(0, i, minv[i, None] * lam)
        x.index_add_(0, j, -minv[j, None] * lam)
    r = minimg(x[i] - x[j], L)
    for _ in range(sweeps):
        vij = v[i] - v[j]
        mu = ((r * vij).sum(-1) / ((r * r).sum(-1) * w))[:, None] * r
        if float(mu.abs().max()) < 1e-15 * float(v.abs().max()):
            break
        v.index_add_(0, i, -minv[i, None] * mu)
        v.index_add_(0, j, minv[j, None] * mu)
    return x, v
