"""Least time of one step's pair forces.

Operations, one per add, multiply, divide, sqrt or exp, per pair inside
the cutoff evaluated once with Newton's third law: distance 8, clamp 1,
1/r^2 and r 2, buck 8 or lj/charmm 10 or buck/long 19, coul/long 24
(prefactor 3, g r and exp 3, erfc 13, force 5), scalar 1, both atoms'
forces 9; 15 more for an lj/charmm pair between the inner and outer
cutoffs.  buck/long's 19 (LAMMPS' pair_buck_long_coul_long force): the
exp(-r/rho) term 4 (r / rho, exp, two products) and the split r^-6 term
15 (a^2 = g6^2 r^2, 1 / a^2, exp(-a^2), two products with C, the
polynomial ((6 / a^2 + 6) / a^2 + 3) / a^2 + 1 in 6, three products and
the difference).  Bytes: each atom's x, y, z, q and type read once (20)
and its f32 force written once (12).  The pairs come from
``reference.neighbors`` on the atoms' positions, in the box they were
taken in: the deck's, or the one fix npt moved to.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference import neighbors
from .peaks import bound_s as _bound

OPS_PAIR = {"buck/coul/long": 53, "lj/charmm/coul/long": 55,
            "buck/long/coul/long": 64}
OPS_SWITCH = 15
BYTES_ATOM = 20 + 12


def count(deck: dict, x: np.ndarray, L) -> tuple:
    """(pairs inside the outer cutoff, of them inside the switching
    region) at positions x."""
    ps = deck["pair_style"]
    rc = max(float(ps["cut"]), float(ps.get("cut_coul", ps["cut"])))
    inner = float(ps.get("inner", rc))
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    xt = torch.as_tensor(x, dtype=torch.float64, device=dev)
    n_all = n_sw = 0
    for _, _, d in neighbors.pairs(xt, L, rc):
        r2 = (d * d).sum(-1)
        n_all += len(r2)
        n_sw += int((r2 > inner * inner).sum())
    return n_all, n_sw


def box(deck: dict) -> np.ndarray:
    from ..reference.system import read_data

    d = read_data(deck["read_data"])
    return (d["hi"] - d["lo"]) * np.asarray(deck.get("replicate", [1, 1, 1]))


def bound_s(deck: dict, x: np.ndarray, L=None) -> float:
    """The least time at positions x in the box of lengths L (the deck's
    when None)."""
    n_all, n_sw = count(deck, x, box(deck) if L is None else L)
    name = deck["pair_style"]["name"]
    ops = n_all * OPS_PAIR[name]
    if name.startswith("lj/charmm"):
        ops += n_sw * OPS_SWITCH
    return _bound(len(x) * BYTES_ATOM, ops)
