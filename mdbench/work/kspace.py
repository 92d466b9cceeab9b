"""Least time of one step's PPPM solve (``kspace_style pppm``, ik) on the
mesh the deck's accuracy needs.

The mesh is the smallest that meets the accuracy by the Deserno-Holm ik
error estimate (LAMMPS' PPPM::estimate_ik_error) at the g_ewald LAMMPS
chooses, per axis, at least twice the order, rounded up to a size of
2^a 3^b 5^c: the generic mesh of LAMMPS and of the deck's JAX ancestry.
A finer mesh the program picks for its own layout is its own choice, and
reads as a lower share.  For M mesh points, Mh = nx ny (nz/2 + 1) of the
half spectrum, N atoms and order p: the deposit N (W + 3 p^3) operations
(W = 3 p 2 (p - 1) + p^2 for the stencil weights) and 16 N + 4 M bytes;
one forward and three inverse real FFTs of 2.5 M log2 M operations and
4 M + 8 Mh bytes each; the solve 8 Mh operations, 36 Mh bytes (G rho and
three ik spectra); the gather N (W + 7 p^3) operations and
12 M + 28 N bytes.
"""
from __future__ import annotations

import math

import numpy as np

from ..reference import ewald
from ..reference.system import UNITS, read_data
from .peaks import bound_s as _bound


def _acons() -> np.ndarray:
    """Deserno & Holm's ik error coefficients (LAMMPS' compute_acons)."""
    a = np.zeros((8, 7))
    a[1][0] = 2.0 / 3.0
    a[2][:2] = [1.0 / 50.0, 5.0 / 294.0]
    a[3][:3] = [1.0 / 588.0, 7.0 / 1440.0, 21.0 / 3872.0]
    a[4][:4] = [1.0 / 4320.0, 3.0 / 1936.0, 7601.0 / 2271360.0,
                143.0 / 28800.0]
    a[5][:5] = [1.0 / 23232.0, 7601.0 / 13628160.0, 143.0 / 69120.0,
                517231.0 / 106536960.0, 106640677.0 / 11737571328.0]
    a[6][:6] = [691.0 / 68140800.0, 13.0 / 57600.0, 47021.0 / 35512320.0,
                9694607.0 / 2095994880.0, 733191589.0 / 59609088000.0,
                326190917.0 / 11700633600.0]
    a[7][:7] = [1.0 / 345600.0, 3617.0 / 35512320.0, 745739.0 / 838397952.0,
                56399353.0 / 12773376000.0, 25091609.0 / 1560084480.0,
                1755948832039.0 / 36229939200000.0,
                4887769399.0 / 37838389248.0]
    return a


def ik_error(h, prd, natoms, order, g, q2) -> float:
    a = _acons()
    s = sum(a[order][m] * (h * g) ** (2 * m) for m in range(order))
    return (q2 * (h * g) ** order
            * math.sqrt(g * prd * math.sqrt(2.0 * math.pi) * s / natoms)
            / (prd * prd))


def _good(n: int) -> int:
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1 and n % 2 == 0:
            return n
        n += 1


def mesh(deck: dict) -> tuple:
    """(mesh, order, atoms) the deck's accuracy needs."""
    d = read_data(deck["read_data"])
    rep = np.asarray(deck.get("replicate", [1, 1, 1]))
    L = (d["hi"] - d["lo"]) * rep
    q = np.tile(d["q"], int(rep.prod()))
    ks, ps = deck["kspace_style"], deck["pair_style"]
    qqrd2e = UNITS[deck["units"]]["qqrd2e"]
    acc_rel = float(ks.get("accuracy", 1e-4))
    order = int(ks.get("order", 5))
    g = ewald.g_ewald(acc_rel, float(ps.get("cut_coul", ps["cut"])), q,
                      float(np.prod(L)), qqrd2e)
    q2 = float((q * q).sum()) * qqrd2e
    out = []
    for ax in range(3):
        n = 2
        while ik_error(L[ax] / n, L[ax], len(q), order, g, q2) > \
                acc_rel * qqrd2e:
            n += 1
        out.append(_good(max(n, 2 * order)))
    return tuple(out), order, len(q)


def bound_s(deck: dict, n_atoms: int) -> float:
    (nx, ny, nz), p, n = mesh(deck)
    M, Mh = nx * ny * nz, nx * ny * (nz // 2 + 1)
    W = 3 * p * 2 * (p - 1) + p * p
    fft = _bound(4 * M + 8 * Mh, 2.5 * M * math.log2(M))
    return (_bound(16 * n + 4 * M, n * (W + 3 * p ** 3))
            + 4 * fft
            + _bound(36 * Mh, 8 * Mh)
            + _bound(12 * M + 28 * n, n * (W + 7 * p ** 3)))
