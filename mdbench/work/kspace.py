"""Least time of one step's PPPM solve (``kspace_style pppm``, ik, and
the Coulomb part of ``pppm/disp``) on the mesh the deck's accuracy
needs, and of the dispersion part of ``pppm/disp``.

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

The dispersion solve of ``pppm/disp`` counts, per channel, the same
deposit, FFT, solve and gather work on its own mesh at its own order
(``order_disp``, else ``order``).  Channels: the rank of the deck's C6
type matrix, the fewest meshes that represent it (2 for BKS silica, whose
Si-Si C6 is 0).  Mesh: LAMMPS' estimate for the dispersion ik solve
(``PPPMDisp::set_n_pppm_6`` with ``compute_qopt_6_ik``; Isele-Holder,
Mitchell and Ismail, J. Chem. Phys. 137, 174107 (2012)): from h = 4 / g6
the spacing shrinks by 5% until sqrt(Q / N) csum / V meets the accuracy,
Q the optimal-influence-function error summed over the mesh with two
aliases a side, csum = sum_i C_ii, each axis int(L / h) then raised to a
size of 2^a 3^b 5^c.  The accuracy is the deck's ``accuracy`` times the
force between two unit charges 1 A apart (LAMMPS' default when no
``kspace_modify force/disp/kspace`` is given), g6 the one the deck's
``force_disp_real`` gives (``reference.ewald_disp.g6``).  A finer mesh or
more channels in the program read as a lower share.
"""
from __future__ import annotations

import math

import numpy as np

import torch

from ..reference import ewald, ewald_disp
from ..reference.pair import PairStyle
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


def disp_qopt(n, L, g6: float, order: int) -> float:
    """LAMMPS' ``compute_qopt_6_ik`` on an n[0] x n[1] x n[2] mesh of a box
    of lengths L, in f64 (on the card when there is one)."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    f64 = torch.float64
    inv2ew = 1.0 / (2.0 * g6)
    ax = []
    for a in range(3):
        unit = 2.0 * math.pi / float(L[a])
        k = torch.arange(n[a], device=dev)
        kper = (k - n[a] * torch.div(2 * k, n[a], rounding_mode="floor"))
        kper = kper.to(f64)
        b = torch.arange(-2, 3, device=dev, dtype=f64)
        q = unit * (kper[:, None] + n[a] * b[None, :])
        s = torch.exp(-q * q * inv2ew * inv2ew)
        arg = 0.5 * q * float(L[a]) / n[a]
        w = torch.where(arg != 0, torch.sin(arg) / torch.where(
            arg != 0, arg, torch.ones_like(arg)), torch.ones_like(arg))
        ax.append((unit * kper, q, s, w ** order))
    (kx, qx, sx, wx), (ky, qy, sy, wy), (kz, qz, sz, wz) = ax
    rtpi = math.sqrt(math.pi)
    total = 0.0
    step = max(1, (1 << 22) // (n[1] * n[2] * 125))
    for x0 in range(0, n[0], step):
        c = slice(x0, min(n[0], x0 + step))

        def grid(v, axis):
            shape = [1] * 6
            shape[axis], shape[axis + 3] = v.shape
            return v.reshape(shape)

        Qx, Qy, Qz = grid(qx[c], 0), grid(qy, 1), grid(qz, 2)
        dot2 = Qx * Qx + Qy * Qy + Qz * Qz
        dot1 = (grid(kx[c][:, None], 0) * Qx + grid(ky[:, None], 1) * Qy
                + grid(kz[:, None], 2) * Qz)
        rt = torch.sqrt(dot2)
        term = ((1.0 - 2.0 * dot2 * inv2ew * inv2ew)
                * grid(sx[c], 0) * grid(sy, 1) * grid(sz, 2)
                + 2.0 * dot2 * rt * inv2ew ** 3 * rtpi
                * torch.special.erfc(rt * inv2ew)) * g6 ** 3
        u2 = (grid(wx[c], 0) * grid(wy, 1) * grid(wz, 2)) ** 2
        sum1 = (term * term * math.pi ** 3 / 9.0 * dot2).sum((3, 4, 5))
        sum2 = (-u2 * term * math.pi * rtpi / 3.0 * dot1).sum((3, 4, 5))
        sum3 = u2.sum((3, 4, 5))
        sqk = (kx[c][:, None, None] ** 2 + ky[None, :, None] ** 2
               + kz[None, None, :] ** 2)
        ok = sqk != 0
        part = sum1 - sum2 * sum2 / torch.where(ok, sum3 * sum3 * sqk,
                                                torch.ones_like(sqk))
        total += float(torch.where(ok, part, torch.zeros_like(part)).sum())
    return total


def disp_mesh(deck: dict) -> tuple:
    """(mesh, order, atoms, channels) of the dispersion solve the deck's
    accuracy needs (LAMMPS' PPPMDisp estimate, above)."""
    d = read_data(deck["read_data"])
    rep = np.asarray(deck.get("replicate", [1, 1, 1]))
    L = (d["hi"] - d["lo"]) * rep
    typ = np.tile(d["typ"], int(rep.prod()))
    ks, ps = deck["kspace_style"], deck["pair_style"]
    C6 = PairStyle(deck, len(d["mass"]), 1.0, 0.0).C
    order = int(ks.get("order_disp", ks.get("order", 5)))
    g6 = ewald_disp.g6(float(ks.get("force_disp_real", 1e-4)),
                       float(ps["cut"]))
    acc = float(ks.get("accuracy", 1e-4)) * UNITS[deck["units"]]["qqrd2e"]
    csum = float(np.diag(C6)[typ].sum())
    V = float(np.prod(L))
    h = 4.0 / g6
    for _ in range(501):
        n = [max(int(L[a] / h), 2) for a in range(3)]
        q = disp_qopt(n, L, g6, order)
        if math.sqrt(q / len(typ)) * csum / V <= acc:
            break
        h *= 0.95
    else:
        raise ValueError("no dispersion mesh meets the accuracy")
    return (tuple(ewald._good(v) for v in n), order, len(typ),
            int(np.linalg.matrix_rank(C6)))


def _solve_s(nx: int, ny: int, nz: int, p: int, n: int) -> float:
    """One mesh's deposit, four FFTs, solve and gather."""
    M, Mh = nx * ny * nz, nx * ny * (nz // 2 + 1)
    W = 3 * p * 2 * (p - 1) + p * p
    fft = _bound(4 * M + 8 * Mh, 2.5 * M * math.log2(M))
    return (_bound(16 * n + 4 * M, n * (W + 3 * p ** 3))
            + 4 * fft
            + _bound(36 * Mh, 8 * Mh)
            + _bound(12 * M + 28 * n, n * (W + 7 * p ** 3)))


def bound_s(deck: dict, n_atoms: int) -> float:
    (nx, ny, nz), p, n = mesh(deck)
    t = _solve_s(nx, ny, nz, p, n)
    if deck["kspace_style"]["name"] == "pppm/disp":
        (mx, my, mz), p6, n, nch = disp_mesh(deck)
        t += nch * _solve_s(mx, my, mz, p6, n)
    return t
