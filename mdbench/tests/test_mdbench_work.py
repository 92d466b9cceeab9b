"""The work counts behind the rooflines against hand counts."""
import math

import numpy as np
import pytest
import torch
from mdbench.harness import spec
from mdbench.reference import ewald_disp, neighbors, system
from mdbench.work import kspace, pair, peaks


def _lattice(n, a):
    g = np.arange(n) * a
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("n", [4, 7])
def test_pairs_on_a_simple_cubic_lattice(n):
    """Cutoff between a and sqrt(2) a: six neighbours an atom, three pairs
    an atom once; between sqrt(2) a and sqrt(3) a: 18 neighbours, nine.
    At n = 4 the wider cutoff leaves two cells an axis: the all-pairs
    path."""
    a = 1.0
    x = torch.as_tensor(_lattice(n, a))
    L = [n * a] * 3
    for rc, per_atom in ((1.2, 3), (1.6, 9)):
        if rc > n * a / 2:
            continue
        got = sum(len(i) for i, _, _ in neighbors.pairs(x, L, rc))
        assert got == per_atom * n ** 3


def test_cell_list_equals_all_pairs():
    rng = np.random.default_rng(3)
    L = np.array([13.0, 11.0, 12.5])
    x = torch.as_tensor(rng.uniform(0, 1, (700, 3)) * L)
    rc = 3.5
    got = sorted((a, b) for i, j, _ in neighbors.pairs(x, L, rc)
                 for a, b in zip(i.tolist(), j.tolist()))
    d = x[:, None] - x[None]
    d = d - torch.round(d / torch.as_tensor(L)) * torch.as_tensor(L)
    r2 = (d * d).sum(-1)
    i, j = torch.nonzero((r2 < rc * rc) & torch.triu(
        torch.ones_like(r2, dtype=torch.bool), 1), as_tuple=True)
    assert got == sorted(zip(i.tolist(), j.tolist()))


def _deck(replicate):
    cfg = spec.config("cristobalite_pppm")
    return spec.deck(cfg, dict(spec.traffic("x656.thermo50"),
                               replicate=replicate), 1)


def test_generic_mesh_of_the_silica_deck():
    """LAMMPS' ik estimate at 1e-4, order 7 on the 259,200-atom box: the
    generic mesh the JAX package and the port's list engine choose."""
    assert kspace.mesh(_deck([6, 5, 6])) == ((100, 108, 80), 7, 259200)


def test_kspace_bound_by_hand():
    deck = _deck([1, 1, 1])
    (nx, ny, nz), p, n = kspace.mesh(deck)
    M, Mh = nx * ny * nz, nx * ny * (nz // 2 + 1)
    W = 3 * p * 2 * (p - 1) + p * p
    dep = max((16 * n + 4 * M) / 3.35e12, n * (W + 3 * p ** 3) / 67e12)
    gat = max((12 * M + 28 * n) / 3.35e12, n * (W + 7 * p ** 3) / 67e12)
    fft = max((4 * M + 8 * Mh) / 3.35e12, 2.5 * M * math.log2(M) / 67e12)
    sol = max(36 * Mh / 3.35e12, 8 * Mh / 67e12)
    assert kspace.bound_s(deck, n) == pytest.approx(dep + gat + 4 * fft + sol,
                                                    rel=1e-12)


def test_pair_bound_by_hand():
    deck = _deck([1, 1, 1])
    deck["pair_style"]["cut"] = 5.0

    d = system.build(deck, 1)
    n_all, _ = pair.count(deck, d["x"], d["L"])
    assert n_all > 0
    assert pair.bound_s(deck, d["x"]) == pytest.approx(
        peaks.bound_s(len(d["x"]) * 32, 53 * n_all))


def _disp_deck(replicate, cut=10.0):
    deck = _deck(replicate)
    deck["pair_style"].update(name="buck/long/coul/long", cut=cut)
    deck["kspace_style"] = {"name": "pppm/disp", "accuracy": 1e-4,
                            "force_disp_real": 1e-4, "order": 7,
                            "mix": "none"}
    return deck


def test_buck_long_pair_bound_by_hand():
    """64 operations a buck/long/coul/long pair: buck/coul/long's 53 less
    buck's 8 plus buck/long's 19."""
    deck = _disp_deck([1, 1, 1], cut=5.0)
    d = system.build(deck, 1)
    n_all, _ = pair.count(deck, d["x"], d["L"])
    assert pair.OPS_PAIR["buck/long/coul/long"] == 53 - 8 + 19
    assert pair.bound_s(deck, d["x"]) == pytest.approx(
        peaks.bound_s(len(d["x"]) * 32, 64 * n_all))


def _qopt_loops(n, L, g, order):
    """LAMMPS' compute_qopt_6_ik as its loops read, for small meshes."""
    unit = [2 * math.pi / v for v in L]
    inv2ew = 1 / (2 * g)
    q = 0.0
    for k in range(n[0]):
        kp = k - n[0] * (2 * k // n[0])
        for m in range(n[1]):
            lp = m - n[1] * (2 * m // n[1])
            for j in range(n[2]):
                mp = j - n[2] * (2 * j // n[2])
                sqk = (unit[0] * kp) ** 2 + (unit[1] * lp) ** 2 + \
                    (unit[2] * mp) ** 2
                if sqk == 0:
                    continue
                s1 = s2 = s3 = 0.0
                for a in range(-2, 3):
                    qx = unit[0] * (kp + n[0] * a)
                    sx = math.exp(-qx * qx * inv2ew * inv2ew)
                    ax = 0.5 * qx * L[0] / n[0]
                    wx = (math.sin(ax) / ax) ** order if ax else 1.0
                    for b in range(-2, 3):
                        qy = unit[1] * (lp + n[1] * b)
                        sy = math.exp(-qy * qy * inv2ew * inv2ew)
                        ay = 0.5 * qy * L[1] / n[1]
                        wy = (math.sin(ay) / ay) ** order if ay else 1.0
                        for c in range(-2, 3):
                            qz = unit[2] * (mp + n[2] * c)
                            sz = math.exp(-qz * qz * inv2ew * inv2ew)
                            az = 0.5 * qz * L[2] / n[2]
                            wz = (math.sin(az) / az) ** order if az else 1.0
                            dot1 = unit[0] * kp * qx + unit[1] * lp * qy + \
                                unit[2] * mp * qz
                            dot2 = qx * qx + qy * qy + qz * qz
                            rt = math.sqrt(dot2)
                            term = ((1 - 2 * dot2 * inv2ew * inv2ew)
                                    * sx * sy * sz + 2 * dot2 * rt
                                    * inv2ew ** 3 * math.sqrt(math.pi)
                                    * math.erfc(rt * inv2ew)) * g ** 3
                            u2 = (wx * wy * wz) ** 2
                            s1 += term * term * math.pi ** 3 / 9 * dot2
                            s2 += -u2 * term * math.pi * math.sqrt(
                                math.pi) / 3 * dot1
                            s3 += u2
                q += s1 - s2 * s2 / (s3 * s3 * sqk)
    return q


def test_disp_qopt_against_its_loops():
    L, g = [28.64, 35.8, 21.48], 0.3732
    for n in ((4, 5, 3), (6, 7, 4)):
        assert kspace.disp_qopt(n, L, g, 7) == pytest.approx(
            _qopt_loops(n, L, g, 7), rel=1e-12)


def test_pppm_disp_bound_by_hand():
    """The Coulomb ik solve as for pppm, plus two dispersion channels for
    BKS (its C6 type matrix [[0, C_SiO], [C_SiO, C_OO]] has rank 2), each
    a deposit, four FFTs, a solve and a gather on the dispersion mesh."""
    deck = _disp_deck([2, 2, 2])
    (mx, my, mz), p6, n, nch = kspace.disp_mesh(deck)
    assert (nch, p6, n) == (2, 7, 11520)
    assert (mx, my, mz) == (30, 36, 24)

    def one(nx, ny, nz, p):
        M, Mh = nx * ny * nz, nx * ny * (nz // 2 + 1)
        W = 3 * p * 2 * (p - 1) + p * p
        dep = max((16 * n + 4 * M) / 3.35e12, n * (W + 3 * p ** 3) / 67e12)
        gat = max((12 * M + 28 * n) / 3.35e12, n * (W + 7 * p ** 3) / 67e12)
        fft = max((4 * M + 8 * Mh) / 3.35e12,
                  2.5 * M * math.log2(M) / 67e12)
        sol = max(36 * Mh / 3.35e12, 8 * Mh / 67e12)
        return dep + gat + 4 * fft + sol

    coul = one(*kspace.mesh(deck)[0], 7)
    assert kspace.bound_s(deck, n) == pytest.approx(
        coul + 2 * one(mx, my, mz, 7), rel=1e-12)


def test_disp_mesh_meets_the_accuracy_and_no_coarser_one_does():
    """sqrt(Q / N) csum / V at the mesh LAMMPS' rule picks is within the
    deck's accuracy (1e-4 x 14.399645 eV/A), and a tenth coarser is not."""
    deck = _disp_deck([2, 2, 2])
    mesh_, p, n, _ = kspace.disp_mesh(deck)
    d = system.build(deck, 1)
    g6 = ewald_disp.g6(1e-4, 10.0)
    csum = 175.0 * int((d["typ"] == 1).sum())
    V = float(np.prod(d["L"]))

    def err(m):
        return math.sqrt(kspace.disp_qopt(m, d["L"], g6, p) / n) * csum / V

    assert err(mesh_) <= 1e-4 * 14.399645
    assert err([int(0.9 * v) for v in mesh_]) > 1e-4 * 14.399645
