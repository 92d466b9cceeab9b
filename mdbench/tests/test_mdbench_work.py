"""The work counts behind the rooflines against hand counts."""
import math

import numpy as np
import pytest
import torch
from mdbench.harness import spec
from mdbench.reference import neighbors, system
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
