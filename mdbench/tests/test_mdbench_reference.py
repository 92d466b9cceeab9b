"""The plain reference against itself and against direct sums."""
import math

import numpy as np
import pytest
import torch

from mdbench.harness import spec
from mdbench.reference import bonded, ewald, model, system


def _direct_ewald(x, q, L, g, kmax=14):
    """The reciprocal Ewald sum over every k with |n_i| <= kmax, energy and
    forces, in f64 (units of q^2 / length)."""
    n = torch.arange(-kmax, kmax + 1, dtype=torch.float64)
    nn = torch.stack(torch.meshgrid(n, n, n, indexing="ij"), -1).reshape(-1, 3)
    nn = nn[(nn != 0).any(1)]
    k = 2 * math.pi * nn / torch.as_tensor(L)
    k2 = (k * k).sum(1)
    V = float(np.prod(L))
    a = 4 * math.pi / V * torch.exp(-k2 / (4 * g * g)) / k2
    ph = x @ k.T
    c, s = torch.cos(ph), torch.sin(ph)
    S_re, S_im = q @ c, q @ s
    e = 0.5 * float((a * (S_re ** 2 + S_im ** 2)).sum())
    f = (q[:, None] * (s * S_re - c * S_im) * a) @ k
    e -= g / math.sqrt(math.pi) * float((q * q).sum())
    return e, f


def test_smooth_pme_against_the_direct_sum():
    rng = np.random.default_rng(0)
    L = np.array([12.0, 13.0, 11.0])
    x = torch.as_tensor(rng.uniform(0, 1, (60, 3)) * L)
    q = torch.as_tensor(np.tile([1.0, -1.0], 30))
    g = 0.45
    e0, f0 = _direct_ewald(x, q, L, g)
    f, e, _ = ewald.compute(x, q, L, g, 1.0)
    assert e == pytest.approx(e0, rel=1e-9)
    assert float((f - f0).abs().max()) < 1e-8 * float(f0.abs().max())


STYLES = ("buck/coul/long", "buck/long/coul/long")


def _reference(dtype, replicate=(1, 1, 1), style="buck/coul/long"):
    """The silica deck at cut 5 on jittered atoms; with buck/long/coul/long
    its pppm/disp form (cristobalite_buck_long.yaml's k-space line)."""
    cfg = spec.config("cristobalite_pppm")
    deck = spec.deck(cfg, dict(spec.traffic("x656.thermo50"),
                               replicate=list(replicate)), 7)
    deck["pair_style"]["cut"] = 5.0
    if style == "buck/long/coul/long":
        deck["pair_style"]["name"] = style
        deck["kspace_style"] = {"name": "pppm/disp", "accuracy": 1e-4,
                                "force_disp_real": 1e-4, "order": 7,
                                "mix": "none"}
    d = system.build(deck, 7)
    rng = np.random.default_rng(1)
    d["x"] = d["x"] + rng.normal(0, 0.05, d["x"].shape)
    return model.Reference(deck, d, "cpu", dtype), d


@pytest.mark.parametrize("style", STYLES)
def test_f32_agrees_with_f64(style):
    r64, d = _reference(torch.float64, style=style)
    r32 = r64.as_dtype(torch.float32)
    x = torch.as_tensor(d["x"])
    a, b = r64.forces(x), r32.forces(x.float())
    fr = float(a["f"].norm(dim=1).pow(2).mean().sqrt())
    assert float((a["f"] - b["f"].double()).norm(dim=1).max()) < 1e-4 * fr
    assert b["epot"] == pytest.approx(a["epot"], rel=1e-6)
    assert b["vir"] == pytest.approx(a["vir"], rel=1e-5)


def test_peratom_sums_to_the_totals():
    r, d = _reference(torch.float64)
    x = torch.as_tensor(d["x"])
    out = r.forces(x, peratom=True)
    assert float(out["eatom"].sum()) == pytest.approx(out["epot"], rel=1e-10)
    assert float(out["vatom"][:, :3].sum()) == pytest.approx(out["vir"],
                                                             rel=1e-9)


@pytest.mark.parametrize("style", STYLES)
def test_forces_are_minus_the_energy_gradient(style):
    r, d = _reference(torch.float64, style=style)
    x = torch.as_tensor(d["x"])
    f = r.forces(x)["f"]
    h = 1e-5
    for atom, ax in ((0, 0), (17, 2), (901, 1)):
        xp, xm = x.clone(), x.clone()
        xp[atom, ax] += h
        xm[atom, ax] -= h
        fd = -(r.forces(xp)["epot"] - r.forces(xm)["epot"]) / (2 * h)
        assert float(f[atom, ax]) == pytest.approx(fd, rel=1e-5, abs=1e-6)


def test_charmm_torsion_convention():
    """LAMMPS' dihedral angle: a planar trans chain 1-2-3-4 at 180
    degrees, a cis chain at 0 (dihedral_charmm.cpp: cos phi from
    (b1 x -b2) . (b3 x -b2)); so K [1 + cos(3 phi)] is 0 at trans."""
    trans = torch.tensor([[0.0, 1, 0], [0, 0, 0], [1, 0, 0], [1, -1, 0]],
                         dtype=torch.float64)
    cis = trans.clone()
    cis[3, 1] = 1.0
    for xyz, phi in ((trans, math.pi), (cis, 0.0)):
        b1, b2, b3 = xyz[0] - xyz[1], xyz[2] - xyz[1], xyz[3] - xyz[2]
        got = float(bonded._torsion(b1[None], b2[None], b3[None]))
        assert abs(got) == pytest.approx(phi, abs=1e-12)
    deck = {"dihedral_style": {"coeffs": [[1.0, 3, 0.0, 0.0]]},
            "improper_style": {"coeffs": [[1.0, 180.0]]}}
    d = {"bonds": np.zeros((0, 3), np.int64),
         "angles": np.zeros((0, 4), np.int64),
         "dihedrals": np.array([[0, 0, 1, 2, 3]]),
         "impropers": np.array([[0, 0, 1, 2, 3]])}
    e, _ = bonded.energies(deck, d, trans, [50.0] * 3, None)
    assert float(e) == pytest.approx(0.0, abs=1e-12)
    e, _ = bonded.energies(deck, d, cis, [50.0] * 3, None)
    assert float(e) == pytest.approx(2.0 + math.pi ** 2, rel=1e-12)


def test_settle_puts_bonds_on_their_length_and_velocities_tangent():
    from mdbench.reference import constraints

    rng = np.random.default_rng(2)
    L = torch.tensor([20.0, 20.0, 20.0], dtype=torch.float64)
    x = torch.as_tensor(rng.uniform(0, 20, (40, 3)))
    v = torch.as_tensor(rng.normal(0, 1, (40, 3)))
    i, j = torch.arange(0, 40, 2), torch.arange(1, 40, 2)
    x[j] = x[i] + torch.as_tensor(rng.normal(0, 0.6, (20, 3)))
    r0 = torch.full((20,), 1.09, dtype=torch.float64)
    minv = torch.as_tensor(rng.choice([1 / 12.011, 1 / 1.008], 40))
    xs, vs = constraints.settle(x, v, i, j, r0, minv, L)
    r = xs[i] - xs[j]
    assert torch.allclose(r.norm(dim=1), r0, rtol=1e-12)
    assert float(((vs[i] - vs[j]) * r).sum(1).abs().max()) < 1e-12
    # the centre of mass of each pair stays
    m = 1 / minv
    com = lambda p: (m[i, None] * p[i] + m[j, None] * p[j])  # noqa: E731
    assert torch.allclose(com(xs), com(x), rtol=1e-12, atol=1e-12)
