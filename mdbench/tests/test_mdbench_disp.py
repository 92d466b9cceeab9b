"""The reference's dispersion PPPM (buck/long/coul/long + pppm/disp)
against direct sums, and the port's f64 CPU path against the reference."""
import math
import os

import numpy as np
import pytest
import torch
import yaml

from mdbench.harness import spec
from mdbench.reference import ewald_disp, model, pair, system

C6 = np.array([[0.0, 133.5381], [133.5381, 175.0]])   # BKS, eV A^6


def _atoms(n, L, seed):
    """n atoms of two types in a box L, no two closer than 1.2 A."""
    rng = np.random.default_rng(seed)
    x = []
    while len(x) < n:
        p = rng.uniform(0, 1, 3) * L
        d = np.asarray(x) - p if x else np.zeros((0, 3))
        d -= np.round(d / L) * L
        if not len(d) or (d * d).sum(1).min() > 1.44:
            x.append(p)
    return torch.as_tensor(np.asarray(x)), torch.as_tensor(
        rng.integers(0, 2, n))


def _direct_recip(x, typ, L, beta, kmax=10):
    """The reciprocal r^-6 sum over every k with |n_i| <= kmax, its k = 0
    and self terms, energy and forces, in f64."""
    n = torch.arange(-kmax, kmax + 1, dtype=torch.float64)
    nn = torch.stack(torch.meshgrid(n, n, n, indexing="ij"), -1).reshape(-1, 3)
    nn = nn[(nn != 0).any(1)]
    k = 2 * math.pi * nn / torch.as_tensor(L)
    kn = k.norm(dim=1)
    V = float(np.prod(L))
    w = -(math.pi ** 1.5 * beta ** 3 / 3) * ewald_disp.kernel(kn / (2 * beta))
    ph = x @ k.T
    c, s = torch.cos(ph), torch.sin(ph)
    oh = torch.nn.functional.one_hot(typ, 2).double()       # (N, T)
    Sre, Sim = oh.T @ c, oh.T @ s                          # (T, K)
    Ct = torch.as_tensor(C6)
    e = float((w * ((Sre * (Ct @ Sre)) + (Sim * (Ct @ Sim))).sum(0)).sum()) \
        / (2 * V)
    Ai_re, Ai_im = (Ct @ Sre)[typ], (Ct @ Sim)[typ]        # (N, K)
    f = ((s * Ai_re - c * Ai_im) * w) @ k / V
    cnt = oh.sum(0).numpy()
    e += -(math.pi ** 1.5 * beta ** 3 / 3) / (2 * V) * float(cnt @ C6 @ cnt)
    e += beta ** 6 / 12 * float(np.diag(C6) @ cnt)
    return e, f


def test_disp_pme_against_the_direct_sum():
    L = np.array([12.0, 13.0, 11.0])
    x, typ = _atoms(60, L, 0)
    beta = 0.45
    e0, f0 = _direct_recip(x, typ, L, beta)
    f, e, _ = ewald_disp.compute(x, typ, C6, L, beta)
    assert e == pytest.approx(e0, rel=1e-9)
    assert float((f - f0).abs().max()) < 1e-8 * float(f0.abs().max())


def _style(rc, beta):
    deck = {"pair_style": {"name": "buck/long/coul/long", "cut": rc,
                           "coeffs": {"1 1": [0.0, 1.0, C6[0, 0]],
                                      "1 2": [0.0, 1.0, C6[0, 1]],
                                      "2 2": [0.0, 1.0, C6[1, 1]]}}}
    return pair.PairStyle(deck, 2, 1.0, 1.0, beta)


def _dispersion(x, typ, L, rc, beta):
    """(energy, forces, virial trace) of the r^-6 sum split at beta."""
    q = torch.zeros(len(x), dtype=torch.float64)
    fr, ev, _, vr = pair.compute(_style(rc, beta), x, typ, q, L)
    fk, ek, vk = ewald_disp.compute(x, typ, C6, L, beta)
    return float(ev) + ek, fr + fk, float(vr.trace()) + vk


def _image_sum(x, typ, L, R):
    """-sum_{i<j, images} C_ij / r^6 over every pair closer than R, plus
    the continuum tail beyond R, -2 pi / (3 R^3 V) sum_ts C_ts N_t N_s."""
    Lt = torch.as_tensor(L)
    m = int(math.ceil(R / L.min()))
    r = torch.arange(-m, m + 1, dtype=torch.float64)
    im = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3) * Lt
    Ct = torch.as_tensor(C6)
    e = 0.0
    for i in range(len(x)):
        d = (x[i] - x)[:, None, :] + im[None]                # (N, I, 3)
        r2 = (d * d).sum(-1)
        keep = (r2 < R * R) & (r2 > 0)
        c = Ct[typ[i], typ][:, None].expand_as(r2)
        e -= 0.5 * float((c[keep] / r2[keep] ** 3).sum())
    cnt = np.bincount(typ.numpy(), minlength=2).astype(float)
    return e - 2 * math.pi / (3 * R ** 3 * float(np.prod(L))) \
        * float(cnt @ C6 @ cnt)


def test_total_dispersion_does_not_depend_on_g6():
    """At a real-space cutoff of 6 / g6 or more the split sum is the
    whole r^-6 sum: its energy and forces are the same for three g6, and
    the energy is the direct image sum's to that sum's truncation."""
    L = np.array([21.0, 22.0, 20.5])
    x, typ = _atoms(100, L, 1)
    out = [_dispersion(x, typ, L, 10.0, b) for b in (0.6, 0.7, 0.8)]
    e0, f0, v0 = out[0]
    for e, f, v in out[1:]:
        assert e == pytest.approx(e0, rel=1e-10)
        assert float((f - f0).abs().max()) < 1e-10 * float(f0.abs().max())
        assert v == pytest.approx(v0, rel=1e-10)
    # the image sum's truncation past R = 60 A: 3.7e-9 (2.5e-8 at 45 A)
    assert _image_sum(x, typ, L, 60.0) == pytest.approx(e0, rel=2e-8)


def test_virial_is_minus_the_energy_change_under_scaling():
    """W = -dE/d ln(s) when positions and box scale by s, g6 held."""
    L = np.array([21.0, 22.0, 20.5])
    x, typ = _atoms(100, L, 2)
    _, _, vir = _dispersion(x, typ, L, 10.0, 0.7)
    h = 1e-5
    ep, _, _ = _dispersion(x * (1 + h), typ, L * (1 + h), 10.0, 0.7)
    em, _, _ = _dispersion(x * (1 - h), typ, L * (1 - h), 10.0, 0.7)
    assert vir == pytest.approx(-(ep - em) / (2 * h), rel=1e-6)


def test_g6_from_the_kept_tail():
    for tail, cut in ((1e-4, 10.0), (1e-6, 12.0)):
        u = ewald_disp.g6(tail, cut) * cut
        assert (1 + u * u + u ** 4 / 2) * math.exp(-u * u) == \
            pytest.approx(tail, rel=1e-12)


def disp_deck(replicate=(1, 1, 1), cut=10.0) -> dict:
    """examples/decks/cristobalite_buck_long.yaml on the benchmark's
    silica data, velocities from seed 7."""
    with open(os.path.join(spec.ROOT, "examples", "decks",
                           "cristobalite_buck_long.yaml")) as f:
        deck = yaml.safe_load(f)
    deck["read_data"] = os.path.join(spec.HERE, "configs",
                                     "data.cristobalite")
    deck["replicate"] = list(replicate)
    deck["pair_style"]["cut"] = cut
    deck["velocity"] = {"temp": 300.0, "seed": 7}
    return deck


def test_the_reference_refuses_what_it_lacks():
    d = system.build(disp_deck(), 7)
    for ks, word in (({"name": "ewald"}, "ewald"),
                     ({"name": "pppm", "diff": "ad"}, "diff ad"),
                     ({"name": "pppm", "slab": 3.0}, "slab"),
                     ({"name": "pppm/disp", "mix": "geometric"},
                      "mix geometric")):
        deck = disp_deck()
        deck["kspace_style"] = ks
        if ks["name"] == "pppm":
            deck["pair_style"]["name"] = "buck/coul/long"
        with pytest.raises(NotImplementedError, match=word):
            model.Reference(deck, d, "cpu")
    deck = disp_deck()
    deck["fixes"] = [{"name": "rigid/small"}]
    with pytest.raises(NotImplementedError, match="rigid"):
        model.Reference(deck, d, "cpu")
    r = model.Reference(disp_deck(), d, "cpu")
    with pytest.raises(NotImplementedError, match="per-atom"):
        r.forces(torch.as_tensor(d["x"]), peratom=True)


def test_the_port_agrees_with_the_reference():
    """The port's f64 CPU path (the list engine: one copy is under three
    cells an axis at cut 10) on cristobalite_buck_long.yaml shrunk to one
    copy, 1,440 atoms, ten steps from the crystal at 300 K, against the
    reference at its positions: the forces to the deck's PPPM accuracy
    (they read 0.22 of it), the real-space Van der Waals energy (buck/long's
    split r^-6 term) to 1e-12, the potential energy to 2e-5 eV an atom
    (7.7e-6: the Coulomb PPPM's own gap, the same on this deck's
    buck/coul/long + pppm form)."""
    from lammps_buck_intel_tpu_torch.run import build_simulation

    deck = disp_deck()
    deck["precision"] = "double"
    sim = build_simulation(dict(deck), device="cpu")
    sim.run(10, thermo_every=0, log=False)
    a, row = sim.get_atoms(), sim.thermo()
    ref = model.Reference(deck, system.build(deck, 7), "cpu")
    r = ref.forces(torch.as_tensor(np.asarray(a["x"])))
    df = (torch.as_tensor(np.asarray(a["f"])) - r["f"]).norm(dim=1)
    assert float(df.pow(2).mean().sqrt()) < \
        ref.accuracy * ref.units["qqrd2e"]
    assert row["evdwl"] == pytest.approx(r["evdwl"], rel=1e-12)
    assert abs(row["epair"] - r["epot"]) < 2e-5 * ref.n
