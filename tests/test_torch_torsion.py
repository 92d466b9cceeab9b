"""The port's torsion angle is LAMMPS' (CPU, f64).

(a) Planar chains: a trans chain 1-2-3-4 has phi = 180 degrees and a cis
    chain 0 (dihedral_charmm.cpp, improper_harmonic.cpp), so with K = 1,
    n = 1, d = 0 the dihedral energy K [1 + cos phi] is 0 and 2K, and the
    improper chi is 180 and 0 degrees.
(b) The JAX package's angle is LAMMPS' plus 180 degrees.  On one copy of
    examples/data.rhodo_class its bonded terms under the deck's
    coefficients equal the port's under the mapped ones
    (``interop.jax_torsion_coeffs``: d -> d + 180 for odd n, chi0 ->
    180 - chi0), forces and energies at 1e-10.
(c) On the same copy the port's bonded forces, energies and virial match
    the benchmark's plain autograd reference (``mdbench/reference``,
    written from the LAMMPS documentation) at 1e-10.
"""
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.models.bonded import compute_bonded as jcompute
from lammps_buck_intel_tpu.models.bonded import make_bonded as jmake_bonded
from lammps_buck_intel_tpu_torch.core import make_box
from lammps_buck_intel_tpu_torch.interop import jax_torsion_coeffs
from lammps_buck_intel_tpu_torch.models.bonded import (
    bake_charmm_14, compute_bonded_plain, make_bonded)
from mdbench.reference import bonded as ref_bonded
from mdbench.reference import pair as ref_pair
from mdbench.reference import system as ref_system

jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECK = os.path.join(ROOT, "examples", "decks", "rhodo_flex_nve.yaml")
BOX = make_box(np.zeros(3), np.array([20.0, 20.0, 20.0]))


def _planes(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, a]))
                 for a in range(3))


def _chain(kind):
    """A planar chain 1-2-3-4, trans (a zig-zag) or cis, away from the
    faces."""
    y4 = 1.0 if kind == "cis" else -1.0
    return np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0],
                     [3.0, y4, 0.0]]) + 5.0


@pytest.mark.parametrize("kind,phi_deg", [("trans", 180.0), ("cis", 0.0)])
@pytest.mark.parametrize("term", ["dihedral", "improper"])
def test_planar_chain_takes_lammps_angle(kind, phi_deg, term):
    x = _chain(kind)
    if term == "dihedral":
        style = make_bonded(dihedrals=[[0, 0, 1, 2, 3]],
                            dihedral_coeffs=[[1.0, 1, 0.0, 0.0]])
        r = compute_bonded_plain(style, _planes(x), BOX, eflag=True,
                                 acc_dtype=torch.float64)
        want = 1.0 + np.cos(np.radians(phi_deg))
        assert abs(float(r.edihed) - want) <= 1e-12
    else:
        # K = 1: |chi - chi0| = sqrt(E) is 0 at chi0 = the chain's angle
        # and pi at the other planar angle
        for chi0, want in ((phi_deg, 0.0), (180.0 - phi_deg, np.pi)):
            style = make_bonded(impropers=[[0, 0, 1, 2, 3]],
                                improper_coeffs=[[1.0, chi0]])
            r = compute_bonded_plain(style, _planes(x), BOX, eflag=True,
                                     acc_dtype=torch.float64)
            dchi = float(r.eimp) ** 0.5
            assert abs(dchi - want) <= 1e-12, (chi0, dchi)


@pytest.mark.parametrize("kind", ["trans", "cis"])
def test_near_planar_improper_follows_the_energy(kind):
    """1e-4 rad from planar, inside the JAX package's arccos clip (which
    gives no force there), the improper's force is minus the gradient of
    K (|phi| - chi0)^2, held to the benchmark reference's angle under
    autograd; the deck's chi0 of 158 degrees puts the kink of |phi| at
    180 degrees only 0.74 kcal/mol above the minimum."""
    x = _chain(kind)
    x[3, 2] += 1e-4
    style = make_bonded(impropers=[[0, 0, 1, 2, 3]],
                        improper_coeffs=[[5.0, 158.0]])
    r = compute_bonded_plain(style, _planes(x), BOX, eflag=True,
                             acc_dtype=torch.float64)
    f = torch.stack([r.fx, r.fy, r.fz], -1)
    xt = torch.as_tensor(x).requires_grad_(True)
    phi = ref_bonded._torsion((xt[0] - xt[1])[None], (xt[2] - xt[1])[None],
                              (xt[3] - xt[2])[None])
    e = 5.0 * (phi.abs() - np.radians(158.0)) ** 2
    (g,) = torch.autograd.grad(e.sum(), xt)
    assert float(f.abs().max()) > 1.0
    assert float((f + g).abs().max()) <= 1e-9 * float(g.abs().max())
    e = float(e.detach().sum())
    assert abs(float(r.eimp) - e) <= 1e-12 * e


@pytest.fixture(scope="module")
def rhodo():
    """One copy of the rhodo-class box: the reference's atoms (positions
    unwrapped by their images, so each molecule is whole) and the bonded
    tables with the deck's coefficients."""
    with open(DECK) as f:
        deck = yaml.safe_load(f)
    deck["read_data"] = os.path.join(ROOT, deck["read_data"])
    deck.pop("velocity", None)
    d = ref_system.build(deck, 1)
    style = ref_pair.PairStyle(deck, len(d["mass"]),
                               d["units"]["qqrd2e"], 0.3)
    dc = np.asarray(deck["dihedral_style"]["coeffs"], np.float64)
    kw = dict(
        bonds=d["bonds"], angles=d["angles"], dihedrals=d["dihedrals"],
        impropers=d["impropers"], angle_style="charmm",
        bond_coeffs=deck["bond_style"]["coeffs"],
        angle_coeffs=deck["angle_style"]["coeffs"], dihedral_coeffs=dc,
        improper_coeffs=deck["improper_style"]["coeffs"],
        d14=bake_charmm_14(d["dihedrals"], dc, d["typ"], d["q"],
                           style.eps14, style.sig14, d["units"]["qqrd2e"]))
    return deck, d, style, kw


def _port(kw, x, L):
    r = compute_bonded_plain(make_bonded(**kw), _planes(x),
                             make_box(np.zeros(3), L), eflag=True,
                             acc_dtype=torch.float64)
    return np.stack([r.fx.numpy(), r.fy.numpy(), r.fz.numpy()], -1), r


def test_mapped_coefficients_give_the_jax_numbers(rhodo):
    _, d, _, kw = rhodo
    x, L = d["x"], d["L"]
    style, box = jmake_bonded(**kw), jmake_box(np.zeros(3), L)
    # one jit: a fraction of the op-by-op compile of the eager call
    jr = jax.jit(lambda xj: jcompute(style, xj, box, eflag=True,
                                     acc_dtype=jax.numpy.float64))(
        jax.numpy.asarray(x))
    mapped = dict(kw)
    mapped["dihedral_coeffs"], mapped["improper_coeffs"] = \
        jax_torsion_coeffs(kw["dihedral_coeffs"], kw["improper_coeffs"])
    tf, tr = _port(mapped, x, L)
    jf = np.asarray(jr.f)
    assert np.abs(tf - jf).max() <= 1e-10 * np.abs(jf).max()
    for name in ("edihed", "eimp", "e14_lj", "e14_coul", "emol"):
        a, b = float(getattr(tr, name)), float(getattr(jr, name))
        assert abs(a - b) <= 1e-10 * abs(b), (name, a, b)
    # unmapped, the two angles differ: the deck's n = 3 and n = 1 torsions
    # and its chi0 = 158 improper see other energies
    _, tu = _port(kw, x, L)
    assert abs(float(tu.edihed) - float(jr.edihed)) > 1.0
    assert abs(float(tu.eimp) - float(jr.eimp)) > 1.0


def test_bonded_matches_the_benchmark_reference(rhodo):
    deck, d, style, kw = rhodo
    x, L = d["x"], d["L"]
    tf, tr = _port(kw, x, L)
    xt = torch.as_tensor(x, dtype=torch.float64)
    rf, emol, e14 = ref_bonded.compute(deck, d, xt, L, style)
    rf = rf.numpy()
    assert np.abs(tf - rf).max() <= 1e-10 * np.abs(rf).max()
    assert abs(float(tr.emol) - float(emol)) <= 1e-10 * abs(float(emol))
    e14_port = float(tr.e14_lj + tr.e14_coul)
    assert abs(e14_port - float(e14)) <= 1e-10 * abs(float(e14))
    # whole molecules: the virial is sum_i x_i (x) f_i
    w = np.einsum("ia,ib->ab", x, rf)
    wref = w[[0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]]
    assert np.abs(tr.virial.numpy() - wref).max() \
        <= 1e-10 * np.abs(wref).max()


def _hcc_angles_missing(path):
    """Angles i-j-k implied by two bonds at j with a hydrogen (type 2) at
    an end that the data file's Angles section lacks."""
    d = ref_system.read_data(path)
    have = {(int(i), int(j), int(k)) for _, i, j, k in d["angles"]}
    have |= {(k, j, i) for i, j, k in have}
    nbr = {}
    for _, i, j in d["bonds"]:
        nbr.setdefault(int(i), []).append(int(j))
        nbr.setdefault(int(j), []).append(int(i))
    missing = 0
    for j, ends in nbr.items():
        for a in range(len(ends)):
            for b in range(a + 1, len(ends)):
                i, k = ends[a], ends[b]
                if 1 in (d["typ"][i], d["typ"][k]) and (i, j, k) not in have:
                    missing += 1
    return missing


def test_benchmark_box_gives_every_hydrogen_its_angles():
    """The stand-in for in.rhodo's data file: examples/data.rhodo_class
    leaves three H-C-C angles a molecule out (C0-C1-H5, C1-C2-H6,
    C2-C3-H7), so H5 turns about the C1-C2 axis through the improper's
    cusp and H7 turns freely on C3, and runs at 1 fs heat single
    hydrogens until they fail; mdbench/configs/data.rhodo
    (tools/gen_rhodo.py) has them all, and relaxed under LAMMPS' angle its
    impropers hold less than half the strain (the deck's chi0 of 158
    degrees against the H-C-C angles)."""
    old = os.path.join(ROOT, "examples", "data.rhodo_class")
    new = os.path.join(ROOT, "mdbench", "configs", "data.rhodo")
    assert _hcc_angles_missing(old) == 3 * 216
    assert _hcc_angles_missing(new) == 0

    def eimp(path):
        d = ref_system.read_data(path)
        style = make_bonded(impropers=d["impropers"],
                            improper_coeffs=[[5.0, 158.0]])
        r = compute_bonded_plain(style, _planes(d["x"]),
                                 make_box(d["lo"], d["hi"]), eflag=True,
                                 acc_dtype=torch.float64)
        return float(r.eimp) / len(d["impropers"])

    # kcal/mol an improper under LAMMPS' angle
    assert eimp(old) > 2.0 * eimp(new)
