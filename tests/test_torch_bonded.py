"""The port's bonded terms against the JAX package (CPU, f64).

The same random chain molecules (numpy, seeded) go through
``compute_bonded`` of both packages, with the positions permuted into
"slots" and reached through the slot-of-atom map, as the engine passes
them (slot-index overrides on the JAX side): forces rel 1e-10 of max|f|,
every energy rel 1e-10, virial 1e-9 of its largest component.  The port's
dihedral and improper forces are written out by hand where the JAX
package uses autodiff, so the plain versions are also held to central
finite differences of their own energies at 1e-5 (the bound of
tests/test_charmm.py).  A planar improper sits inside the arccos clip and
gets zero force in both packages.  The port takes LAMMPS' torsion angle
and the JAX package that plus 180 degrees, so the port gets the JAX
tables' coefficients mapped (``interop.jax_torsion_coeffs``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.models.bonded import compute_bonded as jcompute
from lammps_buck_intel_tpu.models.bonded import make_bonded as jmake_bonded
from lammps_buck_intel_tpu_torch.core import make_box
from lammps_buck_intel_tpu_torch.interop import (bonded_from_numpy,
                                                 jax_torsion_coeffs)
from lammps_buck_intel_tpu_torch.models.bonded import (
    bake_charmm_14, compute_bonded, compute_bonded_plain, make_bonded)
from lammps_buck_intel_tpu_torch.models.bonded import charmm as tcharmm

jax.config.update("jax_enable_x64", True)

L = np.array([14.0, 15.0, 16.0])
NMOL, NSLOT_PAD = 40, 37


def _chains(seed):
    """NMOL four-atom chains with bond lengths ~1.5 and generic angles,
    spread over (and across the faces of) the box."""
    rng = np.random.default_rng(seed)
    x = np.zeros((NMOL, 4, 3))
    x[:, 0] = rng.uniform(0, 1, (NMOL, 3)) * L
    for k in range(1, 4):
        step = rng.normal(size=(NMOL, 3))
        step /= np.linalg.norm(step, axis=1, keepdims=True)
        x[:, k] = x[:, k - 1] + step * rng.uniform(1.2, 1.8, (NMOL, 1))
    x = x.reshape(-1, 3)
    x = x - np.floor(x / L) * L        # wrapped: terms cross the faces
    base = 4 * np.arange(NMOL)
    return rng, x, base


def _terms(kind, seed):
    rng, x, base = _chains(seed)
    kw = {}
    if kind == "bonds":
        kw["bonds"] = np.concatenate(
            [np.stack([rng.integers(0, 2, NMOL), base + k, base + k + 1], 1)
             for k in range(3)])
        kw["bond_coeffs"] = [[300.0, 1.53], [340.0, 1.09]]
    elif kind in ("angles_harmonic", "angles_charmm"):
        kw["angles"] = np.concatenate(
            [np.stack([rng.integers(0, 2, NMOL), base + k, base + k + 1,
                       base + k + 2], 1) for k in range(2)])
        if kind == "angles_charmm":
            kw["angle_style"] = "charmm"
            kw["angle_coeffs"] = [[40.0, 117.0, 5.0, 2.64],
                                  [20.0, 105.0, 0.0, 0.0]]
        else:
            kw["angle_coeffs"] = [[40.0, 117.0], [20.0, 105.0]]
    elif kind.startswith("dihedrals"):
        typ = rng.integers(0, 8, NMOL)
        kw["dihedrals"] = np.stack([typ, base, base + 1, base + 2, base + 3],
                                   1)
        # n = 1..4 with d = 0 and 180 degrees
        kw["dihedral_coeffs"] = [[1.2 + 0.1 * t, 1 + t % 4, 180.0 * (t // 4),
                                  0.5 if t % 2 else 1.0] for t in range(8)]
        if kind == "dihedrals_14":
            atyp = rng.integers(0, 2, 4 * NMOL)
            q = rng.uniform(-0.4, 0.4, 4 * NMOL)
            kw["d14"] = bake_charmm_14(
                kw["dihedrals"], np.asarray(kw["dihedral_coeffs"]), atyp, q,
                [0.04, 0.02], [3.4, 2.3], 332.06371)
    elif kind == "impropers":
        kw["impropers"] = np.stack(
            [rng.integers(0, 2, NMOL), base, base + 1, base + 2, base + 3], 1)
        kw["improper_coeffs"] = [[5.0, 158.0], [8.0, 20.0]]
    return x, kw


def _port(kw):
    """The port's make_bonded arguments for the JAX package's ``kw``."""
    kw = dict(kw)
    kw["dihedral_coeffs"], kw["improper_coeffs"] = jax_torsion_coeffs(
        kw.get("dihedral_coeffs"), kw.get("improper_coeffs"))
    return kw


def _slots(x, seed):
    """Atoms scattered over a longer slot array: (planes (M, 3), inv)."""
    rng = np.random.default_rng(seed + 100)
    n = len(x)
    m = n + NSLOT_PAD
    inv = rng.permutation(m)[:n]
    planes = rng.uniform(0, 1, (m, 3)) * L      # empty slots hold garbage
    planes[inv] = x
    return planes, inv


def _torch_planes(planes):
    return tuple(torch.from_numpy(np.ascontiguousarray(planes[:, a]))
                 for a in range(3))


KINDS = ["bonds", "angles_harmonic", "angles_charmm", "dihedrals",
         "dihedrals_14", "impropers"]


@pytest.mark.parametrize("kind", KINDS)
def test_compute_bonded_matches_jax(kind):
    x, kw = _terms(kind, KINDS.index(kind))
    planes, inv = _slots(x, KINDS.index(kind))
    jstyle = jmake_bonded(**kw)
    jidx = {}
    for name in ("bonds", "angles", "dihedrals", "impropers"):
        table = getattr(jstyle, name)
        if len(table):
            jidx[f"{name}_idx"] = inv[table[:, 1:]]
    jr = jcompute(jstyle, jax.numpy.asarray(planes),
                  jmake_box(np.zeros(3), L), eflag=True,
                  acc_dtype=jax.numpy.float64, **jidx)
    tr = compute_bonded(make_bonded(**_port(kw)), _torch_planes(planes),
                        make_box(np.zeros(3), L), eflag=True,
                        acc_dtype=torch.float64,
                        inv=torch.from_numpy(inv.astype(np.int32)))
    jf = np.asarray(jr.f)
    tf = torch.stack([tr.fx, tr.fy, tr.fz], -1).numpy()
    assert np.abs(jf).max() > 1.0
    assert np.abs(tf - jf).max() <= 1e-10 * np.abs(jf).max()
    for name in ("ebond", "eangle", "edihed", "eimp", "e14_lj", "e14_coul",
                 "emol"):
        a, b = float(getattr(tr, name)), float(getattr(jr, name))
        assert abs(a - b) <= 1e-10 * abs(b), (name, a, b)
    active = {"bonds": "ebond", "angles_harmonic": "eangle",
              "angles_charmm": "eangle", "dihedrals": "edihed",
              "dihedrals_14": "e14_coul", "impropers": "eimp"}[kind]
    assert abs(float(getattr(jr, active))) > 1e-3
    jv = np.asarray(jr.virial)
    assert np.abs(tr.virial.numpy() - jv).max() <= 1e-9 * np.abs(jv).max()


def test_compute_bonded_whole_molecule_and_out():
    """Every class at once on atom-order planes (no map), forces added to
    the planes the caller passes, and force-only equal to eflag forces."""
    x, kw = _terms("bonds", 11)
    for kind in ("angles_charmm", "dihedrals_14", "impropers"):
        kw.update(_terms(kind, 11)[1])
    box = make_box(np.zeros(3), L)
    jr = jcompute(jmake_bonded(**kw), jax.numpy.asarray(x),
                  jmake_box(np.zeros(3), L), eflag=True,
                  acc_dtype=jax.numpy.float64)
    # the JAX package's tables carried over as numpy arrays
    jfields = dataclasses.asdict(jmake_bonded(**kw))
    style = bonded_from_numpy(jfields)
    assert style.angle_style == "charmm" and len(style.d14) == NMOL
    start = np.random.default_rng(5).normal(size=(3, len(x)))
    out = tuple(torch.from_numpy(start[a].copy()) for a in range(3))
    tr = compute_bonded(style, _torch_planes(x), box, eflag=True,
                        acc_dtype=torch.float64, out=out)
    assert tr.fx is out[0]
    tf = torch.stack(out, -1).numpy() - start.T
    jf = np.asarray(jr.f)
    assert np.abs(tf - jf).max() <= 1e-10 * np.abs(jf).max()
    assert abs(float(tr.emol) - float(jr.emol)) <= 1e-10 * abs(float(jr.emol))
    fo = compute_bonded_plain(style, _torch_planes(x), box, eflag=False,
                              acc_dtype=torch.float64)
    assert float(fo.emol) == 0.0
    assert np.abs(torch.stack([fo.fx, fo.fy, fo.fz], -1).numpy()
                  - tf).max() <= 1e-12 * np.abs(jf).max()


def _fd_forces(energy, x, h=1e-5):
    f = np.zeros_like(x)
    for i in range(x.shape[0]):
        for a in range(3):
            xp, xm = x.copy(), x.copy()
            xp[i, a] += h
            xm[i, a] -= h
            f[i, a] = -(energy(xp) - energy(xm)) / (2 * h)
    return f


@pytest.mark.parametrize("kind", ["dihedrals", "dihedrals_14", "impropers"])
def test_hand_gradient_matches_finite_differences(kind):
    x, kw = _terms(kind, 21)
    keep = 6                                   # molecules differentiated
    x = x[:4 * keep]
    for name in ("dihedrals", "impropers", "d14"):
        if name in kw:
            kw[name] = kw[name][:keep]
    # away from the faces: finite differences do not cross a wrap
    x = x - x[::4].repeat(4, 0) + 0.5 * L
    style = make_bonded(**kw)
    box = make_box(np.zeros(3), L)

    def energy(pos):
        r = compute_bonded_plain(style, _torch_planes(pos), box, eflag=True,
                                 acc_dtype=torch.float64)
        return float(r.emol + r.e14_lj + r.e14_coul)

    r = compute_bonded_plain(style, _torch_planes(x), box, eflag=False,
                             acc_dtype=torch.float64)
    f = torch.stack([r.fx, r.fy, r.fz], -1).numpy()
    fd = _fd_forces(energy, x)
    assert np.abs(f).max() > 0.1
    assert np.abs(f - fd).max() <= 1e-5 * max(np.abs(fd).max(), 1.0)
    assert np.abs(f.sum(0)).max() <= 1e-10 * np.abs(f).max()


def test_planar_improper_inside_the_clip_gets_zero_force():
    x = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                  [1.0, 1.0, 0.0]]) + 5.0       # cis, exactly planar
    kw = dict(impropers=[[0, 0, 1, 2, 3]], improper_coeffs=[[5.0, 30.0]])
    jr = jcompute(jmake_bonded(**kw), jax.numpy.asarray(x),
                  jmake_box(np.zeros(3), L), eflag=True,
                  acc_dtype=jax.numpy.float64)
    tr = compute_bonded(make_bonded(**_port(kw)), _torch_planes(x),
                        make_box(np.zeros(3), L), eflag=True,
                        acc_dtype=torch.float64)
    assert float(jr.eimp) > 1.0
    assert abs(float(tr.eimp) - float(jr.eimp)) <= 1e-10 * float(jr.eimp)
    assert float(np.abs(np.asarray(jr.f)).max()) == 0.0
    assert float(torch.stack([tr.fx, tr.fy, tr.fz]).abs().max()) == 0.0


def test_bake_charmm_14_identical():
    from lammps_buck_intel_tpu.models.bonded import bake_charmm_14 as jbake

    _, kw = _terms("dihedrals", 3)
    rng = np.random.default_rng(9)
    typ, q = rng.integers(0, 2, 4 * NMOL), rng.uniform(-1, 1, 4 * NMOL)
    args = (kw["dihedrals"], np.asarray(kw["dihedral_coeffs"]), typ, q,
            np.array([0.04, 0.02]), np.array([3.4, 2.3]), 332.06371)
    assert np.array_equal(jbake(*args), bake_charmm_14(*args))
    assert tcharmm.bake_charmm_14(np.zeros((0, 5), np.int32), *args[1:]).shape \
        == (0, 3)
