"""Molecular topology of the port against the JAX package (host numpy).

``read_data`` of examples/data.rhodo_class (atom style full: 1,728 atoms
in 216 eight-atom molecules, 1,512 bonds, 1,080 angles, 432 dihedrals, 216
impropers) gives arrays identical to the JAX reader's; ``build_topology``
the identical 1-2/1-3/1-4 partner table (S = 7); ``replicate`` with
topology and molecule ids identical tables at [2, 1, 1] and [1, 2, 3].
"""
import os

import numpy as np
import pytest

from lammps_buck_intel_tpu import core as jcore
from lammps_buck_intel_tpu.io import data_reader as jdata
from lammps_buck_intel_tpu.io import lattice as jlattice
from lammps_buck_intel_tpu_torch import core as tcore
from lammps_buck_intel_tpu_torch.interop import topology_from_numpy
from lammps_buck_intel_tpu_torch.io import data_reader as tdata
from lammps_buck_intel_tpu_torch.io import lattice as tlattice

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RHODO = os.path.join(ROOT, "examples", "data.rhodo_class")
ARRAYS = ("x", "v", "type", "q", "molecule", "image", "mass", "bonds",
          "angles", "dihedrals", "impropers", "box_lo", "box_hi")
TABLES = ("bonds", "angles", "dihedrals", "impropers")


def test_read_rhodo_class_identical():
    a, b = jdata.read_data(RHODO, native=False), tdata.read_data(RHODO)
    for f in ARRAYS:
        u, v = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert u.dtype == v.dtype and np.array_equal(u, v), f
    for f in ("bond_coeffs", "angle_coeffs", "dihedral_coeffs",
              "improper_coeffs", "pair_coeffs"):
        assert getattr(a, f) == getattr(b, f), f
    assert b.n_atoms == 1728 and b.n_atom_types == 2
    assert [len(getattr(b, t)) for t in TABLES] == [1512, 1080, 432, 216]
    assert b.molecule.max() == 215 and np.abs(b.v).max() > 0
    assert (np.bincount(b.molecule) == 8).all()


def test_read_full_style_with_coeff_sections(tmp_path):
    """Atom style full by column count (no tag), coefficient sections and
    unsorted ids, against the JAX reader."""
    path = tmp_path / "data.mol"
    path.write_text("""molecule

3 atoms
2 bonds
1 angles
2 atom types
1 bond types
1 angle types

0 9 xlo xhi
0 9 ylo yhi
0 9 zlo zhi

Masses

1 15.9994
2 1.008

Pair Coeffs

1 0.1553 3.166
2 0.0 0.0

Bond Coeffs

1 450.0 1.0

Angle Coeffs

1 55.0 109.47

Atoms

2 1 2 0.4238 1.8 1.0 1.0
1 1 1 -0.8476 1.0 1.0 1.0
3 1 2 0.4238 0.7 1.9 1.0

Bonds

2 1 1 3
1 1 1 2

Angles

1 1 2 1 3
""")
    a, b = jdata.read_data(str(path), native=False), tdata.read_data(str(path))
    for f in ARRAYS:
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert b.pair_coeffs == a.pair_coeffs == {0: [0.1553, 3.166],
                                              1: [0.0, 0.0]}
    assert b.bond_coeffs == {0: [450.0, 1.0]}
    assert b.bonds.tolist() == [[0, 0, 1], [0, 0, 2]]
    assert b.angles.tolist() == [[0, 1, 0, 2]]


def test_build_topology_identical():
    d = tdata.read_data(RHODO)
    kw = dict(bonds=d.bonds, angles=d.angles, dihedrals=d.dihedrals,
              impropers=d.impropers)
    a = jcore.build_topology(d.n_atoms, **kw)
    b = tcore.build_topology(d.n_atoms, **kw)
    p = topology_from_numpy(a.bonds, a.angles, a.dihedrals, a.impropers,
                            a.special_idx, a.special_code)
    for t in (b, p):
        for f in TABLES + ("special_idx", "special_code"):
            u, v = getattr(a, f), getattr(t, f)
            assert u.dtype == v.dtype and np.array_equal(u, v), f
        assert t.has_special
    assert b.special_idx.shape == (1728, 7)
    # symmetric: j lists i with the code i lists j with
    i = 5
    for j, code in zip(b.special_idx[i], b.special_code[i]):
        if j >= 0:
            assert code == b.special_code[j][list(b.special_idx[j]).index(i)]
    e = tcore.empty_topology(10)
    je = jcore.empty_topology(10)
    assert e.special_idx.shape == je.special_idx.shape == (10, 0)
    assert not e.has_special
    assert tcore.build_topology(4).special_idx.shape == (4, 0)


@pytest.mark.parametrize("nrep", [(2, 1, 1), (1, 2, 3)])
def test_replicate_with_topology_identical(nrep):
    d = tdata.read_data(RHODO)
    per_atom = {"type": d.type, "q": d.q, "image": d.image, "v": d.v}
    kw = dict(per_atom=per_atom, bonds=d.bonds, angles=d.angles,
              dihedrals=d.dihedrals, impropers=d.impropers,
              molecule=d.molecule)
    a = jlattice.replicate(d.x, d.box_lo, d.box_hi, nrep, **kw)
    b = tlattice.replicate(d.x, d.box_lo, d.box_hi, nrep, **kw)
    assert len(a) == len(b) == 9
    for k in (0, 1, 2, 4, 5, 6, 7, 8):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for k in a[3]:
        assert np.array_equal(a[3][k], b[3][k]), k
    copies = int(np.prod(nrep))
    assert len(b[4]) == 1512 * copies and b[4][:, 1:].max() < 1728 * copies
    assert b[8].max() == 216 * copies - 1
    assert not b[3]["image"].any()     # unwrapped before tiling
