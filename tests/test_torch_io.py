"""Data-file input of the port against the JAX package (CPU, host numpy).

``read_data`` and ``replicate`` must give arrays identical to the JAX
package's on examples/data.cristobalite and on a small charge file with
image flags and a Velocities section; the generator must reproduce the
committed data file byte for byte, and its jittered copy (the card's
force check) the same file every time; the atomic atom style, PairIJ
Coeffs and a tilted replicate raise (atom style full and the topology
sections are in tests/test_torch_topology.py).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from lammps_buck_intel_tpu.io import data_reader as jdata
from lammps_buck_intel_tpu.io import lattice as jlattice
from lammps_buck_intel_tpu_torch.io import data_reader as tdata
from lammps_buck_intel_tpu_torch.io import lattice as tlattice

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRISTOBALITE = os.path.join(ROOT, "examples", "data.cristobalite")
FIELDS = ("box_lo", "box_hi", "x", "v", "type", "q", "image", "mass")

_SMALL = """small charge file with images and velocities

4 atoms
2 atom types

-1.0 9.0 xlo xhi
0.0 8.0 ylo yhi
0.5 7.5 zlo zhi

Masses

1 28.0855
2 15.9994

Atoms # charge

3 2 -1.2 1.0 2.0 3.0 1 0 -1
1 1 2.4 8.5 7.9 0.6 0 -2 0
4 2 -1.2 4.0 4.0 4.0 0 0 0
2 1 0.0 -0.5 0.1 7.4 -1 1 1

Velocities

2 0.1 0.2 0.3
1 -0.1 0.0 0.05
4 0.0 0.0 0.0
3 1e-3 -2e-3 3e-3
"""


def _read_both(path):
    return jdata.read_data(path, native=False), tdata.read_data(path)


def _assert_same(a, b):
    for f in FIELDS:
        u, v = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert u.dtype == v.dtype and np.array_equal(u, v), f
    assert a.n_atoms == b.n_atoms and a.n_atom_types == b.n_atom_types
    assert (a.tilt is None) == (b.tilt is None)


def test_read_cristobalite_identical():
    a, b = _read_both(CRISTOBALITE)
    _assert_same(a, b)
    assert b.n_atoms == 1440 and b.n_atom_types == 2
    np.testing.assert_allclose(b.box_hi - b.box_lo, [28.64, 35.80, 21.48])
    assert abs(b.q.sum()) < 1e-9
    assert np.array_equal(np.bincount(b.type), [480, 960])


def test_read_images_and_velocities_identical(tmp_path):
    path = tmp_path / "data.small"
    path.write_text(_SMALL)
    a, b = _read_both(str(path))
    _assert_same(a, b)
    assert b.image[0].tolist() == [0, -2, 0] and b.v[2, 0] == 1e-3


@pytest.mark.parametrize("nrep", [(1, 1, 1), (2, 1, 3), (6, 5, 6)])
def test_replicate_identical(nrep, tmp_path):
    path = tmp_path / "data.small"
    path.write_text(_SMALL)
    for src in (CRISTOBALITE, str(path)):
        d = tdata.read_data(src)
        per_atom = {"type": d.type, "q": d.q, "image": d.image, "v": d.v}
        ja = jlattice.replicate(d.x, d.box_lo, d.box_hi, nrep,
                                per_atom=per_atom)
        tb = tlattice.replicate(d.x, d.box_lo, d.box_hi, nrep,
                                per_atom=per_atom)
        for u, v in zip(ja[:3], tb[:3]):
            assert np.array_equal(u, v)
        assert set(ja[3]) == set(tb[3])
        for k in ja[3]:
            assert np.array_equal(ja[3][k], tb[3][k]), k
        assert len(tb[0]) == d.n_atoms * int(np.prod(nrep))


def test_replicate_topology_raises():
    """A tilted box raises; a bond table is tiled with per-copy offsets."""
    d = tdata.read_data(CRISTOBALITE)
    with pytest.raises(NotImplementedError, match="item 14"):
        tlattice.replicate(d.x, d.box_lo, d.box_hi, (2, 1, 1),
                           tilt=np.array([0.5, 0.0, 0.0]))
    out = tlattice.replicate(d.x, d.box_lo, d.box_hi, (2, 1, 1),
                             bonds=np.array([[0, 0, 1]]))
    assert out[4].tolist() == [[0, 0, 1], [0, 1440, 1441]]
    assert out[5] is None and out[8] is None


def test_generator_reproduces_data_file(tmp_path):
    code = ("import sys; sys.path.insert(0, 'examples'); "
            "import gen_cristobalite as g; "
            f"g.write({str(tmp_path / 'out')!r})")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    with open(CRISTOBALITE) as f:
        assert (tmp_path / "out").read_text() == f.read()


def test_jittered_data_file(tmp_path):
    """The jittered copy the card's check rebuilds: the same file twice,
    read identically by both packages, every atom within amp of its
    ideal site (periodically) and inside the box."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import gen_cristobalite as g

    paths = [str(tmp_path / f"jit{i}") for i in range(2)]
    for p in paths:
        g.write(p, jitter_amp=0.1)
    with open(paths[0]) as a, open(paths[1]) as b:
        assert a.read() == b.read()
    ideal = tdata.read_data(CRISTOBALITE)
    t, j = tdata.read_data(paths[0]), jdata.read_data(paths[0])
    for name in FIELDS:
        assert np.array_equal(getattr(t, name), np.asarray(getattr(j, name)))
    L = ideal.box_hi - ideal.box_lo
    d = t.x - ideal.x
    d -= L * np.round(d / L)
    assert 0.05 < np.abs(d).max() <= 0.1 + 1e-6
    assert (t.x >= 0).all() and (t.x <= L).all()
    assert np.array_equal(t.type, ideal.type) and np.array_equal(t.q, ideal.q)


@pytest.mark.parametrize("body,match", [
    ("\n1 atoms\n1 atom types\n\n0 1 xlo xhi\n0 1 ylo yhi\n0 1 zlo zhi\n"
     "\nAtoms # atomic\n\n1 1 0.1 0.1 0.1\n", "atom style"),
    ("\n1 atoms\n1 atom types\n\n0 1 xlo xhi\n0 1 ylo yhi\n0 1 zlo zhi\n"
     "\nAtoms\n\n1 1 0.1 0.1 0.1 0 0 0\n", "atom style"),
    ("\n1 atoms\n1 atom types\n\n0 1 xlo xhi\n0 1 ylo yhi\n0 1 zlo zhi\n"
     "\nPairIJ Coeffs\n\n1 1 1.0 1.0\n", "section"),
])
def test_unported_data_raises(body, match, tmp_path):
    path = tmp_path / "data.bad"
    path.write_text("comment\n" + body)
    with pytest.raises(NotImplementedError, match=match):
        tdata.read_data(str(path))
