"""LAMMPS data-file reader for ``atom_style charge`` (host numpy).

Counterpart of ``lammps_buck_intel_tpu.io.data_reader.read_data`` for the
files the port's decks read: the header (counts, orthogonal box bounds,
tilt factors), ``Masses``, ``Atoms # charge`` with optional image flags,
and an optional ``Velocities`` section.  Atom rows come back sorted by
atom id, ids and types 0-based, exactly as the JAX package returns them.
Topology sections, coefficient sections and the atomic/full atom styles
raise NotImplementedError (ROADMAP queue 1 item 12).  Pure Python: the
JAX package's native fast path exists for files far larger than these.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_SECTION_NAMES = (
    "Masses", "Atoms", "Velocities", "Bonds", "Angles", "Dihedrals",
    "Impropers", "Pair Coeffs", "PairIJ Coeffs", "Bond Coeffs",
    "Angle Coeffs", "Dihedral Coeffs", "Improper Coeffs",
)
_PORTED_SECTIONS = ("Masses", "Atoms", "Velocities")
_TOPOLOGY_COUNTS = ("bonds", "angles", "dihedrals", "impropers")
_UNPORTED = "ROADMAP queue 1 item 12 (molecular decks)"


@dataclasses.dataclass
class DataFile:
    """Parsed LAMMPS data file (charge style); atom rows sorted by id."""

    n_atoms: int = 0
    n_atom_types: int = 0
    box_lo: np.ndarray = None
    box_hi: np.ndarray = None
    tilt: np.ndarray = None       # (3,) [xy, xz, yz] or None (orthogonal)
    x: np.ndarray = None          # (N, 3) f64
    v: np.ndarray = None          # (N, 3) f64 (zeros without Velocities)
    type: np.ndarray = None       # (N,) int32, 0-based
    q: np.ndarray = None          # (N,) f64
    image: np.ndarray = None      # (N, 3) int32
    mass: np.ndarray = None       # (ntypes,) f64


def _strip(line: str) -> str:
    if "#" in line:
        line = line[: line.index("#")]
    return line.strip()


def _section_name(line: str):
    for name in _SECTION_NAMES:
        if line == name or line.startswith(name + " "):
            return name
    return None


def _atom_style(tag: str, rows) -> str:
    """The 'Atoms # style' tag, else the JAX package's column-count rule
    (atomic 5/8, charge 6/9, full 7/10 columns)."""
    if tag in ("atomic", "charge", "full"):
        return tag
    return {5: "atomic", 6: "charge", 7: "full", 8: "atomic", 9: "charge",
            10: "full"}[len(rows[0])]


def read_data(path: str) -> DataFile:
    """Parse a LAMMPS data file of atom style charge."""
    with open(path) as f:
        raw = f.readlines()
    d = DataFile()
    lo, hi = np.zeros(3), np.ones(3)

    i = 1  # the first line is a comment by format definition
    while i < len(raw):
        line = _strip(raw[i])
        if line and _section_name(line):
            break
        toks = line.split()
        if toks[-2:] == ["atom", "types"]:
            d.n_atom_types = int(toks[0])
        elif toks[-1:] == ["atoms"]:
            d.n_atoms = int(toks[0])
        elif len(toks) == 2 and toks[1] in _TOPOLOGY_COUNTS:
            if int(toks[0]) > 0:
                raise NotImplementedError(
                    f"{path}: {toks[0]} {toks[1]}: topology is not ported: "
                    f"{_UNPORTED}")
        elif toks[-2:] in (["xlo", "xhi"], ["ylo", "yhi"], ["zlo", "zhi"]):
            ax = "xyz".index(toks[-2][0])
            lo[ax], hi[ax] = float(toks[0]), float(toks[1])
        elif toks[-3:] == ["xy", "xz", "yz"]:
            d.tilt = np.array([float(t) for t in toks[:3]])
        i += 1
    if d.n_atoms <= 0:
        raise ValueError(f"{path}: no 'N atoms' header line; not a LAMMPS "
                         "data file?")
    n = d.n_atoms
    d.box_lo, d.box_hi = lo, hi
    d.x = np.zeros((n, 3))
    d.v = np.zeros((n, 3))
    d.type = np.zeros(n, np.int32)
    d.q = np.zeros(n)
    d.image = np.zeros((n, 3), np.int32)
    d.mass = np.ones(max(d.n_atom_types, 1))

    while i < len(raw):
        name = _section_name(_strip(raw[i]))
        tag = raw[i].split("#")[1].strip() if "#" in raw[i] else ""
        i += 1
        if name is None:
            continue
        if name not in _PORTED_SECTIONS:
            raise NotImplementedError(
                f"{path}: section {name!r} is not ported: {_UNPORTED}")
        rows = []
        while i < len(raw):
            line = _strip(raw[i])
            if line and _section_name(line):
                break
            if line:
                rows.append(line.split())
            i += 1
        if name == "Masses":
            for r in rows:
                d.mass[int(r[0]) - 1] = float(r[1])
        elif name == "Velocities":
            for r in rows:
                d.v[int(r[0]) - 1] = [float(r[1]), float(r[2]), float(r[3])]
        else:
            style = _atom_style(tag, rows)
            if style != "charge":
                raise NotImplementedError(
                    f"{path}: atom style {style!r} is not ported (charge "
                    f"only): {_UNPORTED}")
            for r in rows:
                a = int(r[0]) - 1
                d.type[a] = int(r[1]) - 1
                d.q[a] = float(r[2])
                d.x[a] = [float(r[3]), float(r[4]), float(r[5])]
                if len(r) >= 9:
                    d.image[a] = [int(r[6]), int(r[7]), int(r[8])]
    return d
