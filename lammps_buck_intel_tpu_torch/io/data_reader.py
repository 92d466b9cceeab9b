"""LAMMPS data-file reader for atom styles charge and full (host numpy).

Counterpart of ``lammps_buck_intel_tpu.io.data_reader.read_data`` for the
files the port's decks read: the header (counts, orthogonal box bounds,
tilt factors), ``Masses``, ``Atoms # charge`` / ``Atoms # full`` with
optional image flags, ``Velocities``, the ``Bonds`` / ``Angles`` /
``Dihedrals`` / ``Impropers`` tables and the ``* Coeffs`` sections.  Atom
rows come back sorted by atom id, ids and types 0-based, exactly as the
JAX package returns them.  The atomic atom style and ``PairIJ Coeffs``
raise NotImplementedError.  Pure Python: the JAX package's native fast
path exists for files far larger than these.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_SECTION_NAMES = (
    "Masses", "Atoms", "Velocities", "Bonds", "Angles", "Dihedrals",
    "Impropers", "Pair Coeffs", "PairIJ Coeffs", "Bond Coeffs",
    "Angle Coeffs", "Dihedral Coeffs", "Improper Coeffs",
)
# header count -> (DataFile table, columns [type, atoms...])
_TOPOLOGY = {"bonds": 3, "angles": 4, "dihedrals": 5, "impropers": 5}
_COEFFS = {"Pair Coeffs": "pair_coeffs", "Bond Coeffs": "bond_coeffs",
           "Angle Coeffs": "angle_coeffs",
           "Dihedral Coeffs": "dihedral_coeffs",
           "Improper Coeffs": "improper_coeffs"}


@dataclasses.dataclass
class DataFile:
    """Parsed LAMMPS data file; atom rows sorted by id, all ids and types
    0-based."""

    n_atoms: int = 0
    n_atom_types: int = 0
    box_lo: np.ndarray = None
    box_hi: np.ndarray = None
    tilt: np.ndarray = None       # (3,) [xy, xz, yz] or None (orthogonal)
    x: np.ndarray = None          # (N, 3) f64
    v: np.ndarray = None          # (N, 3) f64 (zeros without Velocities)
    type: np.ndarray = None       # (N,) int32, 0-based
    q: np.ndarray = None          # (N,) f64
    molecule: np.ndarray = None   # (N,) int32, 0-based
    image: np.ndarray = None      # (N, 3) int32
    mass: np.ndarray = None       # (ntypes,) f64
    bonds: np.ndarray = None      # (Nb, 3) int32 [type, i, j]
    angles: np.ndarray = None     # (Na, 4) int32 [type, i, j, k]
    dihedrals: np.ndarray = None  # (Nd, 5)
    impropers: np.ndarray = None  # (Ni, 5)
    bond_coeffs: dict = dataclasses.field(default_factory=dict)
    angle_coeffs: dict = dataclasses.field(default_factory=dict)
    dihedral_coeffs: dict = dataclasses.field(default_factory=dict)
    improper_coeffs: dict = dataclasses.field(default_factory=dict)
    pair_coeffs: dict = dataclasses.field(default_factory=dict)


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
    """Parse a LAMMPS data file of atom style charge or full."""
    with open(path) as f:
        raw = f.readlines()
    d = DataFile()
    lo, hi = np.zeros(3), np.ones(3)
    counts = dict.fromkeys(_TOPOLOGY, 0)

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
        elif len(toks) == 2 and toks[1] in _TOPOLOGY:
            counts[toks[1]] = int(toks[0])
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
    d.molecule = np.zeros(n, np.int32)
    d.image = np.zeros((n, 3), np.int32)
    d.mass = np.ones(max(d.n_atom_types, 1))
    for name, cols in _TOPOLOGY.items():
        setattr(d, name, np.zeros((counts[name], cols), np.int32))

    while i < len(raw):
        name = _section_name(_strip(raw[i]))
        tag = raw[i].split("#")[1].strip() if "#" in raw[i] else ""
        i += 1
        if name is None:
            continue
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
        elif name == "Atoms":
            _parse_atoms(path, d, rows, _atom_style(tag, rows))
        elif name.lower() in _TOPOLOGY:
            table = getattr(d, name.lower())
            for r in rows:
                table[int(r[0]) - 1] = [int(t) - 1
                                        for t in r[1:1 + table.shape[1]]]
        elif name in _COEFFS:
            coeffs = getattr(d, _COEFFS[name])
            for r in rows:
                coeffs[int(r[0]) - 1] = [float(t) for t in r[1:]]
        else:
            raise NotImplementedError(
                f"{path}: section {name!r} is not ported (the JAX package "
                "does not read it either)")
    return d


def _parse_atoms(path: str, d: DataFile, rows, style: str):
    if style not in ("charge", "full"):
        raise NotImplementedError(
            f"{path}: atom style {style!r} is not ported (charge and full "
            "only): ROADMAP queue 1 item 15")
    first = 1 if style == "full" else 0   # full rows carry a molecule id
    for r in rows:
        a = int(r[0]) - 1
        if first:
            d.molecule[a] = int(r[1]) - 1
        d.type[a] = int(r[first + 1]) - 1
        d.q[a] = float(r[first + 2])
        vals = r[first + 3:]
        d.x[a] = [float(vals[0]), float(vals[1]), float(vals[2])]
        if len(vals) >= 6:
            d.image[a] = [int(vals[3]), int(vals[4]), int(vals[5])]
