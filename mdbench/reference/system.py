"""A deck's atoms worked out from its own files: the data file, the
replication, the units, the seeded velocities and the constraints.

Plain numpy, written from the LAMMPS semantics of ``read_data``
(atom styles charge and full), ``replicate`` (positions unwrapped by their
image flags, copies tiled x fastest, topology offset per copy),
``velocity create`` with the YAML decks' numpy stream (a Gaussian draw per
atom and axis from ``numpy.random.RandomState(seed & 0x7fffffff)``,
scaled by 1/sqrt(m), zero total momentum, rescaled to the target over
3N - 3 degrees of freedom) and ``fix shake m``.  Nothing here reads the
program under test.
"""
from __future__ import annotations

import numpy as np

# LAMMPS unit constants (update.cpp / force.cpp)
UNITS = {
    "metal": dict(boltz=8.617343e-5, mvv2e=1.0364269e-4,
                  ftm2v=1.0 / 1.0364269e-4, nktv2p=1.6021765e6,
                  qqrd2e=14.399645),
    "real": dict(boltz=0.0019872067, mvv2e=48.88821291 * 48.88821291,
                 ftm2v=1.0 / 48.88821291 / 48.88821291, nktv2p=68568.415,
                 qqrd2e=332.06371),
}

_TOPO = {"Bonds": 3, "Angles": 4, "Dihedrals": 5, "Impropers": 5}
_SECTIONS = ("Masses", "Atoms", "Velocities") + tuple(_TOPO)


def read_data(path: str) -> dict:
    """x, image, typ (0-based), q, mol, v, mass per type, lo, hi and the
    four topology tables (type and atoms, 0-based) of a data file."""
    with open(path) as f:
        lines = [ln.split("#")[0].strip() for ln in f.readlines()[1:]]
    lo, hi, n, ntypes = np.zeros(3), np.ones(3), 0, 1
    i = 0
    while i < len(lines) and lines[i] not in _SECTIONS:
        t = lines[i].split()
        if t[-2:] == ["atom", "types"]:
            ntypes = int(t[0])
        elif t[-1:] == ["atoms"]:
            n = int(t[0])
        elif len(t) == 4 and t[2][1:] == "lo":
            ax = "xyz".index(t[2][0])
            lo[ax], hi[ax] = float(t[0]), float(t[1])
        i += 1
    d = dict(x=np.zeros((n, 3)), image=np.zeros((n, 3), np.int64),
             typ=np.zeros(n, np.int64), q=np.zeros(n),
             mol=np.zeros(n, np.int64), v=np.zeros((n, 3)),
             mass=np.ones(ntypes), lo=lo, hi=hi)
    for name in _TOPO:
        d[name.lower()] = np.zeros((0, _TOPO[name]), np.int64)
    while i < len(lines):
        name = lines[i]
        i += 1
        rows = []
        while i < len(lines) and lines[i] not in _SECTIONS:
            if lines[i]:
                rows.append(lines[i].split())
            i += 1
        if name == "Masses":
            for r in rows:
                d["mass"][int(r[0]) - 1] = float(r[1])
        elif name == "Velocities":
            for r in rows:
                d["v"][int(r[0]) - 1] = [float(s) for s in r[1:4]]
        elif name == "Atoms":
            full = len(rows[0]) in (7, 10)
            for r in rows:
                a = int(r[0]) - 1
                k = 1
                if full:
                    d["mol"][a] = int(r[1]) - 1
                    k = 2
                d["typ"][a] = int(r[k]) - 1
                d["q"][a] = float(r[k + 1])
                d["x"][a] = [float(s) for s in r[k + 2:k + 5]]
                if len(r) >= k + 8:
                    d["image"][a] = [int(s) for s in r[k + 5:k + 8]]
        else:
            tab = np.asarray([[int(s) - 1 for s in r[1:1 + _TOPO[name]]]
                              for r in rows], np.int64)
            order = np.argsort([int(r[0]) for r in rows], kind="stable")
            d[name.lower()] = tab[order].reshape(-1, _TOPO[name])
    return d


def replicate(d: dict, rep) -> dict:
    """``replicate nx ny nz``: positions unwrapped by their images, copies
    tiled with x fastest, atom indices of the topology offset per copy."""
    L = d["hi"] - d["lo"]
    x = d["x"] + d["image"] * L
    nx, ny, nz = rep
    shifts = np.asarray([[ix, iy, iz] for iz in range(nz) for iy in range(ny)
                         for ix in range(nx)], np.float64) * L
    nrep, n = len(shifts), len(x)
    out = dict(d)
    out["x"] = (x[None] + shifts[:, None]).reshape(-1, 3)
    out["image"] = np.zeros((n * nrep, 3), np.int64)
    out["hi"] = d["lo"] + L * np.asarray(rep, np.float64)
    for k in ("typ", "q", "v"):
        out[k] = np.concatenate([d[k]] * nrep)
    out["mol"] = np.concatenate([d["mol"] + r * (d["mol"].max() + 1)
                                 for r in range(nrep)])
    for name in _TOPO:
        t = d[name.lower()]
        off = np.zeros(t.shape[1], np.int64)
        off[1:] = n
        out[name.lower()] = np.concatenate([t + r * off for r in range(nrep)])
    return out


def temperature(v, mass_atom, units: dict, dof: int) -> float:
    return float((mass_atom[:, None] * v * v).sum()) * units["mvv2e"] / (
        dof * units["boltz"])


def velocities(n: int, temp: float, seed: int, mass_atom, units: dict):
    """``velocity all create temp seed`` with the numpy stream: Gaussian,
    zero momentum, exact rescale over 3N - 3 degrees of freedom."""
    r = np.random.RandomState(int(seed) & 0x7FFFFFFF)
    v = r.standard_normal((n, 3)) / np.sqrt(mass_atom)[:, None]
    p = (mass_atom[:, None] * v).sum(0)
    v -= (p / mass_atom.sum())[None, :]
    t = temperature(v, mass_atom, units, max(3 * n - 3, 1))
    return v * np.sqrt(temp / t)


def shake_bonds(d: dict, masses) -> np.ndarray:
    """``fix shake m <masses>``: every bond of a type that has a bond to an
    atom whose mass is within 0.1 of a listed value; (Nc, 3) rows of
    (type, i, j)."""
    b = d["bonds"]
    if not len(b):
        return b
    m = d["mass"][d["typ"]]
    light = np.any(np.abs(m[:, None] - np.atleast_1d(masses)[None]) <= 0.1,
                   axis=1)
    sel = light[b[:, 1]] | light[b[:, 2]]
    return b[np.isin(b[:, 0], np.unique(b[sel, 0]))]


def build(deck: dict, seed: int) -> dict:
    """The deck's atoms: read, replicated, the seeded velocities when the
    deck has a ``velocity`` key; with ``lo`` and box lengths ``L``."""
    base = read_data(deck["read_data"])
    d = replicate(base, deck["replicate"]) if deck.get("replicate") else \
        dict(base)
    d["base"] = base
    units = UNITS[deck["units"]]
    mass_atom = d["mass"][d["typ"]]
    if deck.get("velocity"):
        d["v"] = velocities(len(d["x"]), deck["velocity"]["temp"], seed,
                            mass_atom, units)
    d["L"] = d["hi"] - d["lo"]
    d["mass_atom"] = mass_atom
    d["units"] = units
    return d
