"""``velocity create`` — initial velocity seeding.

Host-LAMMPS command used by every deck (e.g. examples/in.buck:19,
in.spce:33 ``dist uniform``).  Two streams are offered:

- ``rng="numpy"`` (YAML-deck default, keeps existing goldens valid):
  matches semantics (distribution, zeroed aggregate linear momentum,
  exact rescale to the target temperature) but not LAMMPS' RNG stream.
- ``rng="lammps"`` (the literal input-script translator's default):
  reproduces host LAMMPS ``velocity <group> create`` with its default
  ``loop all`` — one RanPark (Park-Miller minimal standard) generator
  seeded once, advanced three draws per atom tag in ascending-tag order,
  ``uniform()-0.5`` triplets for ``dist uniform`` and polar Box-Muller
  ``gaussian()`` (with the odd-draw carry) for ``dist gaussian``, each
  scaled by 1/sqrt(mass) — followed by momentum zeroing and the exact
  temperature rescale.  The LCG core is pinned by Park & Miller's
  published fixed point (seed 1 -> 1043618065 after 10,000 steps,
  tests/test_io.py); the loop semantics follow the documented
  velocity-create contract, giving per-atom-value parity with LAMMPS
  traces, not just statistical parity.

  Parity scope for ``loop all``: the k-th triplet belongs to tag k+1, so
  per-atom parity requires array order == ascending-tag order — true for
  sorted read_data (data_reader sorts by id), lattice generation, and
  copy-major replicate; callers with a different id layout pass ``tags``.
  ``delete_atoms`` before ``velocity`` compresses tags preserving
  relative order (host default), which array-order deletion mirrors.
  ``loop geom`` is order-free by construction but additionally needs
  bit-identical f64 coordinates with the host run.
"""
from __future__ import annotations

import numpy as np


class RanPark:
    """Park-Miller minimal-standard LCG + polar Box-Muller gaussian —
    host LAMMPS' RanPark stream (the `velocity create` default RNG)."""

    IA, IM, IQ, IR = 16807, 2147483647, 127773, 2836
    AM = 1.0 / 2147483647

    def __init__(self, seed: int):
        if seed <= 0:
            raise ValueError("RanPark seed must be > 0")
        self.seed = seed % self.IM
        if self.seed == 0:
            self.seed = 1
        self._save = None

    def uniform(self) -> float:
        k = self.seed // self.IQ
        s = self.IA * (self.seed - k * self.IQ) - self.IR * k
        if s < 0:
            s += self.IM
        self.seed = s
        return self.AM * s

    def gaussian(self) -> float:
        if self._save is not None:
            first, self._save = self._save, None
            return first
        while True:
            v1 = 2.0 * self.uniform() - 1.0
            v2 = 2.0 * self.uniform() - 1.0
            rsq = v1 * v1 + v2 * v2
            if 0.0 < rsq < 1.0:
                break
        fac = np.sqrt(-2.0 * np.log(rsq) / rsq)
        self._save = v1 * fac
        return v2 * fac

    def reset_coord(self, seed_init: int, coord) -> None:
        """``loop geom`` per-atom reseed: Jenkins one-at-a-time hash of
        the seed and the atom's coordinate BYTES (signed chars over the
        three raw doubles), truncated to 27 bits (the upstream quirk:
        ``hash & 0x7ffffff`` — seven f's), then a 5-draw warm-up.
        Per-atom parity through this path additionally requires
        bit-identical f64 coordinates with the host run."""
        M = 0xFFFFFFFF
        h = int(seed_init) & M
        for byte in np.frombuffer(
                np.asarray(coord, np.float64).tobytes(), np.int8):
            h = (h + int(byte)) & M
            h = (h + ((h << 10) & M)) & M
            h ^= h >> 6
        h = (h + ((h << 3) & M)) & M
        h ^= h >> 11
        h = (h + ((h << 15) & M)) & M
        self.seed = h & 0x7FFFFFF
        if self.seed == 0:
            self.seed = 1
        for _ in range(5):
            self.uniform()
        self._save = None


def temperature(v: np.ndarray, mass_per_atom: np.ndarray, units,
                extra_dof: int = 3) -> float:
    """Instantaneous temperature: T = sum(m v^2) * mvv2e / (dof * boltz)."""
    n = v.shape[0]
    dof = max(3 * n - extra_dof, 1)
    ke2 = float(np.sum(mass_per_atom[:, None] * v * v)) * units.mvv2e
    return ke2 / (dof * units.boltz)


def create(
    n_atoms: int,
    t_target: float,
    seed: int,
    mass_per_atom: np.ndarray,
    units,
    dist: str = "gaussian",
    zero_momentum: bool = True,
    rng: str = "numpy",
    tags: np.ndarray | None = None,
    loop: str = "all",
    coords: np.ndarray | None = None,
) -> np.ndarray:
    if rng == "lammps":
        if dist not in ("gaussian", "uniform"):
            raise ValueError(f"unknown velocity distribution {dist!r}")
        off = 0.5 if dist == "uniform" else 0.0
        if loop == "geom":
            # per-atom reseed from the coordinate hash: the stream is
            # decomposition-independent by construction (no tag order)
            if coords is None:
                raise ValueError("loop geom needs atom coordinates")
            gen = RanPark(1)
            draw = gen.gaussian if dist == "gaussian" else gen.uniform
            v = np.empty((n_atoms, 3))
            for i in range(n_atoms):
                gen.reset_coord(int(seed), coords[i])
                v[i] = (draw() - off, draw() - off, draw() - off)
        elif loop == "all":
            gen = RanPark(int(seed))
            draw = gen.gaussian if dist == "gaussian" else gen.uniform
            # three draws per tag in ascending-tag order; uniform
            # triplets are centered (u - 0.5) as velocity-create does
            raw = np.array([[draw() - off for _ in range(3)]
                            for _ in range(n_atoms)])
            if tags is not None:
                # row for tag t goes to the atom holding tag t
                order = np.argsort(np.asarray(tags), kind="stable")
                v = np.empty_like(raw)
                v[order] = raw
            else:
                v = raw
        else:
            raise ValueError(f"unknown velocity loop {loop!r}")
        v /= np.sqrt(mass_per_atom)[:, None]
    elif rng == "numpy":
        r = np.random.RandomState(seed & 0x7FFFFFFF)
        if dist == "gaussian":
            v = r.standard_normal((n_atoms, 3))
        elif dist == "uniform":
            v = r.uniform(-1.0, 1.0, size=(n_atoms, 3))
        else:
            raise ValueError(f"unknown velocity distribution {dist!r}")
        v /= np.sqrt(mass_per_atom)[:, None]
    else:
        raise ValueError(f"unknown velocity rng {rng!r}")

    if zero_momentum and n_atoms > 1:
        p = np.sum(mass_per_atom[:, None] * v, axis=0)
        v -= (p / mass_per_atom.sum())[None, :]

    t_now = temperature(v, mass_per_atom, units)
    if t_now > 0:
        v *= np.sqrt(t_target / t_now)
    return v
