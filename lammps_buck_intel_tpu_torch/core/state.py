"""Per-atom simulation state as torch tensors on one device.

Counterpart of ``lammps_buck_intel_tpu.core.state`` (``System``,
``make_system``, ``Topology``, ``build_topology``).  The topology is host
numpy, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .box import Box


@dataclasses.dataclass
class System:
    """Dynamic per-atom state.

    x:     (N, 3) positions.
    v:     (N, 3) velocities.
    q:     (N,) charges (zeros when the atom style has none).
    type:  (N,) int32 atom type, 0-based.
    image: (N, 3) int32 periodic image flags.
    box:   orthogonal periodic box (host numpy).
    mass:  (ntypes,) per-type mass.
    molecule: (N,) int32 molecule ids (0 when the atom style has none).
    """

    x: torch.Tensor
    v: torch.Tensor
    q: torch.Tensor
    type: torch.Tensor
    image: torch.Tensor
    box: Box
    mass: torch.Tensor
    molecule: torch.Tensor

    @property
    def n_atoms(self) -> int:
        return self.x.shape[0]

    @property
    def n_types(self) -> int:
        return self.mass.shape[0]


def make_system(
    x,
    box: Box,
    type=None,
    v=None,
    q=None,
    image=None,
    mass=None,
    molecule=None,
    dtype=torch.float32,
    device="cuda",
) -> System:
    """Build a System from array-likes (numpy or tensors) on ``device``:
    the card unless the caller asks for the CPU."""

    def real(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(device, dtype)

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(device)

    x = real(x)
    n = x.shape[0]
    type = (torch.zeros((n,), dtype=torch.int32, device=device)
            if type is None else ints(type))
    ntypes = int(type.max()) + 1 if n else 1
    v = torch.zeros_like(x) if v is None else real(v)
    q = torch.zeros((n,), dtype=dtype, device=device) if q is None else real(q)
    image = (torch.zeros((n, 3), dtype=torch.int32, device=device)
             if image is None else ints(image))
    mass = (torch.ones((ntypes,), dtype=dtype, device=device)
            if mass is None else real(mass))
    molecule = (torch.zeros((n,), dtype=torch.int32, device=device)
                if molecule is None else ints(molecule))
    return System(x=x, v=v, q=q, type=type, image=image, box=box, mass=mass,
                  molecule=molecule)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static bonded topology (host numpy).

    bonds/angles/dihedrals/impropers: (M, 1+k) int arrays [type, atoms...],
    all 0-based.  The special-bond partner table tags pairs for the pair
    kernel:
      special_idx:  (N, S) int32 partner indices, padded with -1.
      special_code: (N, S) int8 in {1: 1-2, 2: 1-3, 3: 1-4}.
    """

    bonds: np.ndarray
    angles: np.ndarray
    dihedrals: np.ndarray
    impropers: np.ndarray
    special_idx: np.ndarray
    special_code: np.ndarray

    @property
    def has_special(self) -> bool:
        return self.special_idx.shape[1] > 0


def _empty(k: int) -> np.ndarray:
    return np.zeros((0, k), dtype=np.int32)


def build_topology(n_atoms: int, bonds=None, angles=None, dihedrals=None,
                   impropers=None) -> Topology:
    """Derive the 1-2/1-3/1-4 special-bond partner lists from the bond
    graph (LAMMPS ``Special`` semantics): 1-2 partners are bonded
    neighbours, 1-3 neighbours of neighbours not already 1-2 or self, 1-4
    three hops out and not already closer.  Partners of one atom are
    listed 1-2 first, then 1-3, then 1-4, each sorted by index."""

    def arr(a, k):
        return _empty(k) if a is None else np.asarray(a, np.int32)

    bonds, angles = arr(bonds, 3), arr(angles, 4)
    dihedrals, impropers = arr(dihedrals, 5), arr(impropers, 5)

    one2 = [set() for _ in range(n_atoms)]
    for _, i, j in bonds:
        one2[i].add(int(j))
        one2[j].add(int(i))
    groups = []
    for i in range(n_atoms):
        s2 = one2[i]
        s3 = set().union(*(one2[j] for j in s2)) - s2 - {i}
        s4 = set().union(*(one2[j] for j in s3)) - s2 - s3 - {i}
        groups.append((s2, s3, s4))

    smax = max([len(a) + len(b) + len(c) for a, b, c in groups] + [0])
    special_idx = np.full((n_atoms, smax), -1, dtype=np.int32)
    special_code = np.zeros((n_atoms, smax), dtype=np.int8)
    for i, group in enumerate(groups):
        col = 0
        for code, members in enumerate(group, start=1):
            for j in sorted(members):
                special_idx[i, col] = j
                special_code[i, col] = code
                col += 1
    return Topology(bonds=bonds, angles=angles, dihedrals=dihedrals,
                    impropers=impropers, special_idx=special_idx,
                    special_code=special_code)


def empty_topology(n_atoms: int) -> Topology:
    return Topology(
        bonds=_empty(3), angles=_empty(4), dihedrals=_empty(5),
        impropers=_empty(5),
        special_idx=np.full((n_atoms, 0), -1, np.int32),
        special_code=np.zeros((n_atoms, 0), np.int8))
