"""Per-atom simulation state as torch tensors on one device.

Counterpart of ``lammps_buck_intel_tpu.core.state`` (``System``,
``make_system``).  Bonded topology is ROADMAP queue 1 item 12.
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
