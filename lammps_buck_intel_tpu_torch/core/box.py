"""Orthogonal periodic simulation box.

Counterpart of ``lammps_buck_intel_tpu.core.box`` for orthogonal boxes.
A fixed box stays on the host (``Box``): its constants are passed to the
kernels as scalars.  The variable cell of ``fix npt`` lives on the card
instead, as a (3,) tensor of lengths about a fixed centre, so that no
step reads it back: ``traced_lo``, ``wrap`` and ``minimum_image_planes``
take it as a tensor (the JAX package's traced ``axis_lengths`` path).
Triclinic (tilted) boxes are ROADMAP queue 1 item 14.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Box(NamedTuple):
    """lo, hi: (3,) box bounds; periodic: (3,) bool; tilt: always None."""

    lo: np.ndarray
    hi: np.ndarray
    periodic: np.ndarray
    tilt: np.ndarray = None

    @property
    def lengths(self) -> np.ndarray:
        return self.hi - self.lo

    @property
    def volume(self) -> float:
        L = self.lengths
        return float(L[0] * L[1] * L[2])

    @property
    def is_triclinic(self) -> bool:
        return False

    @property
    def h_matrix(self) -> np.ndarray:
        """(3,3) cell matrix: x = lo + h @ lamda."""
        lx, ly, lz = (float(v) for v in self.lengths)
        return np.array([[lx, 0.0, 0.0], [0.0, ly, 0.0], [0.0, 0.0, lz]])

    @property
    def h_inv(self) -> np.ndarray:
        """(3,3) inverse cell matrix, the JAX package's closed form with
        zero tilts (so the Ewald k set is the same to the bit)."""
        lx, ly, lz = (float(v) for v in self.lengths)
        xy = xz = yz = 0.0
        return np.array([
            [1.0 / lx, -xy / (lx * ly), (xy * yz - ly * xz) / (lx * ly * lz)],
            [0.0, 1.0 / ly, -yz / (ly * lz)],
            [0.0, 0.0, 1.0 / lz],
        ])

    @property
    def perp_widths(self) -> np.ndarray:
        """(3,) distances between opposite faces, by the same formula as
        the JAX package so both size their cell grids identically."""
        h = self.h_matrix
        a, b, c = h[:, 0], h[:, 1], h[:, 2]
        V = abs(float(np.linalg.det(h)))
        return np.array([
            V / np.linalg.norm(np.cross(b, c)),
            V / np.linalg.norm(np.cross(c, a)),
            V / np.linalg.norm(np.cross(a, b)),
        ])


def make_box(lo, hi, periodic=(True, True, True), dtype=None,
             tilt=None) -> Box:
    if tilt is not None and np.any(np.asarray(tilt, np.float64) != 0.0):
        raise NotImplementedError(
            "triclinic boxes are not ported: ROADMAP queue 1 item 14")
    dt = np.float64 if dtype is None else np.dtype(dtype)
    return Box(
        lo=np.asarray(lo, dtype=dt),
        hi=np.asarray(hi, dtype=dt),
        periodic=np.asarray(periodic, dtype=bool),
    )


# ---------- the variable cell: box lengths as a tensor on the card ----------

def traced_lo(center, boxL: torch.Tensor) -> torch.Tensor:
    """(3,) lower corner centre - L / 2 of a cell about a fixed centre, in
    boxL's dtype (the centre rounded to it first, as the JAX package's
    NPT runner rounds it).  center: host floats, or a (3,) tensor already
    on boxL's device (no host-to-device copy, which would wait for the
    stream)."""
    if not isinstance(center, torch.Tensor):
        center = torch.as_tensor(np.asarray(center, np.float64))
    return center.to(boxL) - 0.5 * boxL


def wrap(x: torch.Tensor, image: torch.Tensor, lo: torch.Tensor,
         boxL: torch.Tensor):
    """Wrap (3, N) position planes into the cell and count the crossings in
    the (3, N) int32 image flags: n = floor((x - lo) / L), x - n L, image +
    n (LAMMPS Domain::pbc; the JAX package's ``wrap``).  Returns new
    tensors."""
    L = boxL.to(x.dtype)[:, None]
    n = torch.floor((x - lo.to(x.dtype)[:, None]) / L)
    return x - n * L, image + n.to(image.dtype)


def minimum_image_planes(dx, dy, dz, L):
    """Component-plane minimum image d - round(d * (1 / L)) L per axis
    (round half to even).  L: host floats, or a (3,) tensor on the planes'
    device (the variable cell), whose reciprocal is taken in its dtype."""
    if isinstance(L, torch.Tensor):
        Lt = L.to(dx.dtype)
        inv = 1.0 / Lt
        return tuple(d - torch.round(d * inv[a]) * Lt[a]
                     for a, d in enumerate((dx, dy, dz)))
    return tuple(d - torch.round(d * (1.0 / float(La))) * float(La)
                 for d, La in zip((dx, dy, dz), L))
