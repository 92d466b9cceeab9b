"""Unit systems (LAMMPS-compatible constant sets).

Counterpart of ``lammps_buck_intel_tpu.core.units``: the same three
systems (``lj``, ``metal``, ``real``) with the same constants, so both
packages derive identical timesteps, forces and thermo conversions.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Units:
    """Derived constants for one unit system.

    Attributes:
      boltz:   Boltzmann constant (energy/temperature).
      hplanck: Planck's constant.
      mvv2e:   mass * velocity^2 -> energy conversion.
      ftm2v:   force/mass * time -> velocity conversion.
      mv2d:    mass/volume -> density conversion.
      nktv2p:  N k_B T / volume -> pressure conversion.
      qqr2e:   q_i q_j / r -> energy conversion (Coulomb constant).
      qe2f:    charge * electric field -> force conversion.
      dt:      default timestep.
      skin:    default neighbor skin distance.
    """

    name: str
    boltz: float
    hplanck: float
    mvv2e: float
    ftm2v: float
    mv2d: float
    nktv2p: float
    qqr2e: float
    qe2f: float
    dt: float
    skin: float

    @property
    def qqrd2e(self) -> float:
        """qqr2e / dielectric (dielectric == 1 everywhere in the decks)."""
        return self.qqr2e


LJ = Units(
    name="lj",
    boltz=1.0,
    hplanck=1.0,
    mvv2e=1.0,
    ftm2v=1.0,
    mv2d=1.0,
    nktv2p=1.0,
    qqr2e=1.0,
    qe2f=1.0,
    dt=0.005,
    skin=0.3,
)

# "real": mass=g/mol, dist=Angstrom, time=fs, energy=kcal/mol, charge=e.
_REAL_FTM2V = 1.0 / 48.88821291 / 48.88821291
REAL = Units(
    name="real",
    boltz=0.0019872067,
    hplanck=95.306976368,
    mvv2e=48.88821291 * 48.88821291,
    ftm2v=_REAL_FTM2V,
    mv2d=1.0 / 0.602214129,
    nktv2p=68568.415,
    qqr2e=332.06371,
    qe2f=23.060549,
    dt=1.0,
    skin=2.0,
)

# "metal": mass=g/mol, dist=Angstrom, time=ps, energy=eV, charge=e.
METAL = Units(
    name="metal",
    boltz=8.617343e-5,
    hplanck=4.135667403e-3,
    mvv2e=1.0364269e-4,
    ftm2v=1.0 / 1.0364269e-4,
    mv2d=1.0 / 0.602214129,
    nktv2p=1.6021765e6,
    qqr2e=14.399645,
    qe2f=1.0,
    dt=0.001,
    skin=2.0,
)

_BY_NAME = {"lj": LJ, "real": REAL, "metal": METAL}


def get_units(name: str) -> Units:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"unknown unit system {name!r}; supported: {sorted(_BY_NAME)}"
        ) from None
