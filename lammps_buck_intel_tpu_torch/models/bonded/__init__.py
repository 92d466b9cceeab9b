from .harmonic import (BONDED_KINDS, BondedResult, BondedStyle,
                       compute_bonded, compute_bonded_peratom,
                       compute_bonded_peratom_plain, compute_bonded_plain,
                       make_bonded)
from .charmm import (bake_charmm_14, dihedral_charmm_forces,
                     improper_harmonic_forces)
