from .verlet import NeighborPolicy
from .cellpair_verlet import CellPairSimulation, CellOverflowError
from .nvt import NVTConfig, NHChain, nhc_half, chain_energy
from .npt import (NPTConfig, NPTSimulation, NPTState, baro_chain_half,
                  nh_omega_dot_half, nh_press_vfac)
