from .verlet import NeighborPolicy
from .cellpair_verlet import CellPairSimulation, CellOverflowError
from .nvt import NVTConfig, NHChain, nhc_half, chain_energy
