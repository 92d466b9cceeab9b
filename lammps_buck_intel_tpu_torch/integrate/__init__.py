from .verlet import NeighborPolicy
from .cellpair_verlet import CellPairSimulation, CellOverflowError
