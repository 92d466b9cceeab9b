from . import lattice, velocity
