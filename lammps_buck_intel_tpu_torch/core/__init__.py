from .units import Units, get_units, LJ, REAL, METAL
from .precision import Precision, get_precision, single, mixed, double
from .box import Box, make_box
from .state import (System, Topology, build_topology, empty_topology,
                    make_system)
