from .base import BoundKSpace, CombinedKSpace
from .ewald import Ewald, setup_ewald
from .pppm import PPPM, pppm_g_ewald, setup_pppm
from .pppm_cells import CellPPPM, CellPPPMDisp
from .pppm_disp import PPPMDisp, setup_pppm_disp, solve_g6
