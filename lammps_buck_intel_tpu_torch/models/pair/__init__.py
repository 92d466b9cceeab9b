from .styles import (PairConfig, PairStyle, COEF_NAMES, build_buck,
                     erfc_approx, pair_terms)
from .cellpair import compute_cellpair, compute_cellpair_plain
