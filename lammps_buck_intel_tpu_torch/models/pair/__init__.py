from .styles import (PairConfig, PairStyle, COEF_NAMES, build_buck, build_lj,
                     build_lj_charmm, erfc_approx, pair_terms)
from .cellpair import (SpecialTable, compute_cellpair, compute_cellpair_plain,
                       make_special_table)
