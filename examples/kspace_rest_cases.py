"""The shrunk decks of the rest of the Coulomb k-space (pppm diff ad,
kspace_modify slab, Ewald on the cell engine and under fix npt), shared by
tools/record_kspace_rest.py (the JAX package's f64 record,
tests/goldens/torch_kspace_rest.json), tests/test_torch_ewald_npt.py and
tests/test_torch_pppm_ad.py (the port on the CPU) and chip_smoke.py (the
port on the card).

Each case is one of the six decks cut to a size a CPU runs in seconds: a
single copy of its data file (jittered by up to 0.1 A where the crystal is
ideal, so that the forces are not zero by symmetry), a smaller pair
cutoff and skin where the cell engine needs 3 cells an axis, and for the
Ewald decks a looser accuracy (fewer k vectors); every other line is the
deck's.  ``deck_cfg(name, tmp)`` builds the case's config, writing its
data file into the directory ``tmp``.
"""
from __future__ import annotations

import copy
import os

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = os.path.join(ROOT, "examples", "decks")
JITTER = 0.1

# name -> (deck, data file (None: the deck's own), overrides, steps, every)
# data: (nx, ny, nz, vacuum) cells of gen_cristobalite, jittered by JITTER
_SMALL_CUT = {"pair_style": {"cut": 5.0}, "neighbor": {"skin": 0.5}}
CASES = {
    "pppm_ad_cell": ("cristobalite_pppm_ad.yaml", (4, 5, 3, 0.0),
                     _SMALL_CUT, 10, 5),
    "pppm_ad_nlist": ("cristobalite_pppm_ad_nlist.yaml", (4, 5, 3, 0.0),
                      _SMALL_CUT, 10, 5),
    "slab": ("cristobalite_slab.yaml", (4, 5, 3, 1.0), _SMALL_CUT, 10, 5),
    "ewald_cell": ("cristobalite_ewald_cell.yaml", (4, 5, 3, 0.0),
                   dict(_SMALL_CUT, kspace_style={"accuracy": 1e-4}), 6, 3),
    "ewald_npt": ("cristobalite_ewald_npt.yaml", (4, 5, 3, 0.0),
                  dict(_SMALL_CUT, kspace_style={"accuracy": 1e-4}), 6, 3),
    "rhodo_npt_ad": ("rhodo_npt_ad.yaml", None, {}, 20, 5),
}


def load_deck(name: str) -> dict:
    with open(os.path.join(DECKS, name)) as f:
        return yaml.safe_load(f)


def data_file(dims, tmp: str) -> str:
    """The jittered (vacuum: slab) cristobalite block of ``dims`` = (nx,
    ny, nz, vacuum) cells, written into ``tmp``."""
    import gen_cristobalite

    nx, ny, nz, vac = dims
    path = os.path.join(tmp, f"data.cristobalite_{nx}x{ny}x{nz}_{vac}")
    if not os.path.exists(path):
        gen_cristobalite.write(path, nx, ny, nz, jitter_amp=JITTER,
                               vacuum=vac)
    return path


def deck_cfg(name: str, tmp: str, precision: str = "double") -> dict:
    """The config of case ``name``: its deck at one copy in ``precision``
    with the case's overrides, reading its data file (written into
    ``tmp``, or the deck's own file resolved against the repository)."""
    deck, dims, over, _, _ = CASES[name]
    cfg = load_deck(deck)
    cfg["read_data"] = (data_file(dims, tmp) if dims is not None
                        else os.path.join(ROOT, cfg["read_data"]))
    cfg.update(replicate=[1, 1, 1], precision=precision)
    for key, val in copy.deepcopy(over).items():
        cfg[key].update(val)
    return cfg
