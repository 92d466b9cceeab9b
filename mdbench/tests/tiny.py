"""A cell small enough for the CPU: one copy of the silica crystal
(1,440 atoms) with the deck's lines at cut 5 A and skin 0.5 A, so that
the cell engine keeps three cells an axis; the program runs its plain
torch versions of the kernels."""
import os

import yaml

from mdbench.harness import spec


def cell(tmp, dump: bool = False, engine: str = "cellpair"):
    """(config, traffic, limits) of the tiny cell, its deck in ``tmp``, on
    the cell engine or (``engine="nlist"``) the neighbor-list engine."""
    with open(os.path.join(spec.HERE, "configs",
                           "cristobalite_pppm.yaml")) as f:
        deck = yaml.safe_load(f)
    deck["pair_style"]["cut"] = 5.0
    deck["neighbor"]["skin"] = 0.5
    deck["engine"] = engine
    deck["read_data"] = os.path.join(spec.HERE, "configs", "data.cristobalite")
    path = os.path.join(str(tmp), "deck.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(deck, f)
    cfg = dict(spec.config("cristobalite_pppm"), deck=path)
    if dump:
        tr = dict(spec.traffic("x656.thermo50.dump250"), replicate=[1, 1, 1],
                  thermo=5)
        tr["dump"] = dict(tr["dump"], every=10)
    else:
        tr = dict(spec.traffic("x656.thermo50"), replicate=[1, 1, 1],
                  thermo=5, warmup_intervals=1)
    return cfg, tr, spec.limits("cristobalite_pppm")
