#!/usr/bin/env python3
"""Time K1 (the cell-pair kernel, ``cellpair.compute_cellpair``,
force-only, f32) on the card at two decks' widths, from the decks' initial
states: cristobalite_coul_cut.yaml on the cell engine's grid
(buck/coul/cut 10 A, examples/data.cristobalite x 4x4x4, 92,160 atoms)
and cristobalite_pppm.yaml (buck/coul/long 10 A, x [6, 5, 6], 259,200
atoms).

    python tools/time_k1_cut.py [--root TREE] [--reps 30]

--root: the checkout whose ``lammps_buck_intel_tpu_torch`` is imported
(default: the one holding this script), so that two versions are timed
in one call on one card.  Prints one JSON line: the card's name and power
limit (nvidia-smi), the tree, and for each deck the median and least ms
of a call (CUDA events, after two warm-up calls that build the kernel)
and sum |f|.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = ("cristobalite_coul_cut.yaml", "cristobalite_pppm.yaml")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import yaml

    from lammps_buck_intel_tpu_torch.models.pair.cellpair import (
        compute_cellpair)
    from lammps_buck_intel_tpu_torch.run import build_simulation

    out = {}
    for name in DECKS:
        with open(os.path.join(HERE, "examples", "decks", name)) as f:
            cfg = yaml.safe_load(f)
        cfg["read_data"] = os.path.join(HERE, cfg["read_data"])
        cfg = dict(cfg, engine="cellpair", precision="single")
        sim = build_simulation(cfg, device="cuda")

        def call():
            return compute_cellpair(sim.pair, sim.grid, sim.box, sim.state,
                                    acc_dtype=torch.float32)

        for _ in range(2):
            r = call()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = dict(
            atoms=sim.grid.n_atoms, ms_median=float(np.median(times)),
            ms_min=float(min(times)),
            sum_abs_f=float(sum(p.double().abs().sum()
                                for p in (r.fx, r.fy, r.fz))))
        del sim, r
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(
        card=smi.strip().splitlines()[0] if smi.strip() else None,
        tree=root, reps=args.reps, decks=out)))


if __name__ == "__main__":
    main()
