#!/usr/bin/env python3
"""Time the per-atom PPPM on the card: ``pppm.compute_peratom`` (the K5
deposit in atom order, one rfftn, the K10pa spectral kernel, the batched
irfftn of the seven spectra, the K10pa gather) at
cristobalite_pppm_dump.yaml's widths in f32: examples/data.cristobalite
x [6, 5, 6] (259,200 atoms), PPPM 1e-4 order 7 on the deck's cell-aligned
105x112x77 mesh (pinned with ``setup_pppm(grid=...)``).

    python tools/time_peratom_pppm.py [--root TREE] [--reps 30]

--root: the checkout whose ``lammps_buck_intel_tpu_torch`` is imported
(default: the one holding this script), so that two versions are timed
in one call on one card.  Prints one JSON line: the card's name and power
limit (nvidia-smi), the tree, the median and least ms of a call (CUDA
events, after two warm-up calls that build the kernels) and sum eatom.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (105, 112, 77)


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

    from lammps_buck_intel_tpu_torch.core import get_units, make_box
    from lammps_buck_intel_tpu_torch.models.kspace import pppm
    from lammps_buck_intel_tpu_torch.run import _geometry

    with open(os.path.join(HERE, "examples", "decks",
                           "cristobalite_pppm_dump.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["read_data"] = os.path.join(HERE, cfg["read_data"])
    g = _geometry(cfg)
    box = make_box(g["lo"], g["hi"])
    ks = cfg["kspace_style"]
    pm = pppm.setup_pppm(box, g["q"], cutoff=cfg["pair_style"]["cut"],
                         accuracy_rel=ks["accuracy"],
                         qqrd2e=get_units(cfg["units"]).qqrd2e,
                         order=ks["order"], grid=GRID)
    dev = torch.device("cuda")
    x = torch.as_tensor(np.ascontiguousarray(g["x"].T), dtype=torch.float32,
                        device=dev)
    q = torch.as_tensor(g["q"], dtype=torch.float32, device=dev)

    def call():
        return pppm.compute_peratom(pm, x, q)

    for _ in range(2):
        e, _v = call()
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(
        card=smi.strip().splitlines()[0] if smi.strip() else None,
        tree=root, atoms=int(x.shape[1]), mesh=list(pm.grid),
        order=pm.order, ms_median=float(np.median(times)),
        ms_min=float(min(times)), reps=args.reps,
        sum_eatom=float(e.double().sum()))))


if __name__ == "__main__":
    main()
