#!/usr/bin/env python3
"""Hold K1 (the cell-pair kernel) to its plain version on
cristobalite_coul_cut.yaml's cell grid (buck/coul/cut 10 A, 92,160 atoms,
f32) over many jittered states: each seed displaces every slot by
uniform(-0.1, 0.1) A per axis, as chip_smoke.py's phase does, and rebins.
A pair within an ulp of the strict Coulomb cutoff shows as a force step
of qqrd2e qi qj / rc^2 when the kernel and the plain version round rsq
differently.

    python tools/k1_cut_seeds.py [--root TREE] [--seeds 30]

--root: the checkout whose ``lammps_buck_intel_tpu_torch`` is imported
(default: the one holding this script).  Prints a line a seed (max |df| /
max |f| and the pairs within 2 ulp of rc^2, each once) and, last, one JSON
line: the card (nvidia-smi), the tree, the seeds over 1e-4 and the
largest error.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seeds", type=int, default=30)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import yaml

    from lammps_buck_intel_tpu_torch.models.pair.cellpair import (
        _chunk_cells, candidate_mask, compute_cellpair, compute_cellpair_plain,
        half_offsets, half_stencil_tables)
    from lammps_buck_intel_tpu_torch.neighbor import cell_slots as cs
    from lammps_buck_intel_tpu_torch.run import build_simulation

    with open(os.path.join(HERE, "examples", "decks",
                           "cristobalite_coul_cut.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["read_data"] = os.path.join(HERE, cfg["read_data"])
    sim = build_simulation(dict(cfg, engine="cellpair", precision="single"),
                           device="cuda")
    grid, box, style = sim.grid, sim.box, sim.pair
    base = [p.clone() for p in (sim.state.x, sim.state.y, sim.state.z)]
    c = torch.tensor(style.cutsq_max, dtype=torch.float32)
    ulp = float(torch.nextafter(c, torch.tensor(1e9)) - c)

    def near_cut(st):
        ncell, cap, n = grid.ncell, grid.cap, grid.n_atoms
        offs = half_offsets(grid.reach_z)
        K = offs.shape[0]
        nbr, _, shifts = half_stencil_tables(grid.nc, offs)
        nbr_t = torch.as_tensor(nbr, dtype=torch.long, device=st.x.device)
        shift_t = torch.as_tensor(shifts * np.asarray(box.lengths),
                                  device=st.x.device).to(st.x.dtype)
        pos = [p.view(ncell, cap) for p in (st.x, st.y, st.z)]
        aid = st.aid.view(ncell, cap)
        own = candidate_mask(cap, K, st.x.device)
        total = 0
        chunk = _chunk_cells(cap, K, ncell)
        for c0 in range(0, ncell, chunk):
            c1 = min(ncell, c0 + chunk)
            js = nbr_t[c0:c1]
            d = [pos[a][c0:c1, :, None] - (
                pos[a][js] + shift_t[c0:c1, :, a, None]).reshape(
                    c1 - c0, 1, K * cap) for a in range(3)]
            rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            ai = aid[c0:c1, :, None]
            aj = aid[js].reshape(c1 - c0, 1, K * cap)
            total += int(((ai < n) & (aj < n) & own
                          & ((rsq - float(c)).abs() <= 2 * ulp)).sum())
        return total

    errs = []
    for seed in range(args.seeds):
        for p, b in zip((sim.state.x, sim.state.y, sim.state.z), base):
            p.copy_(b)
        rng = np.random.default_rng(seed)
        for p in (sim.state.x, sim.state.y, sim.state.z):
            p += torch.as_tensor(rng.uniform(-0.1, 0.1, p.shape[0])).to(p)
        st = cs.rebin(grid, box, sim.state)
        k = compute_cellpair(style, grid, box, st, acc_dtype=torch.float32)
        p = compute_cellpair_plain(style, grid, box, st,
                                   acc_dtype=torch.float32)
        fk = torch.stack([k.fx, k.fy, k.fz])
        fp = torch.stack([p.fx, p.fy, p.fz])
        errs.append(float((fk - fp).abs().max()) / float(fp.abs().max()))
        print(f"seed {seed}: max|df|/max|f| {errs[-1]:.3e}, pairs "
              f"within 2 ulp of rc^2 {near_cut(st)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(
        card=smi.strip().splitlines()[0] if smi.strip() else None,
        tree=root, atoms=grid.n_atoms, seeds=args.seeds,
        over_tol=sum(e > 1e-4 for e in errs), max_rel=max(errs))))


if __name__ == "__main__":
    main()
