"""Time the port's atomic paths in one source tree, for A/B runs on one card.

    python tools/torch_ab.py [--root DIR] [--reps 50]

Imports ``lammps_buck_intel_tpu_torch`` from DIR (default: this
checkout) and prints one JSON line: the cell-pair kernel's force-only
f32 time at buck_big.yaml's grid (the buck variant) and at
cristobalite_pppm.yaml's (the coul/long variant), each the median of
--reps CUDA-event timed calls, and the ms/step of buck.yaml (100 steps),
buck_big.yaml (200 steps) and cristobalite_pppm.yaml (100 steps) through
run_deck (the second of two runs), with the card's name and power limit.  Run two trees in turns on one card, one after the
other in the same job (A, B, B, A), to compare them.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import yaml

    from lammps_buck_intel_tpu_torch.models.pair.cellpair import (
        compute_cellpair)
    from lammps_buck_intel_tpu_torch.run import build_simulation, run_deck

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: no CUDA card")

    def deck(name, **kw):
        with open(os.path.join(root, "examples", "decks", name)) as f:
            cfg = dict(yaml.safe_load(f), **kw)
        if "read_data" in cfg:
            cfg["read_data"] = os.path.join(root, cfg["read_data"])
        return cfg

    def k1_ms(name):
        sim = build_simulation(deck(name), device="cuda")
        st = sim.state

        def call():
            return compute_cellpair(sim.pair, sim.grid, sim.box, st,
                                    acc_dtype=torch.float32)

        call()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    out = {"root": os.path.relpath(root),
           "k1_buck_big_ms": k1_ms("buck_big.yaml"),
           "k1_cristobalite_ms": k1_ms("cristobalite_pppm.yaml")}
    torch.cuda.empty_cache()
    for name, steps in (("buck.yaml", 100), ("buck_big.yaml", 200),
                        ("cristobalite_pppm.yaml", 100)):
        # the first run of a process pays torch's first launches
        for _ in range(2):
            s, _ = run_deck(deck(name, run=steps, thermo=steps),
                            device="cuda", log=False)
        out[f"{name}_ms_per_step"] = 1e3 * s.timings["run"] / steps
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
