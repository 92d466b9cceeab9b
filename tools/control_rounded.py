#!/usr/bin/env python3
"""A second control for a cell's correctness limits: the program's own
outputs rounded to bfloat16, checked as the benchmark checks a run.

    python3 tools/control_rounded.py --workload <cell> --seeds 11 12 13 \
        [--steps 100]

mdbench/control.py computes the plain reference in bfloat16.  On a
molecular deck that reading is not finite: at a 150 A box bfloat16 holds
a coordinate to 0.5-1 A, so bonded atoms fall on one point and their
excluded pair terms read inf times 0.  This control keeps the arithmetic
in the program's f32 and loses the precision at the outputs instead: for
each seed the program builds the cell's deck and runs ``--steps`` steps;
the set-up positions and velocities, the end-of-window velocities and
forces and the last thermo row's energies and temperature are rounded to
bfloat16 (the end positions are kept, so the reference's forces are
those of the program's state), and ``mdbench/harness/checks.compare``
reads them against the f64 reference.  Prints one JSON line per seed
and, last, the readings' minima over the seeds.
"""
import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _bf16(a):
    import torch

    return torch.as_tensor(a).to(torch.bfloat16).double().numpy()


def readings(cfg: dict, tr: dict, seed: int, steps: int,
             device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from lammps_buck_intel_tpu_torch.run import build_simulation
    from mdbench.harness import checks, spec

    deck = spec.deck(cfg, tr, seed)
    deck.pop("dump", None)
    sim = build_simulation(dict(deck), device=device)

    def atoms():
        a = sim.get_atoms()
        return {k: np.asarray(a[k]) for k in ("x", "v", "f", "image")}

    start = atoms()
    row = sim.run(steps, thermo_every=steps, log=False)[-1]
    end = atoms()
    del sim
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    start = dict(start, x=_bf16(start["x"]), v=_bf16(start["v"]))
    end = dict(end, v=_bf16(end["v"]), f=_bf16(end["f"]))
    row = dict(row, **{k: float(_bf16(row[k])) for k in
                       ("epair", "emol", "temp", "press")})
    return checks.compare(deck, seed, start, end, row, None, None, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    import torch

    from lammps_buck_intel_tpu_torch.ops import build
    from mdbench.harness import spec

    if not torch.cuda.is_available():
        print("control_rounded: no CUDA card", file=sys.stderr)
        return 2
    build.load_all()
    w = spec.workload(spec.benchmark(), args.workload)
    cfg, tr = spec.config(w["config"]), spec.traffic(w["traffic"])
    low = {}
    for seed in args.seeds:
        r = readings(cfg, tr, seed, args.steps)
        print(json.dumps({"seed": seed, "readings": r}), flush=True)
        for k, v in r.items():
            low[k] = min(low.get(k, v), v)
    print(json.dumps({"workload": args.workload, "control": "rounded",
                      "min_over_seeds": low}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
