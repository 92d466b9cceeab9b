"""The correctness check's control: the plain reference computed in
bfloat16 (the precision below the decks' f32) in the program's place.

    python3 mdbench/control.py --workload <cell> --seeds 11 12 13 \
        [--steps 100] [--dtype bfloat16|float32]

For each seed the program builds the cell's deck and runs ``--steps``
steps (a short window at the cell's own size) to give a realistic state;
then every number the benchmark compares is read with the reference in
``--dtype`` standing where the program's outputs stand, against the same
reference in f64.  Each number's smallest reading over the seeds is the
upper reading its limit must stay under.  Prints one JSON line per seed
and, last, the readings' minima.  The benchmark's own runs never run it.
"""
import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def readings(cfg: dict, tr: dict, seed: int, steps: int, device: str,
             dtype) -> dict:
    import torch

    from lammps_buck_intel_tpu_torch.run import build_simulation
    from mdbench.harness import cell, checks, spec

    deck = spec.deck(cfg, tr, seed)
    deck.pop("dump", None)
    sim = build_simulation(dict(deck), device=device)
    sim.run(steps, thermo_every=0, log=False)
    end = cell._atoms(sim)
    del sim
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if tr.get("dump"):
        deck["dump"] = tr["dump"]
    return checks.control(deck, seed, end, device, dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    import torch

    from mdbench.harness import spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    w = spec.workload(spec.benchmark(), args.workload)
    cfg, tr = spec.config(w["config"]), spec.traffic(w["traffic"])
    low = {}
    for seed in args.seeds:
        r = readings(cfg, tr, seed, args.steps, "cuda",
                     getattr(torch, args.dtype))
        print(json.dumps({"seed": seed, "readings": r}), flush=True)
        for k, v in r.items():
            low[k] = min(low.get(k, v), v)
    print(json.dumps({"workload": args.workload, "dtype": args.dtype,
                      "min_over_seeds": low}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
