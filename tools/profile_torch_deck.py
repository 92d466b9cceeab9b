"""Where a deck's step time goes on the card: the port under torch.profiler.

    python tools/profile_torch_deck.py examples/decks/cristobalite_pppm.yaml \
        [--steps 40] [--warmup 20] [--replicate 6 6 4] [--out profile.json]

Runs the deck's main path on the CUDA card (no thermo inside the window,
so every step is a force-only step as most steps of a run are), first
untraced for the step time, then the same number of steps with the
program's tracer on (``utils/trace.py``) under ``torch.profiler``, opened
by the spin lead of ``mdbench/harness/trace.py``.  Device time is summed
by kernel and grouped by the program span that launched it
(``mdbench/harness/spans.py``): pair, kspace, bonded, neighbor (rebins
and list builds), integrate (kicks, drift, thermostat chain, SHAKE,
RATTLE, rigid bodies), block and segment (what they launch outside those),
and unattributed; ``breakdown_spans`` has the device and the idle ms a
step by span path.  The device idle share is 1 - (busy time / traced
window); launches per step are the device events of each span over the
steps.  With them the least time the card could take for the NVE update
of one step: it reads x, v, f and writes x, v, 9 planes of nslots floats
(atoms on the neighbor-list engines), at 3.35 TB/s.  Prints one JSON
object with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import yaml  # noqa: E402

from lammps_buck_intel_tpu_torch.run import build_simulation  # noqa: E402
from lammps_buck_intel_tpu_torch.utils import trace  # noqa: E402
from mdbench.harness import spans  # noqa: E402
from mdbench.harness.trace import Slice  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("deck")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--replicate", type=int, nargs=3, default=None,
                    help="override the deck's replicate")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_deck: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    with open(args.deck) as f:
        cfg = yaml.safe_load(f)
    if "read_data" in cfg:
        cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    if args.replicate:
        cfg["replicate"] = list(args.replicate)
    sim = build_simulation(cfg, device="cuda")
    sim.run(args.warmup, thermo_every=0, log=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(args.steps, thermo_every=0, log=False)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    trace.enable()
    sl = Slice()
    sl.start()
    t0 = time.perf_counter()
    sim.run(args.steps, thermo_every=0, log=False)
    torch.cuda.synchronize()
    traced_ms = 1e3 * (time.perf_counter() - t0)
    sl.stop()
    trace.disable()
    with tempfile.TemporaryDirectory() as tmp:
        evs = spans.events_from_profile(sl.prof, os.path.join(tmp, "t.json"))
    try:
        t_lead = spans.lead_end(evs)
    except KeyError:
        raise SystemExit("profile_torch_deck: the trace holds no device "
                         "time; time with CUDA events instead")
    red = spans.reduce(evs, t_lead, args.steps)
    kernels, by_layer, launches = {}, {}, {}
    for e in evs:
        if e.kind == "device" and e.t0 >= t_lead:
            ms = (e.t1 - e.t0) / 1e3 / args.steps
            kernels[e.name] = kernels.get(e.name, 0.0) + ms
    for path, sec in red["device_s"].items():
        name = path.rsplit("/", 1)[-1]
        by_layer[name] = by_layer.get(name, 0.0) + 1e3 * sec / args.steps
        launches[name] = launches.get(name, 0) + red["device_n"][path]
    busy = 1e3 * red["busy_s"] / args.steps
    traced_step = traced_ms / args.steps
    # the cell engine's slot planes, or the list engines' atom planes
    nslots = sim.grid.nslots if hasattr(sim, "grid") else sim.n_atoms
    nve_bytes = 9 * nslots * sim.state.x.element_size()
    out = {
        "deck": os.path.basename(args.deck), "card": smi,
        "n_atoms": sim.n_atoms, "steps": args.steps,
        "step_ms": step_ms, "traced_step_ms": traced_step,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / traced_step,
        "layers_ms_per_step": dict(sorted(by_layer.items(),
                                          key=lambda kv: -kv[1])),
        "launches_per_step": {k: v / args.steps
                              for k, v in sorted(launches.items())},
        "nslots": nslots,
        "nve_update_bound_ms": 1e3 * nve_bytes / 3.35e12,
        "top_kernels_ms_per_step": dict(sorted(
            kernels.items(), key=lambda kv: -kv[1])[:12]),
        "breakdown_spans": spans.breakdown(red),
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
