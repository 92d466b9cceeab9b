"""Where a deck's step time goes on the card: the port under torch.profiler.

    python tools/profile_torch_deck.py examples/decks/cristobalite_pppm.yaml \
        [--steps 40] [--warmup 20] [--replicate 6 6 4] [--out profile.json]

Runs the deck's main path on the CUDA card (no thermo inside the window,
so every step is a force-only step as most steps of a run are), first
untraced for the step time, then the same number of steps under
``torch.profiler`` (``utils/device_trace.py``).  Device kernel time is summed by kernel and grouped
into the port's layers: pair (csrc/cellpair.cu, or csrc/nlist.cu's pair
pass on the NPT engine), nlist build (csrc/nlist.cu), npt (csrc/npt.cu:
the traced influence function, the barostat's per-atom passes), pppm
kernels
(csrc/pppm.cu), pppm FFTs (cuFFT under torch.fft), bonded
(csrc/bonded.cu), rebin (csrc/rebin.cu), verlet (csrc/verlet.cu: kicks,
drift, force sum and cast, kinetic sums, the thermostat chain), shake
(csrc/shake.cu: reference bond vectors, SHAKE, RATTLE) and torch
ops (everything else: fills, the slot-of-atom map, partial sums).  The
device idle share is 1 - (kernel time / traced wall time); launches per
step are the device events of each layer over the steps.  With them the
least time the card could take for the NVE update of one step: it reads
x, v, f and writes x, v, 9 planes of nslots floats (atoms on the NPT
engine), at 3.35 TB/s.  Prints
one JSON object with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import yaml  # noqa: E402

from lammps_buck_intel_tpu_torch.run import build_simulation  # noqa: E402
from lammps_buck_intel_tpu_torch.utils import device_trace  # noqa: E402

# kernel name fragments -> layer (first match wins)
LAYERS = (
    ("pair", ("cellpair_kernel", "nlist_pair_kernel")),
    ("nlist build", ("nlist_bin_kernel", "nlist_sort_kernel",
                     "nlist_build_kernel")),
    ("npt", ("traced_greens_kernel", "npt_ke3_kernel",
             "npt_vscale_kick_kernel", "npt_drift_dilate_kernel")),
    ("pppm kernels", ("pppm_deposit_kernel", "pppm_spectral_kernel",
                      "pppm_gather_kernel")),
    ("pppm fft", ("fft",)),
    ("bonded", ("bond_angle_kernel", "dihedral_charmm_kernel",
                "improper_harmonic_kernel")),
    ("shake", ("shake_ref_kernel", "shake_positions_kernel", "rattle_kernel",
               "shake_virial_kernel")),
    ("verlet", ("kick_drift_kernel", "kick_ke_kernel", "nhc_scale_kernel")),
    ("rebin", ("mark_kernel", "gather_kernel", "free_kernel", "place_kernel",
               "stash_kernel", "fill_kernel", "scatter_kernel")),
)


def layer_of(name: str) -> str:
    for layer, keys in LAYERS:
        if any(k in name for k in keys):
            return layer
    return "torch ops"


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

    def window():
        nonlocal traced_ms
        t0 = time.perf_counter()
        sim.run(args.steps, thermo_every=0, log=False)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)

    traced_ms = 0.0
    kernels, by_layer, launches = {}, {}, {}
    for e in device_trace.device_events(window):
        ms = e.time_range.elapsed_us() / 1e3 / args.steps
        kernels[e.name] = kernels.get(e.name, 0.0) + ms
        layer = layer_of(e.name)
        launches[layer] = launches.get(layer, 0) + 1
    if not kernels:
        raise SystemExit("profile_torch_deck: the trace holds no device "
                         "time; time with CUDA events instead")
    for k, v in kernels.items():
        by_layer[layer_of(k)] = by_layer.get(layer_of(k), 0.0) + v
    busy = sum(kernels.values())
    traced_step = traced_ms / args.steps
    # the cell engine's slot planes, or the NPT engine's atom planes
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
