"""One run of one benchmark cell of lammps_buck_intel_tpu_torch.

    python3 mdbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the program.  The cell's
configuration and traffic are found by the names in BENCHMARK.json.
Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted`` (thermo intervals or dump cycles in the
window), ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced, the
``breakdown``, then ``checks``.  Exits non-zero with no result when the
card is missing or when jax, jaxlib, flax or the JAX package is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

FORBIDDEN = ("jax", "jaxlib", "flax", "lammps_buck_intel_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metrics(run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        path = os.path.join(HERE, "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(
            f"mdbench_metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from mdbench.harness import cell, spec

    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"mdbench: the cell needs {w['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    run = cell.run(spec.config(w["config"]), spec.traffic(w["traffic"]),
                   args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START, spec.limits(w["config"]))
    section = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(run, spec.metrics_of(bench, w["name"], section))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(w["chips"]),
              "memory_peak_bytes": int(run.memory_peak)}
    line = {"correct": bool(run.correct), "attempted": run.intervals,
            "failed": 0, "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        line["breakdown"] = run.trace["breakdown"]
    line["checks"] = run.checks
    found = forbidden_modules()
    if found:
        print(f"mdbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(f"# card: {power_limit()}; peaks 67 TFLOP/s f32, 3.35 TB/s; "
          f"the check took {run.check_s:.1f} s", file=sys.stderr)
    for k, c in run.checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
