"""The benchmark's files, found by the names in ``BENCHMARK.json``.

- ``configs/<config>.json``: the deck (a frozen YAML copy under
  ``configs/``), its source, what was changed from it and what was assumed;
- ``traffic/<traffic>.json``: the run's parameters (``replicate``, the
  ``thermo`` cadence, ``warmup_intervals``, ``trace_intervals``, an
  optional ``dump`` block);
- ``limits/<config>.json``: the limit of each number the correctness
  check compares, with the readings it was set from;
- ``metrics/<metric>.py`` and ``layers/<layer>/*.txt`` (``harness.layers``).
"""
from __future__ import annotations

import copy
import json
import os

import yaml

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"mdbench: no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` (end_to_end or per_layer) that the cell
    reports: those without a workloads list, or that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(name: str) -> dict:
    return _json("limits", f"{name}.json")


def deck(cfg: dict, tr: dict, seed: int, tmpdir: str = "") -> dict:
    """The deck as this run drives it: the frozen copy with the traffic's
    replication and thermo cadence, the velocity seed, and the dump block
    (its file in ``tmpdir``)."""
    with open(os.path.join(ROOT, cfg["deck"])) as f:
        d = yaml.safe_load(f)
    d = copy.deepcopy(d)
    d["read_data"] = os.path.join(ROOT, d["read_data"])
    d["replicate"] = list(tr["replicate"])
    d["thermo"] = int(tr["thermo"])
    d["velocity"] = {"temp": float(cfg["velocity_temp"]), "seed": int(seed)}
    if tr.get("dump"):
        d["dump"] = dict(tr["dump"], style="custom",
                         file=os.path.join(tmpdir, "mdbench_frames.lammpstrj"))
    return d
