"""Deck runner for the PyTorch port.

Counterpart of ``lammps_buck_intel_tpu.run`` for the decks this port
runs: a lattice built with ``create_atoms``, ``pair_style buck``, ``fixes:
[nve]`` and ``engine: cellpair`` (examples/decks/buck.yaml and
buck_big.yaml).  Every other deck key or value raises
NotImplementedError naming its ROADMAP item; nothing is ignored.

CLI:  python -m lammps_buck_intel_tpu_torch.run examples/decks/buck.yaml \
          --device cuda [--steps N]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

# deck key -> where its port stands in ROADMAP queue 1
_UNPORTED_KEYS = {
    "read_data": "item 1 (io/data_reader.py)",
    "replicate": "item 1 (io/lattice.py replicate)",
    "delete_atoms": "item 15",
    "regions": "item 15",
    "kspace_style": "items 7-8 (slice 2, waits for data.aC)",
    "special_bonds": "item 12",
    "special_bonds_coul": "item 12",
    "bond_style": "item 12",
    "angle_style": "item 12",
    "dihedral_style": "item 12",
    "improper_style": "item 12",
    "exclude_intra": "item 13",
    "dump": "item 15",
    "write_data": "item 15",
    "write_restart": "item 15",
    "minimize": "item 15",
    "devices": "item 16",
    "devices_2d": "item 16",
    "pair_kernel": "queue 2 (the port has one pair kernel)",
}
_KEYS = {"units", "precision", "timestep", "engine", "lattice", "mass",
         "velocity", "pair_style", "neighbor", "fixes", "thermo", "run",
         "cap"}


def _parse_pair_key(k: str):
    i, j = k.split()
    return (int(i) - 1, int(j) - 1)


def _check_deck(cfg: dict):
    for key in cfg:
        if key not in _KEYS:
            where = _UNPORTED_KEYS.get(key, "queue 1")
            raise NotImplementedError(
                f"deck key {key!r} is not ported: ROADMAP {where}")
    engine = cfg.get("engine", "nlist")
    if engine != "cellpair":
        raise NotImplementedError(
            f"engine {engine!r} is not ported: ROADMAP queue 1 item 11 "
            "(nlist) / item 16 (slab); set engine: cellpair")
    for fx in cfg.get("fixes", [{"name": "nve"}]):
        if fx.get("name") != "nve" or len(fx) > 1:
            raise NotImplementedError(
                f"fix {fx!r} is not ported: ROADMAP queue 1 items 9, 12-14")
    if "lattice" not in cfg:
        raise NotImplementedError(
            "decks without a lattice (read_data) are not ported: ROADMAP "
            "queue 1 item 1")
    name = cfg["pair_style"]["name"]
    if name != "buck":
        raise NotImplementedError(
            f"pair_style {name!r} is not ported: buck/coul/* is slice 2 "
            "(ROADMAP queue 1 items 7-8), lj/* item 12-13")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def build_simulation(cfg: dict, device="cuda"):
    """Construct a CellPairSimulation from a deck config on ``device``."""
    from .core import get_precision, get_units, make_box, make_system
    from .integrate import CellPairSimulation, NeighborPolicy
    from .io import lattice, velocity
    from .models.pair import build_buck

    dev = _device(device)
    _check_deck(cfg)
    u = get_units(cfg.get("units", "lj"))
    prec = get_precision(cfg.get("precision", "single"))
    dt = cfg.get("timestep", u.dt)

    lc = cfg["lattice"]
    x, lo, hi = lattice.create_atoms(
        lc.get("style", "fcc"), lc["density"], lc["nx"], lc["ny"], lc["nz"])
    mass = np.asarray(cfg.get("mass", [1.0]), np.float64)
    n = len(x)
    typ = np.zeros(n, np.int32)
    mass_per_atom = mass[typ]

    v0 = None
    vel = cfg.get("velocity")
    if vel:
        v0 = velocity.create(
            n, vel["temp"], vel.get("seed", 12345), mass_per_atom, u,
            dist=vel.get("dist", "gaussian"), rng=vel.get("rng", "numpy"),
            loop=vel.get("loop", "all"), coords=x)

    box = make_box(lo, hi)
    ps = cfg["pair_style"]
    coeffs = {_parse_pair_key(k): tuple(v)
              for k, v in ps.get("coeffs", {}).items()}
    style = build_buck(
        len(mass), coeffs, cut_global=ps["cut"], name=ps["name"],
        special_lj=(1.0, 1.0, 1.0, 1.0), special_coul=(1.0, 1.0, 1.0, 1.0),
        qqrd2e=u.qqrd2e, shift=ps.get("shift", False))

    nb = cfg.get("neighbor", {})
    policy = NeighborPolicy(
        skin=nb.get("skin", u.skin), every=nb.get("every", 1),
        delay=nb.get("delay", 0), check=nb.get("check", True))
    system = make_system(x, box, type=typ, v=v0, mass=mass, dtype=prec.flt,
                         device=dev)
    try:
        return CellPairSimulation(
            system, style, units=u, precision=prec, dt=dt, neighbor=policy,
            cap=int(cfg["cap"]) if cfg.get("cap") else None)
    except ValueError as e:
        if "box too small" not in str(e):
            raise
        raise NotImplementedError(str(e)) from e


def run_deck(cfg: dict, device="cuda", log: bool = True):
    """Build and run a deck; returns (sim, thermo_rows)."""
    sim = build_simulation(cfg, device=device)
    nsteps = int(cfg.get("run", 0))
    thermo = int(cfg.get("thermo", max(nsteps // 10, 1)))
    t0 = time.perf_counter()
    rows = sim.run(nsteps, thermo_every=thermo, log=log)
    wall = time.perf_counter() - t0
    if log:
        print(f"# {nsteps} steps, {sim.n_atoms} atoms: {wall:.2f}s "
              f"-> {sim.n_atoms * nsteps / wall:,.0f} atom-steps/s")
    return sim, rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="lammps_buck_intel_tpu_torch deck runner")
    ap.add_argument("deck", help="YAML deck file")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "versions of the kernels)")
    ap.add_argument("--steps", type=int, help="override run length")
    args = ap.parse_args(argv)
    if not args.deck.endswith((".yaml", ".yml")):
        raise NotImplementedError(
            "literal LAMMPS input scripts are not ported: ROADMAP queue 1 "
            "item 15 (io/lammps_input.py)")
    import yaml

    with open(args.deck) as f:
        cfg = yaml.safe_load(f)
    if args.steps is not None:
        cfg["run"] = args.steps
    dev = _device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# deck: {args.deck} on {name}")
    run_deck(cfg, device=dev)


if __name__ == "__main__":
    main()
