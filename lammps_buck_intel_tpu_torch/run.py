"""Deck runner for the PyTorch port.

Counterpart of ``lammps_buck_intel_tpu.run`` for the decks this port
runs with ``engine: cellpair`` and ``fixes: [nve]``: a lattice built with
``create_atoms`` or atoms read with ``read_data`` (atom style charge,
optionally ``replicate``d); ``pair_style buck``, or ``buck/coul/long``
with ``kspace_style pppm`` (ik) on a mesh aligned to the engine's cells
(examples/decks/buck.yaml, buck_big.yaml, cristobalite_pppm.yaml).
Every other deck key or value raises NotImplementedError naming its
ROADMAP item; nothing is ignored.  A relative ``read_data`` path
resolves against the working directory, as in the JAX package.

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
    "delete_atoms": "item 15",
    "regions": "item 15",
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
         "read_data", "replicate", "velocity", "pair_style", "kspace_style",
         "neighbor", "fixes", "thermo", "run", "cap"}
# kspace_style keys the port reads; "grid" (kspace_modify mesh) is left
# out because the cell-pair engine aligns the mesh to its cells
_KSPACE_KEYS = {"name", "accuracy", "order", "diff", "gewald"}


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
    if "lattice" not in cfg and "read_data" not in cfg:
        raise ValueError("deck needs read_data or lattice")
    name = cfg["pair_style"]["name"]
    if name not in ("buck", "buck/coul/long"):
        raise NotImplementedError(
            f"pair_style {name!r} is not ported: buck and buck/coul/long "
            "only (ROADMAP queue 1 item 10 coul/cut, items 12-13 lj/*)")
    ks = cfg.get("kspace_style")
    if (ks is None) != (name == "buck"):
        raise NotImplementedError(
            f"pair_style {name!r} with kspace_style {ks!r} is not ported: "
            "buck runs without k-space, buck/coul/long with pppm")
    if ks is not None:
        extra = set(ks) - _KSPACE_KEYS
        if ks["name"] != "pppm" or extra:
            raise NotImplementedError(
                f"kspace_style {ks!r} is not ported: pppm (accuracy, order, "
                "diff ik, gewald) only; ewald and pppm/disp are ROADMAP "
                "queue 1 items 10 and 13, slab and mesh overrides item 10")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _geometry(cfg: dict):
    """Atoms of the deck: (x, lo, hi, typ, q, image, v0, mass) host numpy;
    v0 None where the deck gives no velocities."""
    from .io import lattice, read_data

    if "read_data" in cfg:
        d = read_data(cfg["read_data"])
        x, lo, hi = d.x, d.box_lo, d.box_hi
        if d.tilt is not None and np.any(d.tilt != 0.0):
            raise NotImplementedError(
                "triclinic data files are not ported: ROADMAP queue 1 "
                "item 14")
        typ, q, image, mass = d.type, d.q, d.image, d.mass
        v0 = d.v if np.abs(d.v).any() else None
        rep = cfg.get("replicate")
        if rep:
            per_atom = {"type": typ, "q": q, "image": image}
            if v0 is not None:
                per_atom["v"] = v0
            x, lo, hi, pa = lattice.replicate(x, lo, hi, tuple(rep),
                                              per_atom=per_atom)
            typ, q, image, v0 = pa["type"], pa["q"], pa["image"], pa.get("v")
        return x, lo, hi, typ, q, image, v0, mass
    if "replicate" in cfg:
        raise NotImplementedError(
            "replicate without read_data is not ported (the JAX package "
            "ignores it on lattice decks)")
    lc = cfg["lattice"]
    x, lo, hi = lattice.create_atoms(
        lc.get("style", "fcc"), lc["density"], lc["nx"], lc["ny"], lc["nz"])
    n = len(x)
    return (x, lo, hi, np.zeros(n, np.int32), np.zeros(n),
            np.zeros((n, 3), np.int32), None,
            np.asarray(cfg.get("mass", [1.0]), np.float64))


def _patch_aligned_smin(nc, L, skin, order):
    """Per-axis mesh points per cell, the JAX package's rule for its
    spline patches: S >= (order+1)//2 + margin, the margin covering the
    inter-rebin skin drift.  The port keeps the rule so both packages
    solve on the same mesh."""
    smin = []
    for ax in range(3):
        s = (order + 1) // 2 + 2
        while True:
            h = L[ax] / (s * nc[ax])
            m = max(2, int(np.ceil(0.5 * skin / h - 1e-9)))
            if s >= (order + 1) // 2 + m:
                break
            s += 1
        smin.append(s)
    return smin


def _pppm_for_grid(cfg: dict, box, q, style, prec, skin: float):
    """The engine's k-space solver as a function of its cell grid: PPPM
    on a mesh aligned to the grid's coarse (reach-1) cells, with the
    g_ewald the pair style already carries."""
    from .models.kspace import CellPPPM, setup_pppm

    ks, ps = cfg["kspace_style"], cfg["pair_style"]
    order = ks.get("order", 5)

    def make(grid):
        kgrid = grid.coarse()
        nc = np.asarray(kgrid.nc)
        smin = _patch_aligned_smin(nc, np.asarray(box.perp_widths), skin,
                                   order)
        pm = setup_pppm(box, q, cutoff=ps.get("cut_coul", ps["cut"]),
                        accuracy_rel=ks.get("accuracy", 1e-4),
                        qqrd2e=style.qqrd2e, order=order,
                        g_ewald=style.g_ewald, diff=ks.get("diff", "ik"),
                        multiple_of=kgrid.nc,
                        grid_min=tuple(int(s * c) for s, c in zip(smin, nc)),
                        acc_dtype=prec.acc)
        return CellPPPM(pm, grid.n_atoms)

    return make


def build_simulation(cfg: dict, device="cuda"):
    """Construct a CellPairSimulation from a deck config on ``device``."""
    from .core import get_precision, get_units, make_box, make_system
    from .integrate import CellPairSimulation, NeighborPolicy
    from .io import velocity
    from .models.kspace import pppm_g_ewald
    from .models.pair import build_buck

    dev = _device(device)
    _check_deck(cfg)
    u = get_units(cfg.get("units", "lj"))
    prec = get_precision(cfg.get("precision", "single"))
    dt = cfg.get("timestep", u.dt)

    x, lo, hi, typ, q, image, v0, mass = _geometry(cfg)
    n = len(x)
    vel = cfg.get("velocity")
    if vel:
        v0 = velocity.create(
            n, vel["temp"], vel.get("seed", 12345), mass[typ], u,
            dist=vel.get("dist", "gaussian"), rng=vel.get("rng", "numpy"),
            loop=vel.get("loop", "all"), coords=x)

    box = make_box(lo, hi)
    ps = cfg["pair_style"]
    coeffs = {_parse_pair_key(k): tuple(v)
              for k, v in ps.get("coeffs", {}).items()}
    coul = "long" if ps["name"] == "buck/coul/long" else "none"
    style = build_buck(
        len(mass), coeffs, cut_global=ps["cut"], coul=coul,
        cut_coul=ps.get("cut_coul"), name=ps["name"],
        special_lj=(1.0, 1.0, 1.0, 1.0), special_coul=(1.0, 1.0, 1.0, 1.0),
        qqrd2e=u.qqrd2e, shift=ps.get("shift", False))
    ks = cfg.get("kspace_style")
    if ks is not None:
        g = ks.get("gewald")
        if g is None:
            g = pppm_g_ewald(box, q, ps.get("cut_coul", ps["cut"]),
                             ks.get("accuracy", 1e-4), u.qqrd2e)
        style = style.replace(g_ewald=float(g))

    nb = cfg.get("neighbor", {})
    policy = NeighborPolicy(
        skin=nb.get("skin", u.skin), every=nb.get("every", 1),
        delay=nb.get("delay", 0), check=nb.get("check", True))
    system = make_system(x, box, type=typ, v=v0, q=q, image=image, mass=mass,
                         dtype=prec.flt, device=dev)
    kspace = (None if ks is None
              else _pppm_for_grid(cfg, box, q, style, prec, policy.skin))
    try:
        return CellPairSimulation(
            system, style, units=u, precision=prec, dt=dt, neighbor=policy,
            cap=int(cfg["cap"]) if cfg.get("cap") else None, kspace=kspace)
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
