#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc builds csrc/cellpair.cu and csrc/rebin.cu from the
     checkout into lammps_buck_intel_tpu_torch/_build/;
  3. K1, the cell-pair kernel, against its plain torch version on the card
     at buck.yaml's and buck_big.yaml's grids and on a 2-type table, f32
     and f64, force-only and with energy/virial; both timed;
  4. K2, the rebin kernels, against their plain versions: per-atom cell,
     wrapped positions and images identical, every atom once, vacated q
     zero, the forced full-sort fallback and the overflow flag; timed;
  5. buck.yaml (32,000 atoms, 100 steps) and 6. buck_big.yaml (192,000
     atoms, 1000 steps) through run_deck on the card in f32: step-0
     thermo against the recorded goldens, energy drift within their
     gates, both kernels launched, atom-steps/s.
The last lines are the kernels' JSON summary, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

from lammps_buck_intel_tpu_torch import ops
from lammps_buck_intel_tpu_torch.models.pair import build_buck
from lammps_buck_intel_tpu_torch.models.pair.cellpair import (
    compute_cellpair, compute_cellpair_plain)
from lammps_buck_intel_tpu_torch.neighbor import cell_slots as cs
from lammps_buck_intel_tpu_torch.ops import build
from lammps_buck_intel_tpu_torch.run import build_simulation, run_deck

ROOT = os.path.dirname(os.path.abspath(__file__))
DECKS = os.path.join(ROOT, "examples", "decks")
GOLDENS = os.path.join(ROOT, "tests", "goldens")
PKG = "lammps_buck_intel_tpu_torch"
SEED = 20260

# Tolerances of kernel against plain version, same inputs on the card.
# f32: the two sum in different orders (and the kernel contracts to FMA):
#   max|df| <= 1e-4 max|f|; energy and virial rel 1e-5 of their magnitude.
# f64: 1e-11 for both.
TOL = {torch.float32: (1e-4, 1e-5), torch.float64: (1e-11, 1e-11)}
# step-0 thermo against the goldens: the _STEP0_FIELDS rule of
# tests/test_long_horizon.py (press 2e-2 above 5,000 atoms)
STEP0 = {"temp": 1e-3, "evdwl": 2e-3, "ecoul": 2e-3, "elong": 2e-3,
         "emol": 2e-3, "press": 5e-3}


def load_deck(name: str) -> dict:
    import yaml

    with open(os.path.join(DECKS, name)) as f:
        return yaml.safe_load(f)


def cuda_ms(fn, reps: int = 10, setup=None) -> float:
    """Median ms of fn() over reps runs, CUDA events around each call."""
    fn() if setup is None else fn(setup())   # warm-up
    times = []
    for _ in range(reps):
        arg = None if setup is None else setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn() if setup is None else fn(arg)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / max(scale, 1e-300)


def jittered_state(cfg: dict, precision: str, amp: float = 0.1):
    """A deck's initial slot state with seeded random displacements,
    rebinned so every atom sits in its cell."""
    cfg = dict(cfg, precision=precision)
    sim = build_simulation(cfg, device="cuda")
    st = sim.state
    rng = np.random.default_rng(SEED)
    for p in (st.x, st.y, st.z):
        p += torch.as_tensor(rng.uniform(-amp, amp, p.shape[0])).to(p)
    st = cs.rebin(sim.grid, sim.box, st)
    return sim, st


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"kind {torch.cuda.get_device_name(0)}")
    return smi.splitlines()[0]


def phase_build():
    for name in build.LIBRARIES:
        build.load(name)
        secs, log = build.build_info[name]
        print(f"[build] {name}: {secs:.2f} s ({os.path.relpath(log, ROOT)})")
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"[build]   {line.strip()}")


def phase_k1():
    """K1 against its plain version; returns the timing/error summary."""
    out = {}
    buck, big = load_deck("buck.yaml"), load_deck("buck_big.yaml")
    cases = [("buck", buck, "single"), ("buck", buck, "double"),
             ("buck_big", big, "single"), ("buck_big", big, "double")]
    for deck, cfg, prec in cases:
        sim, st = jittered_state(cfg, prec)
        _k1_compare(f"{deck}/{prec}", sim.pair, sim.grid, sim.box, st,
                    sim.precision.acc, out)
        if prec == "single":
            ms = cuda_ms(lambda: compute_cellpair(
                sim.pair, sim.grid, sim.box, st, acc_dtype=torch.float32))
            plain = cuda_ms(lambda: compute_cellpair_plain(
                sim.pair, sim.grid, sim.box, st, acc_dtype=torch.float32))
            print(f"[K1] {deck} f32 force-only: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms (grid {sim.grid.nc} cap {sim.grid.cap} "
                  f"reach_z {sim.grid.reach_z})")
            out[deck] = (ms, plain)
        del sim, st
        torch.cuda.empty_cache()
    # 2-type table on buck.yaml's grid, random types
    sim, st = jittered_state(buck, "single")
    rng = np.random.default_rng(SEED + 1)
    st = st._replace(typ=torch.as_tensor(
        rng.integers(0, 2, st.typ.shape[0]), dtype=torch.int32).cuda())
    style = build_buck(2, {(0, 0): (1.0, 0.2, -0.8), (0, 1): (0.9, 0.22, -0.7),
                           (1, 1): (1.1, 0.18, -0.9)}, cut_global=2.5,
                       shift=True)
    _k1_compare("buck/2-type/single", style, sim.grid, sim.box, st,
                torch.float32, out)
    return out


def _k1_compare(label, style, grid, box, st, acc, out):
    ftol, etol = TOL[st.x.dtype]
    for ev in (False, True):
        k = compute_cellpair(style, grid, box, st, eflag=ev, vflag=ev,
                             acc_dtype=acc)
        p = compute_cellpair_plain(style, grid, box, st, eflag=ev, vflag=ev,
                                   acc_dtype=acc)
        torch.cuda.synchronize()
        fk = torch.stack([k.fx, k.fy, k.fz])
        fp = torch.stack([p.fx, p.fy, p.fz])
        ferr = rel_err(fk, fp)
        abs_err = float((fk - fp).abs().max())
        msg = f"[K1] {label} ev={ev}: max|df|/max|f| {ferr:.3e}"
        ok = ferr <= ftol
        if ev:
            e_err = abs(float(k.evdwl - p.evdwl)) / abs(float(p.evdwl))
            v_err = rel_err(k.virial, p.virial)
            msg += f", evdwl rel {e_err:.3e}, virial rel {v_err:.3e}"
            ok = ok and e_err <= etol and v_err <= etol
        print(msg)
        if not ok:
            raise AssertionError(f"K1 {label} disagrees with its plain "
                                 f"version (tol {ftol}, {etol})")
        if label.endswith("single") and not ev and "2-type" not in label:
            out["max_abs_err"] = max(out.get("max_abs_err", 0.0), abs_err)


def _atom_view(grid, st):
    """Per-atom (cell, x, y, z, ix, iy, iz) from a slot state, and the
    number of slots each atom occupies."""
    n = grid.n_atoms
    aid = st.aid.long()
    valid = aid < n
    count = torch.bincount(aid[valid], minlength=n)
    slot = torch.arange(grid.nslots, device=aid.device)
    cell = torch.full((n,), -1, dtype=torch.long, device=aid.device)
    cell[aid[valid]] = slot[valid] // grid.cap
    at = cs.to_atoms(grid, st)
    return cell, at, count


def _k2_compare(label, grid, st_k, st_p):
    ck, ak, nk = _atom_view(grid, st_k)
    cp, ap, np_ = _atom_view(grid, st_p)
    if not (bool((nk == 1).all()) and bool((np_ == 1).all())):
        raise AssertionError(f"K2 {label}: an atom is missing or doubled")
    if not torch.equal(ck, cp):
        raise AssertionError(f"K2 {label}: per-atom cells differ")
    for key in ("x", "image", "v", "f", "typ", "q"):
        if not torch.equal(ak[key], ap[key]):
            raise AssertionError(f"K2 {label}: atom-order {key} differs")
    for s in (st_k, st_p):
        empty = s.aid >= grid.n_atoms
        if bool((s.q[empty] != 0).any()):
            raise AssertionError(f"K2 {label}: a vacated slot keeps q")
    if bool(st_k.overflow) != bool(st_p.overflow):
        raise AssertionError(f"K2 {label}: overflow flags differ")
    return float((ak["x"] - ap["x"]).abs().max())


def phase_k2():
    out = {}
    sim, st0 = jittered_state(load_deck("buck_big.yaml"), "single")
    grid, box = sim.grid, sim.box
    rng = np.random.default_rng(SEED + 2)
    # displacements of up to ~half a cell: a few % of atoms change cell;
    # some leave the box and wrap
    disp = [torch.as_tensor(rng.uniform(-0.6, 0.6, grid.nslots)).to(p)
            for p in (st0.x, st0.y, st0.z)]
    moved = st0.clone()
    for p, d in zip((moved.x, moved.y, moved.z), disp):
        p += d
    q = torch.as_tensor(rng.uniform(-1, 1, grid.nslots)).to(moved.q)
    moved = moved._replace(q=torch.where(moved.aid < grid.n_atoms, q,
                                         torch.zeros_like(q)))
    B = cs.move_capacity(grid)
    err = 0.0
    for label, bufcap in (("incremental", B), ("forced fallback", 1)):
        k = cs.rebin_incremental(grid, box, moved.clone(), bufcap=bufcap)
        p = cs._rebin_incremental_plain(grid, box, moved.clone(), bufcap)
        err = max(err, _k2_compare(label, grid, k, p))
        print(f"[K2] {label} (B={bufcap}): kernel == plain per atom, "
              f"overflow {bool(k.overflow)}")
    # full rebin from atom order (set-up path)
    at = cs.to_atoms(grid, moved)
    flat = cs.SlotState(
        x=at["x"][:, 0].contiguous(), y=at["x"][:, 1].contiguous(),
        z=at["x"][:, 2].contiguous(), vx=at["v"][:, 0].contiguous(),
        vy=at["v"][:, 1].contiguous(), vz=at["v"][:, 2].contiguous(),
        fx=at["f"][:, 0].contiguous(), fy=at["f"][:, 1].contiguous(),
        fz=at["f"][:, 2].contiguous(), ix=at["image"][:, 0].contiguous(),
        iy=at["image"][:, 1].contiguous(), iz=at["image"][:, 2].contiguous(),
        typ=at["typ"], q=at["q"],
        aid=torch.arange(grid.n_atoms, dtype=torch.int32, device="cuda"),
        overflow=torch.zeros((), dtype=torch.bool, device="cuda"))
    k = cs.rebin(grid, box, flat)
    p = cs._bin_to_slots_plain(cs.wrap_state(box, flat),
                               cs._slot_cid(grid, box, cs.wrap_state(box, flat)),
                               grid.ncell, grid.cap, grid.n_atoms)
    err = max(err, _k2_compare("full rebin", grid, k, p))
    print("[K2] full rebin: kernel == plain per atom")
    # overflow: pile 2 * cap atoms into cell 0
    crowd = moved.clone()
    idx = torch.nonzero(crowd.aid < grid.n_atoms)[: 2 * grid.cap, 0]
    lo = [float(v) for v in box.lo]
    for p_, l in zip((crowd.x, crowd.y, crowd.z), lo):
        p_[idx] = l + 0.01
    k = cs.rebin_incremental(grid, box, crowd.clone(), bufcap=grid.nslots)
    p = cs._rebin_incremental_plain(grid, box, crowd.clone(), grid.nslots)
    if not (bool(k.overflow) and bool(p.overflow)):
        raise AssertionError("K2 overflow: flag not set")
    print("[K2] overflow: both set the sticky flag")

    out["max_abs_err"] = err
    ms = cuda_ms(lambda s: cs.rebin_incremental(grid, box, s),
                 setup=moved.clone)
    plain = cuda_ms(lambda s: cs._rebin_incremental_plain(grid, box, s, B),
                    setup=moved.clone)
    print(f"[K2] buck_big rebin_incremental: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms ({grid.nslots} slots, B={B})")
    out["incremental"] = (ms, plain)
    msf = cuda_ms(lambda: cs.rebin(grid, box, flat))
    wf = cs.wrap_state(box, flat)
    plainf = cuda_ms(lambda: cs._bin_to_slots_plain(
        cs.wrap_state(box, flat), cs._slot_cid(grid, box, wf), grid.ncell,
        grid.cap, grid.n_atoms))
    print(f"[K2] buck_big full rebin: kernel {msf:.4f} ms, plain "
          f"{plainf:.4f} ms")
    out["full"] = (msf, plainf)
    return out


def phase_deck(name: str, golden: str, thermo: int):
    cfg = load_deck(name)
    cfg["thermo"] = thermo
    with open(os.path.join(GOLDENS, golden)) as f:
        g = json.load(f)
    before = dict(ops.LAUNCHES)
    sim, rows = run_deck(cfg, device="cuda", log=False)
    ran = {k: ops.LAUNCHES[k] - before[k] for k in before}
    for k in ("cellpair", "rebin_incremental"):
        if ran[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} was not launched")
    n, steps = sim.n_atoms, int(cfg["run"])
    if rows[-1]["step"] != steps or n != g["n_atoms"]:
        raise AssertionError(f"{name}: ran {rows[-1]['step']} steps on {n} "
                             "atoms")
    ref, row = g["rows"][0], rows[0]
    scale = max(abs(ref["epair"]), 1.0)
    for key, rtol in STEP0.items():
        if key == "press" and n > 5000:
            rtol = 2e-2
        tol = rtol * (scale if key not in ("temp", "press")
                      else max(abs(ref[key]), 1.0))
        if not abs(row[key] - ref[key]) <= tol:
            raise AssertionError(f"{name} step-0 {key}: {row[key]:.8g} vs "
                                 f"golden {ref[key]:.8g} (tol {tol:.3g})")
    e0 = rows[0]["etotal"]
    drift = max(abs(r["etotal"] - e0) for r in rows) / n
    if not drift <= g["drift_gate"]:
        raise AssertionError(f"{name}: drift {drift:.3e}/atom > gate "
                             f"{g['drift_gate']}")
    for r in rows:
        for k in ("temp", "epair", "etotal", "press"):
            if not np.isfinite(r[k]):
                raise AssertionError(f"{name}: non-finite {k}")
    wall = sim.timings["run"]
    print(f"[deck] {name}: {n} atoms x {steps} steps in {wall:.3f} s -> "
          f"{n * steps / wall:,.0f} atom-steps/s, {1e3 * wall / steps:.4f} "
          f"ms/step (thermo every {thermo}); step-0 etotal {e0:.8g} "
          f"(golden {ref['etotal']:.8g}); drift {drift:.3e}/atom (gate "
          f"{g['drift_gate']}); grid {sim.grid.nc} cap {sim.grid.cap} "
          f"reach_z {sim.grid.reach_z}; launches {ran}; grows "
          f"{sim.grows}")
    return n * steps / wall


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    torch.cuda.empty_cache()

    ops.reset_launches()
    phase_deck("buck.yaml", "long_buck.json", thermo=10)
    phase_deck("buck_big.yaml", "long_buck_big.json", thermo=100)
    launches = dict(ops.LAUNCHES)
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 "main path")
    print(f"[launches] {launches}")

    src = f"{PKG}/csrc"
    kernels = [
        dict(name="cellpair_forces", route="cuda", source=f"{src}/cellpair.cu",
             replaces="lammps_buck_intel_tpu/models/pair/cellpair.py:291",
             launches=launches["cellpair"], max_abs_err=k1["max_abs_err"],
             ms=k1["buck_big"][0], plain_ms=k1["buck_big"][1]),
        dict(name="rebin_incremental", route="cuda", source=f"{src}/rebin.cu",
             replaces="lammps_buck_intel_tpu/neighbor/cell_slots.py:314",
             launches=launches["rebin_incremental"],
             max_abs_err=k2["max_abs_err"], ms=k2["incremental"][0],
             plain_ms=k2["incremental"][1]),
        dict(name="rebin_full", route="cuda", source=f"{src}/rebin.cu",
             replaces="lammps_buck_intel_tpu/neighbor/cell_slots.py:289",
             launches=launches["rebin"], max_abs_err=k2["max_abs_err"],
             ms=k2["full"][0], plain_ms=k2["full"][1]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
