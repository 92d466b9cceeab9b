#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc builds csrc/cellpair.cu, csrc/rebin.cu, csrc/pppm.cu,
     csrc/bonded.cu, csrc/verlet.cu, csrc/shake.cu, csrc/nlist.cu and
     csrc/npt.cu from the checkout into
     lammps_buck_intel_tpu_torch/_build/, one nvcc per source, all started
     together;
  3. K1, the cell-pair kernel, against its plain torch version on the card
     at buck.yaml's and buck_big.yaml's grids, on a 2-type table, and with
     its coul/long branch on cristobalite_pppm.yaml's grid; f32 and f64,
     force-only and with energy/virial; timed;
  4. K2, the rebin kernels, against their plain versions on
     buck_big.yaml's and cristobalite_pppm.yaml's grids: per-atom cell,
     wrapped positions and images identical, every atom once, vacated q
     zero, the forced full-sort fallback and the overflow flag; timed;
  5. the PPPM kernels (deposit, spectral, gather) against their plain
     versions at cristobalite_pppm.yaml's mesh, atoms drifted up to skin/2
     out of their cells, f32 and f64; timed;
  6. cristobalite_pppm.yaml in f64 at 11,520 atoms on a jittered copy of
     its crystal against the JAX package's f64 record: step-0 forces,
     thermo at steps 0 and 10, positions at step 10;
  7. the main paths through build_simulation and run on the card in
     f32, launch counts set to 0 just before each and read just after:
     buck.yaml (32,000 atoms, 100 steps), buck_big.yaml (192,000 atoms,
     1000 steps) and
     cristobalite_pppm.yaml (259,200 atoms, buck/coul/long + PPPM order 7,
     100 steps): step-0 thermo against the recorded JAX rows (and the
     reciprocal part of elong), energy drift within the gates, every
     kernel of the path launched, atom-steps/s;
  8. the molecular path (lj/charmm/coul/long with special bonds, PPPM
     order 5, bonds, CHARMM angles, dihedrals, impropers) on
     examples/data.rhodo_class: K1's lj/charmm + special-bond variant,
     the three bonded kernels and the four integrator kernels (kick and
     drift, kick with the force sum, kinetic sums, the Nose-Hoover chain
     half step) against their plain versions at the decks' 31,104 atoms
     and at 248,832 atoms, f32 and f64, timed at the larger size;
     rhodo_flex_nve.yaml and
     rhodo_flex_nvt.yaml in f64 at 1,728 atoms against the JAX package's
     f64 record (step-0 forces, thermo rows, positions, the thermostat
     chain); both decks in full (31,104 atoms, 100 steps, f32) against the
     recorded step-0 row scaled to 18 copies, the NVE drift under its
     recorded gate, NVT's temperature rows against the JAX package's own
     f32 NVT run of one copy; the NVE deck at replicate [6, 6, 4] (248,832
     atoms), with the launch counts that the kernels line reports for the
     molecular path's kernels;
  9. the literal rhodo decks, SHAKE/RATTLE (K13): the four constraint
     kernels (reference bond vectors, positions, RATTLE, virial) against
     their plain versions on synthetic clusters of C = 1, 3 and 12 and on
     rhodo_nve.yaml's C-H clusters at 31,104 and 248,832 atoms, f32 and
     f64, timed at the larger size; rhodo_nve.yaml and rhodo_class.yaml in
     f64 at 1,728 atoms against the JAX package's f64 record
     (tests/goldens/torch_rhodo_shake.json: forces, rows, positions, the
     chain, the constraint violation); rhodo_nve.yaml in full (31,104
     atoms, 100 steps) against long_rhodo_nve.json's step-0 row and drift
     gate, rhodo_32k.yaml's temperature rows against the JAX package's own
     f32 NVT + SHAKE run of one copy, rhodo_nve.yaml at replicate [6, 6,
     4]; the constraints within the decks' tol at every thermo row, and
     the K13 launch counts of that last run in the kernels line;
 10. fix npt on the neighbor-list engine (rhodo_npt.yaml, the literal
     in.rhodo fix stack): the list build and list pair pass (K9a, K9b),
     the traced influence function and the barostat's per-atom passes
     (K16a, K16c) and the PPPM, constraint and bonded kernels with the box
     read on the card, each against its plain version on one copy in f64
     and f32 and at 248,832 atoms in f32, where the new kernels are timed;
     the deck in f64 on one copy against the JAX package's f64 record
     (tests/goldens/torch_rhodo_npt.json: forces, rows every 5 steps,
     box, strain rate, chain, positions); the deck unedited at 31,104
     atoms (step 0 against long_rhodo_npt.json, the rows at 50 and 100
     against the record's scaled rows at its row_tol) and at replicate
     [6, 6, 4] (step 0 against the record scaled to 144 copies), ms/step,
     and the NPT launch counts of that last run in the kernels line.
The last lines are the kernels' JSON summary (ms: CUDA events around a
run of calls, what a caller pays; device_ms: the card's own time from
torch.profiler; the plain version's and a library call's time; the
least time the card could take; launches on the main path), the card's
name and power limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from lammps_buck_intel_tpu_torch import ops
from lammps_buck_intel_tpu_torch.integrate import shake
from lammps_buck_intel_tpu_torch.integrate.shake import max_violation
from lammps_buck_intel_tpu_torch.models.bonded import (compute_bonded,
                                                       compute_bonded_plain,
                                                       make_bonded)
from lammps_buck_intel_tpu_torch.models.kspace import pppm_cells
from lammps_buck_intel_tpu_torch.models.pair import build_buck
from lammps_buck_intel_tpu_torch.models.pair.cellpair import (
    _chunk_cells, compute_cellpair, compute_cellpair_plain, full_offsets,
    half_stencil_tables)
from lammps_buck_intel_tpu_torch.neighbor import cell_slots as cs
from lammps_buck_intel_tpu_torch.ops import build
from lammps_buck_intel_tpu_torch.ops import pppm as pppm_ops
from lammps_buck_intel_tpu_torch.run import build_simulation
from lammps_buck_intel_tpu_torch.utils import device_trace

ROOT = os.path.dirname(os.path.abspath(__file__))
DECKS = os.path.join(ROOT, "examples", "decks")
GOLDENS = os.path.join(ROOT, "tests", "goldens")
PKG = "lammps_buck_intel_tpu_torch"
SRC = f"{PKG}/csrc"
SEED = 20260

# Tolerances of kernel against plain version, same inputs on the card.
# f32: the two sum in different orders (the kernels contract to FMA, the
#   deposit's atomics land in any order): max|d| <= 1e-4 max|ref| for
#   forces and meshes; energy and virial rel 1e-5 of their magnitude.
# f64: 1e-11 for both.
TOL = {torch.float32: (1e-4, 1e-5), torch.float64: (1e-11, 1e-11)}
# step-0 thermo against the goldens: the _STEP0_FIELDS rule of
# tests/test_long_horizon.py (press 2e-2 above 5,000 atoms)
STEP0 = {"temp": 1e-3, "evdwl": 2e-3, "ecoul": 2e-3, "elong": 2e-3,
         "emol": 2e-3, "press": 5e-3}
# The ideal crystal's step-0 elong is the self energy (a host constant)
# plus a reciprocal part 10^4 times smaller, which the elong rule above
# cannot see.  That part is gated on its own, rel 1e-2 of the record's:
# f32 rounding of elong (~1.8e6) is 0.125 = 8e-4 of it, and the record's
# scaling from 11,520 atoms holds to 8.1e-5 across four meshes per cell;
# a PPPM that returned zero would be off by all of it.
RECIP_TOL = 1e-2
# f64 on the card against the JAX package's f64 record of the jittered
# deck: the CPU parity tolerances of tests/test_torch_slice.py and
# tests/test_torch_pppm.py
JITTER_TOL = {"rows": 1e-9, "f": 1e-8, "x": 1e-9}

# Least time the card could take (bound_ms): the larger of the bytes the
# function must move (each input read once, each output written once)
# over the memory rate and its operations over the f32 peak outside the
# tensor cores (H100 SXM data sheet, at 700 W).  Operations count one
# per add, multiply, divide, sqrt or exp:
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# per pair inside the cutoff, evaluated once with Newton's third law:
# distance 8, clamp 1, 1/r^2 and r 2, buck 8, coul/long 24 (prefactor 3,
# grij and exp 3, A&S erfc 13, force 5), scalar 1, both atoms' forces 9;
# lj/charmm 10 (r^-6 2, forcelj 4, philj 4) in place of buck's 8, and 15
# more for a pair in the switching region (tt 1, switch1 6, switch2 5,
# combination 3)
OPS_PAIR = {("buck", "none"): 29, ("buck", "long"): 53,
            ("ljcharmm", "long"): 55}
OPS_SWITCH = 15
# per bonded term (adds, multiplies, divides, square roots, arccos, rint;
# minimum image 4 per component): bond 12 image + 20; angle 24 image + 55,
# its Urey-Bradley part 12 + 20; dihedral 36 image, three cross products
# 27, angle and multiplicity ~40, gradient ~45, 1-4 pair ~35, forces and
# mapping 20; improper the same without the 1-4 pair and the multiplicity
OPS_BONDED = {"bond": 32, "angle": 79, "urey_bradley": 32, "dihedral": 205,
              "improper": 160}
# per atom of an order-p PPPM stencil: p weights per axis by Horner
# (2 (p - 1) each), p^2 products w_x w_y, then p^3 points
OPS_WEIGHTS = lambda p: 3 * p * 2 * (p - 1) + p * p  # noqa: E731
OPS_DEPOSIT_PT = 3     # w_xy w_z, times q, add
OPS_GATHER_PT = 7      # w_xy w_z, three multiply-adds
OPS_SPECTRAL_PT = 8    # G rho_hat (2), three ik spectra (6)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, nops / PEAK_F32_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def load_deck(name: str) -> dict:
    import yaml

    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    if "read_data" in cfg:
        cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    return cfg


def load_golden(name: str) -> dict:
    with open(os.path.join(GOLDENS, name)) as f:
        return json.load(f)


def cuda_ms(fn, reps: int = 10, setup=None) -> float:
    """ms per call of fn(): CUDA events around a run of reps calls after
    a warm-up.  With ``setup`` (a fresh input per call, for functions
    that update their input in place) the median of reps calls, each
    between its own pair of events, so the setup stays outside."""
    fn() if setup is None else fn(setup())   # warm-up
    torch.cuda.synchronize()
    if setup is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    times = []
    for _ in range(reps):
        arg = setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 10, setup=None, tries: int = 12) -> float:
    """Device time per call of fn(): every kernel, copy and fill it puts
    on the card, from a torch.profiler trace of reps calls (the host
    time of the wrapper around them left out).  A trace that lost its
    lead (device_trace.TraceLost) is taken again on fresh inputs, with a
    lead up to 4 times as long each time (at most 256 times the first:
    the losses come in runs, and a longer lead ends them)."""
    for attempt in range(tries):
        args = [None if setup is None else setup() for _ in range(reps + 1)]
        fn() if setup is None else fn(args[0])   # warm-up

        def run():
            for arg in args[1:]:
                fn() if setup is None else fn(arg)

        try:
            events = device_trace.device_events(
                run, device_trace.SPIN_CYCLES * 4 ** min(attempt, 4))
        except device_trace.TraceLost as e:
            print(f"[trace] {e}; tracing again")
            continue
        ms = device_trace.device_ms(events) / reps
        if ms <= 0:
            raise AssertionError("torch.profiler recorded no device time")
        return ms
    raise AssertionError(f"torch.profiler lost the trace's lead {tries} "
                         "times")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / max(scale, 1e-300)


def scalar_rel(a, b) -> float:
    return abs(float(a - b)) / max(abs(float(b)), 1e-300)


def plane_bytes(*planes) -> int:
    return sum(p.element_size() for p in planes)


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


def pairs_in_cutoff(style, grid, box, st, rsq_min: float = -1.0) -> int:
    """Unordered pairs of this state within the style's largest cutoff
    (and beyond rsq_min): the pair work the function needs (the kernel
    tests every candidate of the full stencil, from both sides)."""
    ncell, cap, n = grid.ncell, grid.cap, grid.n_atoms
    offs = full_offsets(grid.reach_z)
    S = offs.shape[0]
    nbr, _, shifts = half_stencil_tables(grid.nc, offs)
    nbr_t = torch.as_tensor(nbr, dtype=torch.long, device=st.x.device)
    shift_t = torch.as_tensor(shifts * np.asarray(box.lengths),
                              device=st.x.device).to(st.x.dtype)
    pos = [p.view(ncell, cap) for p in (st.x, st.y, st.z)]
    aid = st.aid.view(ncell, cap)
    total = 0
    chunk = _chunk_cells(cap, S, ncell)
    for c0 in range(0, ncell, chunk):
        c1 = min(ncell, c0 + chunk)
        js = nbr_t[c0:c1]
        rsq = 0.0
        for ax in range(3):
            pj = (pos[ax][js] + shift_t[c0:c1, :, ax, None]).reshape(
                c1 - c0, 1, S * cap)
            rsq = rsq + (pos[ax][c0:c1, :, None] - pj) ** 2
        ai = aid[c0:c1, :, None]
        aj = aid[js].reshape(c1 - c0, 1, S * cap)
        ok = ((ai < n) & (aj < n) & (ai != aj) & (rsq < style.cutsq_max)
              & (rsq > rsq_min))
        total += int(ok.sum())
    return total // 2


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
    build.load_all()
    for name in build.LIBRARIES:
        secs, log = build.build_info[name]
        print(f"[build] {name}: {secs:.2f} s ({os.path.relpath(log, ROOT)})")
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"[build]   {line.strip()}")


def _k1_compare(label, style, grid, box, st, acc, special=None):
    """Kernel vs plain, force-only and with e/v; returns the f32/f64
    force-only max |df|."""
    ftol, etol = TOL[st.x.dtype]
    abs_err = 0.0
    for ev in (False, True):
        k = compute_cellpair(style, grid, box, st, eflag=ev, vflag=ev,
                             acc_dtype=acc, special=special)
        p = compute_cellpair_plain(style, grid, box, st, eflag=ev, vflag=ev,
                                   acc_dtype=acc, special=special)
        torch.cuda.synchronize()
        fk = torch.stack([k.fx, k.fy, k.fz])
        fp = torch.stack([p.fx, p.fy, p.fz])
        ferr = rel_err(fk, fp)
        if not ev:
            abs_err = float((fk - fp).abs().max())
        msg = f"[K1] {label} ev={ev}: max|df|/max|f| {ferr:.3e}"
        ok = ferr <= ftol
        if ev:
            errs = {"evdwl": scalar_rel(k.evdwl, p.evdwl),
                    "virial": rel_err(k.virial, p.virial)}
            if style.cfg.coul == "long":
                errs["ecoul"] = scalar_rel(k.ecoul, p.ecoul)
            msg += "".join(f", {n} rel {e:.3e}" for n, e in errs.items())
            ok = ok and all(e <= etol for e in errs.values())
        print(msg)
        if not ok:
            raise AssertionError(f"K1 {label} disagrees with its plain "
                                 f"version (tol {ftol}, {etol})")
    return abs_err


def _k1_time(label, sim, st, reps_plain=3):
    """Force-only f32 kernel and plain times, and the kernel's bound."""
    style, grid, box, special = sim.pair, sim.grid, sim.box, sim.special
    def kern():
        return compute_cellpair(style, grid, box, st,
                                acc_dtype=torch.float32, special=special)

    ms, dev_ms = cuda_ms(kern), device_ms(kern)
    plain = cuda_ms(lambda: compute_cellpair_plain(
        style, grid, box, st, acc_dtype=torch.float32, special=special),
        reps=reps_plain)
    pairs = pairs_in_cutoff(style, grid, box, st)
    coul = style.cfg.coul
    # the aid plane says which slots hold an atom; of those, each atom's
    # position, type (and charge) are read and its f32 force written once
    planes = (st.x, st.y, st.z, st.typ) + (
        (st.q,) if coul == "long" else ())
    nbytes = (grid.nslots * plane_bytes(st.aid)
              + grid.n_atoms * (plane_bytes(*planes) + 3 * 4))
    nops = pairs * OPS_PAIR[style.cfg.vdw, coul]
    if style.cfg.vdw == "ljcharmm":
        nops += OPS_SWITCH * pairs_in_cutoff(style, grid, box, st,
                                             rsq_min=style.inner_sq)
    if special is not None:
        nbytes += special.packed.numel() * 4
    b_ms, b_by = bound(nbytes, nops)
    print(f"[K1] {label} f32 force-only: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f}), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}; {pairs:,} pairs in cutoff, {nbytes:,} bytes) (grid "
          f"{grid.nc} cap {grid.cap} reach_z {grid.reach_z})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by)


def phase_k1():
    """K1 against its plain version on the buck decks; timed at buck_big."""
    out = {"max_abs_err": 0.0}
    buck, big = load_deck("buck.yaml"), load_deck("buck_big.yaml")
    for deck, cfg in (("buck", buck), ("buck_big", big)):
        for prec in ("single", "double"):
            sim, st = jittered_state(cfg, prec)
            err = _k1_compare(f"{deck}/{prec}", sim.pair, sim.grid, sim.box,
                              st, sim.precision.acc)
            if prec == "single":
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out[deck] = _k1_time(deck, sim, st)
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
                torch.float32)
    return out


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


def phase_k2(deck: str):
    """K2 against its plain version on a deck's own grid and cap; an
    uncharged deck gets random charges, so that q moves are checked."""
    out = {}
    label = deck.split(".")[0]
    sim, st0 = jittered_state(load_deck(deck), "single")
    grid, box = sim.grid, sim.box
    rng = np.random.default_rng(SEED + 2)
    # displacements of up to ~half a cell: a few % of atoms change cell;
    # some leave the box and wrap
    disp = [torch.as_tensor(rng.uniform(-0.6, 0.6, grid.nslots)).to(p)
            for p in (st0.x, st0.y, st0.z)]
    moved = st0.clone()
    for p, d in zip((moved.x, moved.y, moved.z), disp):
        p += d
    if not bool((moved.q != 0).any()):
        q = torch.as_tensor(rng.uniform(-1, 1, grid.nslots)).to(moved.q)
        moved = moved._replace(q=torch.where(moved.aid < grid.n_atoms, q,
                                             torch.zeros_like(q)))
    B = cs.move_capacity(grid)
    err = 0.0
    for how, bufcap in (("incremental", B), ("forced fallback", 1)):
        k = cs.rebin_incremental(grid, box, moved.clone(), bufcap=bufcap)
        p = cs._rebin_incremental_plain(grid, box, moved.clone(), bufcap)
        err = max(err, _k2_compare(f"{label} {how}", grid, k, p))
        print(f"[K2] {label} {how} (B={bufcap}): kernel == plain per atom, "
              f"overflow {bool(k.overflow)}")
    movers = int((_atom_view(grid, k)[0] != _atom_view(grid, moved)[0]).sum())
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
    err = max(err, _k2_compare(f"{label} full rebin", grid, k, p))
    print(f"[K2] {label} full rebin: kernel == plain per atom")
    # overflow: pile 2 * cap atoms into cell 0
    crowd = moved.clone()
    idx = torch.nonzero(crowd.aid < grid.n_atoms)[: 2 * grid.cap, 0]
    lo = [float(v) for v in box.lo]
    for p_, l in zip((crowd.x, crowd.y, crowd.z), lo):
        p_[idx] = l + 0.01
    k = cs.rebin_incremental(grid, box, crowd.clone(), bufcap=grid.nslots)
    p = cs._rebin_incremental_plain(grid, box, crowd.clone(), grid.nslots)
    if not (bool(k.overflow) and bool(p.overflow)):
        raise AssertionError(f"K2 {label} overflow: flag not set")
    print(f"[K2] {label} overflow: both set the sticky flag")

    out["max_abs_err"] = err
    slot_bytes = plane_bytes(*(getattr(moved, f) for f in cs.MOVE_FIELDS))
    # incremental: read every slot's position and id once, move each
    # mover's planes (read and write)
    inc_bytes = (grid.nslots * plane_bytes(moved.x, moved.y, moved.z,
                                           moved.aid)
                 + 2 * movers * slot_bytes)
    ms = cuda_ms(lambda s: cs.rebin_incremental(grid, box, s),
                 setup=moved.clone)
    dev = device_ms(lambda s: cs.rebin_incremental(grid, box, s),
                    setup=moved.clone)
    plain = cuda_ms(lambda s: cs._rebin_incremental_plain(grid, box, s, B),
                    setup=moved.clone)
    b_ms, b_by = bound(inc_bytes, 0)
    print(f"[K2] {label} rebin_incremental: kernel {ms:.4f} ms (device "
          f"{dev:.4f}), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{movers} movers) ({grid.nslots} slots, B={B})")
    out["incremental"] = dict(ms=ms, device_ms=dev, plain_ms=plain,
                              bound_ms=b_ms, bound_by=b_by)
    msf = cuda_ms(lambda: cs.rebin(grid, box, flat))
    devf = device_ms(lambda: cs.rebin(grid, box, flat))
    wf = cs.wrap_state(box, flat)
    plainf = cuda_ms(lambda: cs._bin_to_slots_plain(
        cs.wrap_state(box, flat), cs._slot_cid(grid, box, wf), grid.ncell,
        grid.cap, grid.n_atoms))
    # full: read every atom's planes, write every slot's
    b_ms, b_by = bound((grid.n_atoms + grid.nslots) * slot_bytes, 0)
    print(f"[K2] {label} full rebin: kernel {msf:.4f} ms (device "
          f"{devf:.4f}), plain {plainf:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    out["full"] = dict(ms=msf, device_ms=devf, plain_ms=plainf,
                       bound_ms=b_ms, bound_by=b_by)
    return out


def phase_cristobalite_k1():
    """K1's coul/long branch on cristobalite_pppm.yaml's grid."""
    cfg = load_deck("cristobalite_pppm.yaml")
    out = {}
    for prec in ("single", "double"):
        sim, st = jittered_state(cfg, prec)
        err = _k1_compare(f"cristobalite/{prec}", sim.pair, sim.grid,
                          sim.box, st, sim.precision.acc)
        if prec == "single":
            out = dict(_k1_time("cristobalite", sim, st), max_abs_err=err)
        del sim, st
        torch.cuda.empty_cache()
    return out


def _pppm_compare(label, name, k, p, tol, out):
    err = rel_err(k, p)
    print(f"[PPPM] {label} {name}: max|d|/max|ref| {err:.3e}")
    if not err <= tol:
        raise AssertionError(f"PPPM {name} {label} disagrees with its plain "
                             f"version (tol {tol})")
    out.setdefault(name, {})["max_abs_err"] = float((k - p).abs().max())


def phase_pppm():
    """The three PPPM kernels against their plain versions on the card,
    at cristobalite_pppm.yaml's mesh, atoms drifted up to skin/2 out of
    their cells (and out of the box) as between two rebins."""
    cfg = load_deck("cristobalite_pppm.yaml")
    out = {}
    for prec in ("single", "double"):
        sim, st = jittered_state(cfg, prec)
        skin = sim.neighbor.skin
        rng = np.random.default_rng(SEED + 3)
        for p in (st.x, st.y, st.z):
            p += torch.as_tensor(rng.uniform(-0.5 * skin, 0.5 * skin,
                                             p.shape[0])).to(p)
        solver, flt, acc = sim.kspace, st.x.dtype, sim.precision.acc
        pm, n = solver.pm, sim.n_atoms
        c = solver.consts(st.x.device, flt, acc)
        ftol, etol = TOL[flt]
        label = f"cristobalite/{prec}"
        if prec == "single":
            print(f"[PPPM] mesh {pm.grid} order {pm.order} g_ewald "
                  f"{pm.g_ewald:.6f} h {tuple(round(h, 4) for h in pm.h)}; "
                  f"cell grid {sim.grid.nc} (coarse {sim.grid.coarse().nc}) cap "
                  f"{sim.grid.cap}")
        res = {}
        mesh_k = pppm_ops.deposit(pm, st, n, c["coef"])
        mesh_p = pppm_cells.deposit_plain(pm, st)
        _pppm_compare(label, "deposit", mesh_k, mesh_p, ftol, res)
        rhat = torch.fft.rfftn(mesh_p.to(acc)).contiguous()
        for ev in (False, True):
            ek, esk, vsk = pppm_ops.spectral(c, rhat, ev)
            ep, esp, vsp = pppm_cells.spectral_plain(c, rhat, ev, ev)
            _pppm_compare(label, "spectral", torch.view_as_real(ek),
                          torch.view_as_real(ep), ftol, res)
            if ev:
                e_err, v_err = scalar_rel(esk, esp), rel_err(vsk, vsp)
                print(f"[PPPM] {label} spectral e/v: energy sum rel "
                      f"{e_err:.3e}, virial rel {v_err:.3e}")
                if not (e_err <= etol and v_err <= etol):
                    raise AssertionError(f"PPPM spectral {label}: energy or "
                                         f"virial off (tol {etol})")
        e_mesh = torch.fft.irfftn(ep, s=pm.grid, dim=(1, 2, 3)).to(
            flt).contiguous()
        fk = torch.stack(pppm_ops.gather(pm, st, e_mesh, n, acc, c["coef"]))
        fp = torch.stack(pppm_cells.gather_plain(pm, st, e_mesh, acc))
        _pppm_compare(label, "gather", fk, fp, ftol, res)
        if prec == "single":
            out = res
            _pppm_time(pm, st, n, c, rhat, e_mesh, acc, out)
        del sim, st, solver
        torch.cuda.empty_cache()
    return out


def _pppm_time(pm, st, n, c, rhat, e_mesh, acc, out):
    ns, ngrid = st.x.shape[0], int(np.prod(pm.grid))
    npts = int(np.prod(c["G"].shape))
    p = pm.order
    flt_size = st.x.element_size()
    slot_in = ns * plane_bytes(st.x, st.y, st.z, st.q, st.aid)
    acc_size = torch.empty((), dtype=acc).element_size()
    # deposit: the library route is index_add_ of the per-point charges
    # (indices and weights precomputed, outside the timing)
    flat, w3 = pppm_cells._stencil(pm, st, 0, ns,
                                   pppm_cells.mesh_geometry(pm))
    vals = (w3 * st.q[:, None, None, None]).reshape(-1)
    flat = flat.reshape(-1)
    mesh0 = torch.zeros(ngrid, dtype=st.x.dtype, device=st.x.device)
    rows = {
        "deposit": (
            lambda: pppm_ops.deposit(pm, st, n, c["coef"]),
            lambda: pppm_cells.deposit_plain(pm, st),
            lambda: mesh0.clone().index_add_(0, flat, vals),
            slot_in + ngrid * flt_size,
            n * (OPS_WEIGHTS(p) + p**3 * OPS_DEPOSIT_PT)),
        # spectral: force-only, as on every step but the thermo steps;
        # the library route is the plain version's torch ops
        "spectral": (
            lambda: pppm_ops.spectral(c, rhat, False),
            lambda: pppm_cells.spectral_plain(c, rhat, False, False),
            lambda: pppm_cells.spectral_plain(c, rhat, False, False),
            npts * acc_size * (2 + 1 + 6),
            npts * OPS_SPECTRAL_PT),
        "gather": (
            lambda: pppm_ops.gather(pm, st, e_mesh, n, acc, c["coef"]),
            lambda: pppm_cells.gather_plain(pm, st, e_mesh, acc),
            None,
            slot_in + 3 * ngrid * flt_size + 3 * ns * acc_size,
            n * (OPS_WEIGHTS(p) + p**3 * OPS_GATHER_PT)),
    }
    for name, (kern, plain, lib, nbytes, nops) in rows.items():
        ms, dev_ms = cuda_ms(kern), device_ms(kern)
        plain_ms = cuda_ms(plain, reps=3)
        lib_ms = cuda_ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, nops)
        out[name].update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"[PPPM] {name} f32: kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")


def phase_jittered(golden: dict, device="cuda"):
    """cristobalite_pppm.yaml in f64 on a jittered copy of its crystal,
    where forces are not zero by symmetry, against the JAX package's
    record: step-0 forces of every 360th atom and their rms, thermo rows
    at steps 0 and 10, positions at step 10.  The k-space part of the
    step-0 force is shown to be far above the force tolerance."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import gen_cristobalite

    j = golden["jittered"]
    cfg = load_deck("cristobalite_pppm.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.cristobalite_jitter")
        gen_cristobalite.write(path, *j["dims"], jitter_amp=j["amp"])
        cfg.update(read_data=path, replicate=j["replicate"],
                   precision=j["precision"])
        sim = build_simulation(cfg, device=device)
    pm = sim.kspace.pm
    if sim.n_atoms != j["n_atoms"] or list(pm.grid) != j["pppm_grid"] \
            or pm.g_ewald != j["g_ewald"]:
        raise AssertionError("jittered: atoms, mesh or g_ewald differ from "
                             "the record")
    pick = np.asarray(j["atoms"])
    f0 = sim.get_atoms()["f"]
    st = sim.state
    kf = sim.kspace.compute_slots(st, False, False)[:3]
    fk = cs.to_atoms(sim.grid, st._replace(fx=kf[0], fy=kf[1], fz=kf[2]))
    fk = fk["f"].cpu().numpy()[pick]
    rows = sim.run(j["steps"], thermo_every=j["steps"], log=False)
    at = sim.get_atoms()
    x_end = (at["x"] + at["image"] * np.asarray(sim.box.lengths))[pick]
    ref_f = np.asarray(j["f0"])
    f_tol = JITTER_TOL["f"] * np.abs(ref_f).max()
    errs = {
        "f0": float(np.abs(f0[pick] - ref_f).max()) / np.abs(ref_f).max(),
        "f0_rms": abs(float(np.sqrt(np.mean(np.sum(f0 * f0, 1))))
                      - j["f0_rms"]) / j["f0_rms"],
        "x_end": float(np.abs(x_end - np.asarray(j["x_end"])).max()),
    }
    for r, ref in zip(rows, j["rows"], strict=True):
        for k in ("temp", "evdwl", "ecoul", "elong", "etotal", "press"):
            errs[f"{k}@{ref['step']:.0f}"] = scalar_rel(r[k], ref[k])
    tol = {k: JITTER_TOL["f" if k.startswith("f0") else
                         "x" if k == "x_end" else "rows"] for k in errs}
    print(f"[jitter] {sim.n_atoms} atoms f64, mesh {pm.grid}: k-space part "
          f"of the step-0 force max {np.abs(fk).max():.4g} (force tol "
          f"{f_tol:.3g}); worst of " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()
              if k in ("f0", "f0_rms", "x_end") or k.startswith("elong")))
    bad = {k: errs[k] for k in errs if not errs[k] <= tol[k]}
    if bad or not np.abs(fk).max() > 1e3 * f_tol:
        raise AssertionError(f"jittered deck disagrees with the JAX record: "
                             f"{bad}")


def shake_violation(sim) -> float:
    """max |r^2/d^2 - 1| over the constraints of the engine's state, in
    f64 on the card (atom-order positions through the slot-of-atom map)."""
    st = sim.state
    inv = sim._inv_map(st).long()[:sim.n_atoms]
    x = torch.stack([p.double()[inv] for p in (st.x, st.y, st.z)], -1)
    return float(max_violation(sim.shake, x, sim.box.lengths))


def phase_deck(name: str, golden: dict, thermo: int, kernels: tuple,
               drift_gate, replicate=None, temp_ref=None):
    """One main path, build_simulation and sim.run as run_deck calls them:
    launch counts set to 0 just before, read just after.  drift_gate None
    (a thermostatted deck) leaves the energy drift ungated; temp_ref =
    ({step: temp}, rtol) holds the temperature of every row to a recorded
    trajectory.  With fix shake every thermo row also measures the
    constraint violation max |r^2/d^2 - 1| (``shake_violation``), gated at
    the deck's tol.  Returns the launch counts, the run's ms per step and
    the step-0 row."""
    cfg = load_deck(name)
    cfg["thermo"] = thermo
    if replicate is not None:
        cfg["replicate"] = list(replicate)
        name = f"{name} x{'x'.join(map(str, replicate))}"
    ops.reset_launches()
    sim = build_simulation(cfg, device="cuda")
    viol, probe_s = [], [0.0]
    if sim.shake is not None:
        thermo_row = sim.thermo

        def thermo_with_violation():
            row = thermo_row()
            t0 = time.perf_counter()
            viol.append(shake_violation(sim))
            probe_s[0] += time.perf_counter() - t0
            return row

        sim.thermo = thermo_with_violation
    rows = sim.run(int(cfg["run"]), thermo_every=thermo, log=False)
    ran = dict(ops.LAUNCHES)
    for k in kernels:
        if ran[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} was not launched")
    n, steps = sim.n_atoms, int(cfg["run"])
    if rows[-1]["step"] != steps or n != golden["n_atoms"]:
        raise AssertionError(f"{name}: ran {rows[-1]['step']} steps on {n} "
                             "atoms")
    ref = golden["rows"][0] if "rows" in golden else golden["row"]
    row = rows[0]
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
    if drift_gate is not None and not drift <= drift_gate:
        raise AssertionError(f"{name}: drift {drift:.3e}/atom > gate "
                             f"{drift_gate}")
    if sim.shake is not None:
        tol = next(f["tol"] for f in cfg["fixes"] if f["name"] == "shake")
        print(f"[deck] {name}: {sim.shake.n_constraints} constraints, dof "
              f"{sim.dof}; violation max|r^2/d^2 - 1| " + ", ".join(
                  f"{v:.3e} @ {r['step']}" for v, r in zip(viol, rows))
              + f" (gate {tol}); the probes took {1e3 * probe_s[0]:.1f} ms "
              "of the run")
        if len(viol) != len(rows) or not max(viol) <= tol:
            raise AssertionError(f"{name}: constraint violation {viol} over "
                                 f"the deck's tol {tol}")
    for r in rows:
        for k in ("temp", "epair", "emol", "etotal", "press"):
            if not np.isfinite(r[k]):
                raise AssertionError(f"{name}: non-finite {k}")
        if temp_ref is not None:
            want, rtol = temp_ref[0][r["step"]], temp_ref[1]
            if not abs(r["temp"] - want) <= rtol * want:
                raise AssertionError(
                    f"{name}: temp {r['temp']:.3f} K at step {r['step']}, "
                    f"record {want:.3f} K (rtol {rtol})")
    wall = sim.timings["run"]
    print(f"[deck] {name}: {n} atoms x {steps} steps in {wall:.3f} s -> "
          f"{n * steps / wall:,.0f} atom-steps/s, {1e3 * wall / steps:.4f} "
          f"ms/step (thermo every {thermo}); step-0 etotal {e0:.8g} "
          f"(record {ref['etotal']:.8g}), elong {row['elong']:.8g} (record "
          f"{ref['elong']:.8g}); drift {drift:.3e}/atom (gate {drift_gate}); "
          f"grid {sim.grid.nc} cap {sim.grid.cap} reach_z "
          f"{sim.grid.reach_z}; launches {ran}; grows {sim.grows}")
    if sim.kspace is not None:
        pm = sim.kspace.pm
        print(f"[deck] {name}: pppm mesh {pm.grid} order {pm.order} g_ewald "
              f"{pm.g_ewald:.6f} (record {tuple(golden['pppm_grid'])}, "
              f"{golden['g_ewald']:.6f})")
        # same mesh and splitting as the JAX package: elong to rounding
        if (pm.grid != tuple(golden["pppm_grid"])
                or abs(pm.g_ewald - golden["g_ewald"])
                > 1e-12 * golden["g_ewald"]):
            raise AssertionError(f"{name}: PPPM mesh or g_ewald differs "
                                 "from the record")
    if sim.kspace is not None and "elong_recip" in golden:
        recip, ref_recip = row["elong"] - pm.elong_self, golden["elong_recip"]
        print(f"[deck] {name}: step-0 elong - elong_self {recip:.6g} "
              f"(record {ref_recip:.6g}, tol rel {RECIP_TOL}); elong_self "
              f"{pm.elong_self:.10g} (record {golden['elong_self']:.10g})")
        if (abs(pm.elong_self - golden["elong_self"])
                > 1e-12 * abs(golden["elong_self"])
                or not abs(recip - ref_recip) <= RECIP_TOL * abs(ref_recip)):
            raise AssertionError(f"{name}: reciprocal part of elong off")
    if sim.bonded is not None:
        print(f"[deck] {name}: temp " + ", ".join(
            f"{r['temp']:.2f} K @ {r['step']}" for r in rows)
            + f"; step-0 evdwl {row['evdwl']:.8g} ecoul {row['ecoul']:.8g} "
            f"emol {row['emol']:.8g} (record {ref['evdwl']:.8g}, "
            f"{ref['ecoul']:.8g}, {ref['emol']:.8g})")
    return dict(launches=ran, ms_step=1e3 * wall / steps, row=row)


# ---- the molecular path: examples/data.rhodo_class ----

BIG_REPLICATE = (6, 6, 4)    # 248,832 atoms: the size the kernels are timed at
BONDED_KERNELS = ("bonded_bond_angle", "dihedral_charmm", "improper_harmonic")


def _bonded_by_kernel(b):
    """The bonded style split into one style per kernel."""
    return {
        "bonded_bond_angle": make_bonded(
            bonds=b.bonds, angles=b.angles, bond_coeffs=b.bond_coeffs,
            angle_coeffs=b.angle_coeffs, angle_style=b.angle_style),
        "dihedral_charmm": make_bonded(
            dihedrals=b.dihedrals, dihedral_coeffs=b.dihedral_coeffs,
            d14=b.d14),
        "improper_harmonic": make_bonded(
            impropers=b.impropers, improper_coeffs=b.improper_coeffs),
    }


def _bonded_work(name, b, flt_size, acc_size):
    """(bytes, operations) one launch of a bonded kernel needs: its term
    table (and the dihedrals' baked 1-4 rows) once, and once for each atom
    that its terms name the slot map entry, the position and the force's
    read and write (the atoms are shared by many terms and sit in L2)."""
    if name == "bonded_bond_angle":
        nb, na = len(b.bonds), len(b.angles)
        nub = int((b.angle_coeffs[b.angles[:, 0], 2] != 0).sum()) \
            if b.angle_coeffs.shape[1] >= 4 else 0
        table = nb * 12 + na * 16
        atoms = np.union1d(b.bonds[:, 1:], b.angles[:, 1:]).size
        nops = (nb * OPS_BONDED["bond"] + na * OPS_BONDED["angle"]
                + nub * OPS_BONDED["urey_bradley"])
    elif name == "dihedral_charmm":
        nd = len(b.dihedrals)
        table = nd * (20 + 3 * flt_size)
        atoms = np.unique(b.dihedrals[:, 1:]).size
        nops = nd * OPS_BONDED["dihedral"]
    else:
        ni = len(b.impropers)
        table = ni * 20
        atoms = np.unique(b.impropers[:, 1:]).size
        nops = ni * OPS_BONDED["improper"]
    return table + atoms * (4 + 3 * flt_size + 2 * 3 * acc_size), nops


def _bonded_compare(label, style, xs, box, inv, acc):
    """A bonded kernel against its plain version, force-only and with
    energies and virial; returns the force-only max |df|."""
    ftol, etol = TOL[xs[0].dtype]
    abs_err = 0.0
    for ev in (False, True):
        k = compute_bonded(style, xs, box, eflag=ev, acc_dtype=acc, inv=inv)
        p = compute_bonded_plain(style, xs, box, eflag=ev, acc_dtype=acc,
                                 inv=inv)
        torch.cuda.synchronize()
        fk = torch.stack([k.fx, k.fy, k.fz])
        fp = torch.stack([p.fx, p.fy, p.fz])
        ferr = rel_err(fk, fp)
        if not ev:
            abs_err = float((fk - fp).abs().max())
        msg = f"[K14] {label} ev={ev}: max|df|/max|f| {ferr:.3e}"
        ok = ferr <= ftol and float(fp.abs().max()) > 1.0
        if ev:
            errs = {"virial": rel_err(k.virial, p.virial)}
            for name in ("ebond", "eangle", "edihed", "eimp", "e14_lj",
                         "e14_coul"):
                ref = float(getattr(p, name))
                if ref != 0.0:
                    errs[name] = scalar_rel(getattr(k, name), ref)
                elif float(getattr(k, name)) != 0.0:
                    errs[name] = float("inf")
            msg += "".join(f", {n} rel {e:.3e}" for n, e in errs.items())
            ok = ok and len(errs) > 1 and all(e <= etol
                                              for e in errs.values())
        print(msg)
        if not ok:
            raise AssertionError(f"K14 {label} disagrees with its plain "
                                 f"version (tol {ftol}, {etol})")
    return abs_err


VERLET_KERNELS = ("verlet_kick_drift", "verlet_kick", "verlet_ke")
# K3's kernels against their plain versions: kick_drift and kick round
# like the plain version (no FMA contraction): 1e-6 of the largest value
# in f32, 1e-14 in f64; the kinetic sum and the chain (expf against
# torch.exp, another order of summation): rel 1e-5 in f32, 1e-11 in f64
TOL_K3 = {torch.float32: (1e-6, 1e-5), torch.float64: (1e-14, 1e-11)}


def _clone(planes):
    return tuple(p.clone() for p in planes)


def _verlet_compare(label, sim, st):
    """The four integrator kernels against their plain versions on a
    deck's state: one NVT step's worth of updates, each from the same
    planes.  Returns max abs errors by kernel and the inputs."""
    from lammps_buck_intel_tpu_torch.integrate import nve, nvt

    acc, n = sim.precision.acc, sim.n_atoms
    tol, stol = TOL_K3[st.x.dtype]
    rng = np.random.default_rng(SEED + 4)
    occ = st.aid < n

    def forces(scale):   # acc-typed planes, zero on the empty slots
        return tuple(torch.where(occ, torch.as_tensor(
            rng.normal(size=st.x.shape[0]) * scale).to(st.x.device, acc), 0)
            for _ in range(3))

    fa, fb = forces(20.0), forces(3.0)
    xs, vs, fs = (st.x, st.y, st.z), (st.vx, st.vy, st.vz), (st.fx, st.fy,
                                                             st.fz)
    tail = (st.typ, st.aid, sim._minv_t)
    cfg = nvt.NVTConfig(t_start=300.0, t_stop=300.0, t_damp=50.0, tchain=3,
                        dof=3 * n - 3, boltz=sim.units.boltz,
                        mvv2e=sim.units.mvv2e, dt=sim.dt)
    therm = torch.zeros((2, 3), dtype=st.x.dtype, device=st.x.device)
    therm[0], therm[1] = 0.02, 1.5e-3
    errs = {}

    def close(name, k, p, t):
        k, p = torch.stack(list(k)), torch.stack(list(p))
        err = rel_err(k, p)
        errs[name] = max(errs.get(name, 0.0), float((k - p).abs().max()))
        if not err <= t:
            raise AssertionError(f"K3 {name} {label} disagrees with its "
                                 f"plain version: {err:.3e} (tol {t})")
        return err

    kx, kv, kf = _clone(xs), _clone(vs), _clone(fs)
    px, pv, pf = _clone(xs), _clone(vs), _clone(fs)
    nve.kick_drift(kx, kv, kf, *tail, n, sim.dtf, sim.dtv)
    nve.kick_drift_plain(px, pv, pf, *tail, n, sim.dtf, sim.dtv)
    e1 = max(close("verlet_kick_drift", kx, px, tol),
             close("verlet_kick_drift", kv, pv, tol))
    if torch.equal(torch.stack(kx), torch.stack(xs)):
        raise AssertionError(f"K3 {label}: the drift moved nothing")
    kp = nve.kick(kv, kf, fa, fb, *tail, sim._mass_t, n, sim.dtf, acc,
                  ke=True)
    pp = nve.kick_plain(pv, pf, fa, fb, *tail, sim._mass_t, n, sim.dtf, acc,
                        True)
    e2 = max(close("verlet_kick", kv, pv, tol),
             close("verlet_kick", kf, pf, tol))
    kk = nve.kinetic(kv, st.typ, st.aid, sim._mass_t, n, acc)
    e3 = 0.0
    for name, part in (("verlet_kick", kp), ("verlet_ke", kk)):
        e3 = max(e3, close(name, [part[:, 0].sum()], [pp[:, 0].sum()], stol),
                 close(name, [part[:, 1].max()], [pp[:, 1].max()], stol))
    kt = nvt.nhc_scale(cfg, therm, kv, kk, 310.0)
    pt = nvt.nhc_scale_plain(cfg, therm, pv, pp, 310.0)
    e4 = max(close("nhc_scale", kt, pt, stol),
             close("nhc_scale", kv, pv, stol))
    if rel_err(pt, therm) < 1e-3:
        raise AssertionError(f"K3 {label}: the chain did not move")
    print(f"[K3] {label}: kick_drift {e1:.3e}, kick {e2:.3e}, kinetic sums "
          f"{e3:.3e}, nhc_scale {e4:.3e} (tol {tol}, {stol})")
    return errs, dict(xs=kx, vs=kv, fs=kf, fa=fa, fb=fb, tail=tail, cfg=cfg,
                      therm=kt, part=kk)


def _verlet_time(sim, st, errs, w):
    """f32 times of the integrator kernels at the state's size, and their
    bounds: the aid plane read once, and per atom the planes each kernel
    reads and writes."""
    from lammps_buck_intel_tpu_torch.integrate import nve, nvt

    acc, n, ns = sim.precision.acc, sim.n_atoms, st.x.shape[0]
    flt = st.x.element_size()
    accs = torch.empty((), dtype=acc).element_size()
    xs, vs, fs, fa, fb, tail = (w[k] for k in ("xs", "vs", "fs", "fa", "fb",
                                               "tail"))
    mass_t, cfg = sim._mass_t, w["cfg"]
    rows = {
        "verlet_kick_drift": (
            lambda: nve.kick_drift(xs, vs, fs, *tail, n, sim.dtf, sim.dtv),
            lambda: nve.kick_drift_plain(xs, vs, fs, *tail, n, sim.dtf,
                                         sim.dtv),
            ns * 4 + n * (15 * flt + 4)),
        "verlet_kick": (
            lambda: nve.kick(vs, fs, fa, fb, *tail, mass_t, n, sim.dtf, acc),
            lambda: nve.kick_plain(vs, fs, fa, fb, *tail, mass_t, n, sim.dtf,
                                   acc, False),
            ns * 4 + n * (6 * accs + 9 * flt + 4)),
        "verlet_ke": (
            lambda: nve.kinetic(vs, tail[0], tail[1], mass_t, n, acc),
            lambda: nve.kinetic_plain(vs, tail[0], tail[1], mass_t, n, acc),
            ns * 4 + n * (3 * flt + 4)),
        "nhc_scale": (
            lambda: nvt.nhc_scale(cfg, w["therm"], vs, w["part"], 310.0),
            lambda: nvt.nhc_scale_plain(cfg, w["therm"], vs, w["part"],
                                        310.0),
            n * 6 * flt + w["part"].numel() * accs),
    }
    out = {}
    for name, (kern, plain, nbytes) in rows.items():
        ms, dev_ms = cuda_ms(kern), device_ms(kern)
        plain_ms = cuda_ms(plain, reps=5)
        b_ms, b_by = bound(nbytes, 0)
        print(f"[K3] {name} f32: kernel {ms:.4f} ms (device {dev_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}; "
              f"{nbytes:,} bytes)")
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=errs[name])
    return out


def _buck_special(style, coul: bool):
    """A Buckingham style for the rhodo box folded to two types, with the
    deck's special factors: the kernel's buck and buck/coul/long variants
    with a partner table, which no deck runs yet."""
    buck = build_buck(2, {(0, 0): (9.0e4, 0.28, 600.0),
                          (0, 1): (2.5e4, 0.27, 150.0),
                          (1, 1): (4.0e3, 0.26, 30.0)}, cut_global=10.0,
                      shift=True, coul="long" if coul else "none",
                      qqrd2e=style.qqrd2e)
    buck = buck.replace(special_lj=style.special_lj,
                        special_coul=style.special_coul)
    return buck.replace(g_ewald=style.g_ewald) if coul else buck


def phase_rhodo_kernels():
    """K1's lj/charmm + special-bond variant, the three bonded kernels and
    the integrator kernels against their plain versions on
    rhodo_flex_nve.yaml's state, f32 and f64: at the decks' own replicate
    [3, 3, 2] (grid 13x13x8; there also K1's buck variants with the partner
    table), and at replicate [6, 6, 4], where the f32 kernels are timed."""
    cfg = load_deck("rhodo_flex_nve.yaml")
    out = {}
    for replicate in (tuple(cfg["replicate"]), BIG_REPLICATE):
        timed = replicate == BIG_REPLICATE
        for prec in ("single", "double"):
            sim = build_simulation(dict(cfg, precision=prec,
                                        replicate=list(replicate)),
                                   device="cuda")
            _rhodo_kernels_at(sim, prec, replicate,
                              out if timed and prec == "single" else None)
            del sim
            torch.cuda.empty_cache()
    return out


def _rhodo_kernels_at(sim, prec, replicate, out):
    st, acc = sim.state, sim.precision.acc
    if sim.special is None or sim.pair.cfg.vdw != "ljcharmm":
        raise AssertionError("rhodo: no special table or not lj/charmm")
    label = f"rhodo x{'x'.join(map(str, replicate))}/{prec}"
    err = _k1_compare(label, sim.pair, sim.grid, sim.box, st, acc,
                      special=sim.special)
    # the specials matter: without the table the forces are far off
    with_sp = compute_cellpair(sim.pair, sim.grid, sim.box, st,
                               acc_dtype=acc, special=sim.special)
    without = compute_cellpair(sim.pair, sim.grid, sim.box, st,
                               acc_dtype=acc)
    if not float((with_sp.fx - without.fx).abs().max()) > 1.0:
        raise AssertionError("rhodo: the special table changes nothing")
    if out is None and replicate != BIG_REPLICATE:
        st2 = st._replace(typ=st.typ % 2)
        for coul in (False, True):
            _k1_compare(f"buck{'/coul/long' if coul else ''} + specials "
                        f"{label}", _buck_special(sim.pair, coul), sim.grid,
                        sim.box, st2, acc, special=sim.special)
    if out is not None:
        out["cellpair_ljcharmm"] = dict(
            _k1_time("rhodo", sim, st), max_abs_err=err)
        print(f"[K1] rhodo: {sim.n_atoms} atoms, special width "
              f"{sim.special.width}")
    xs, inv = (st.x, st.y, st.z), sim._inv_map(st)
    b = sim.bonded
    if prec == "single":
        print(f"[K14] {sim.n_atoms} atoms: {len(b.bonds)} bonds, "
              f"{len(b.angles)} angles, {len(b.dihedrals)} dihedrals, "
              f"{len(b.impropers)} impropers")
    for name, sub in _bonded_by_kernel(b).items():
        err = _bonded_compare(f"{name} {label}", sub, xs, sim.box, inv, acc)
        if out is None:
            continue
        planes = tuple(torch.zeros_like(st.x, dtype=acc) for _ in range(3))

        def kern(sub=sub, planes=planes):
            return compute_bonded(sub, xs, sim.box, eflag=False,
                                  acc_dtype=acc, inv=inv, out=planes)

        ms, dev_ms = cuda_ms(kern), device_ms(kern)
        plain = cuda_ms(lambda sub=sub: compute_bonded_plain(
            sub, xs, sim.box, eflag=False, acc_dtype=acc, inv=inv),
            reps=3)
        nbytes, nops = _bonded_work(
            name, sub, st.x.element_size(),
            torch.empty((), dtype=acc).element_size())
        b_ms, b_by = bound(nbytes, nops)
        print(f"[K14] {name} f32 force-only: kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f}), plain {plain:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}; {nbytes:,} bytes, {nops:,} operations)")
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    errs, work = _verlet_compare(label, sim, st)
    if out is not None:
        out.update(_verlet_time(sim, st, errs, work))


def phase_rhodo_record(golden: dict, which: str, tols=None):
    """A rhodo deck in f64 on one copy of the data file (1,728 atoms,
    every term non-zero) against the JAX package's f64 record: step-0
    forces of every 4th atom and their rms, the thermo rows at steps 0 and
    10, positions at step 10, the thermostat chain and, with fix shake,
    the constraint count, the degrees of freedom and the violation at step
    10.  tols: {"rows", "f", "x"[, "violation"]}, JITTER_TOL by default."""
    tols = tols or JITTER_TOL
    rec = golden["f64"][which]
    cfg = load_deck(rec["deck"])
    cfg.update(replicate=[1, 1, 1], precision=rec["precision"])
    ops.reset_launches()
    sim = build_simulation(cfg, device="cuda")
    pm = sim.kspace.pm
    if sim.n_atoms != rec["n_atoms"] or list(pm.grid) != rec["pppm_grid"] \
            or pm.g_ewald != rec["g_ewald"]:
        raise AssertionError(f"{rec['deck']} f64: atoms, mesh or g_ewald "
                             "differ from the record")
    pick = np.asarray(rec["atoms"])
    f0 = sim.get_atoms()["f"]
    rows = sim.run(rec["steps"], thermo_every=rec["steps"], log=False)
    at = sim.get_atoms()
    x_end = (at["x"] + at["image"] * np.asarray(sim.box.lengths))[pick]
    ref_f = np.asarray(rec["f0"])
    errs = {
        "f0": float(np.abs(f0[pick] - ref_f).max()) / np.abs(ref_f).max(),
        "f0_rms": abs(float(np.sqrt(np.mean(np.sum(f0 * f0, 1))))
                      - rec["f0_rms"]) / rec["f0_rms"],
        "x_end": float(np.abs(x_end - np.asarray(rec["x_end"])).max()),
    }
    tol = {"f0": tols["f"], "f0_rms": tols["f"], "x_end": tols["x"]}
    for r, ref in zip(rows, rec["rows"], strict=True):
        for k in ("temp", "evdwl", "ecoul", "elong", "emol", "etotal",
                  "press"):
            errs[f"{k}@{ref['step']:.0f}"] = scalar_rel(r[k], ref[k])
            tol[f"{k}@{ref['step']:.0f}"] = tols["rows"]
    if "therm" in rec:
        ref_t = np.asarray(rec["therm"])
        errs["therm"] = float(np.abs(sim.state.therm.cpu().numpy()
                                     - ref_t).max()) / np.abs(ref_t).max()
        tol["therm"] = tols["rows"]
    path = ("cellpair",) + BONDED_KERNELS + VERLET_KERNELS + (
        ("nhc_scale",) if "therm" in rec else ())
    if "n_constraints" in rec:
        if (sim.shake.n_constraints, sim.dof) != (rec["n_constraints"],
                                                  rec["dof"]):
            raise AssertionError(f"{rec['deck']} f64: constraints or degrees "
                                 "of freedom differ from the record")
        errs["violation"] = shake_violation(sim)
        tol["violation"] = tols["violation"]
        path += SHAKE_KERNELS
    ran = dict(ops.LAUNCHES)
    print(f"[record] {rec['deck']} f64, {sim.n_atoms} atoms, mesh {pm.grid}: "
          f"worst thermo {max(v for k, v in errs.items() if '@' in k):.3e}, "
          + ", ".join(f"{k} {errs[k]:.3e}" for k in errs if "@" not in k)
          + f"; launches {ran}")
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    if bad or any(ran[k] <= 0 for k in path):
        raise AssertionError(f"{rec['deck']} f64 disagrees with the JAX "
                             f"record: {bad}")


def phase_rhodo_decks(golden: dict):
    """The two flexible rhodo decks in full, then the NVE deck at
    replicate [6, 6, 4]; returns that run's launch counts and ms/step."""
    path = ("cellpair", "rebin_incremental", "rebin", "pppm_deposit",
            "pppm_spectral", "pppm_gather") + BONDED_KERNELS + VERLET_KERNELS
    deck = dict(golden["full"]["3x3x2"], drift_gate=golden["drift_gate"])
    print(f"[deck] rhodo: drift gate {golden['drift_gate']:.4e} kcal/mol "
          f"per atom ({golden['drift_gate_rule']}; the JAX package's own "
          f"f32 run of 1,728 atoms drifted "
          f"{golden['single']['drift_per_atom']:.4e}); the scaled row is "
          f"within {max(golden['single']['cross_check_2x1x1'].values()):.2e} "
          "of a real two-copy run")
    phase_deck("rhodo_flex_nve.yaml", deck, 50, path, golden["drift_gate"])
    # NVT starts from the data file's 239 K (3N - 3 degrees of freedom
    # without SHAKE) and is pulled towards 300 K with a 50 fs damping
    # time.  The replicated box repeats the one-copy trajectory and the
    # kinetic energy per atom is intensive, so every row is held to the
    # JAX package's own f32 NVT run of one copy, its temperature moved
    # from 3 n - 3 to 3 N - 3 degrees of freedom
    rec = golden["single_nvt"]
    n1, n_full = rec["n_atoms"], deck["n_atoms"]
    dof = (3 * n1 - 3) / (3 * n1) * (3 * n_full) / (3 * n_full - 3)
    print(f"[deck] rhodo NVT: temperature of each row against the JAX "
          f"package's f32 run of {rec['n_atoms']} atoms, "
          + ", ".join(f"{r['temp']:.3f} K @ {r['step']:.0f}"
                      for r in rec["rows"])
          + f" (rtol {golden['nvt_temp_rtol']}: "
          f"{golden['nvt_temp_rtol_rule']})")
    nvt = phase_deck(
        "rhodo_flex_nvt.yaml", deck, 50, path + ("nhc_scale",), None,
        temp_ref=({int(r["step"]): dof * r["temp"] for r in rec["rows"]},
                  golden["nvt_temp_rtol"]))
    big = dict(golden["full"]["x".join(map(str, BIG_REPLICATE))],
               drift_gate=golden["drift_gate"])
    big = phase_deck("rhodo_flex_nve.yaml", big, 50, path,
                     golden["drift_gate"], replicate=BIG_REPLICATE)
    big["launches"]["nhc_scale"] = nvt["launches"]["nhc_scale"]
    return big


# ---- SHAKE/RATTLE (K13): the literal rhodo decks ----

SHAKE_KERNELS = ("shake_ref", "shake_positions", "rattle_velocities",
                 "shake_virial")
# K13 against its plain version, same inputs on the card.  csrc/shake.cu is
# built without FMA contraction, so the two round alike and differ only
# where a sum runs in another order.  f64: rel 1e-12 of each output's
# magnitude.  f32: bond vectors and virial rel 1e-5; positions within 4 ulp
# of the box length (the largest coordinate); velocities within 4 ulp of
# the box length over dt, plus rel 1e-5 (v += (x_fix - x_new) / dt turns one
# ulp of a position into that much velocity).
TOL_K13 = {torch.float64: 1e-12, torch.float32: 1e-5}
SHAKE_RECORD_TOL = {"rows": 1e-10, "f": 1e-10, "x": 1e-10, "violation": 1e-10}


def _shake_molecule(kind):
    """(local positions, constraints, masses): a C-H bond (C = 1), a rigid
    water (C = 3), an octahedron held by its 12 edges (C = 12, A = 6)."""
    if kind == "ch":
        return (np.array([[0.0, 0, 0], [1.09, 0, 0]]), [(0, 1)],
                [12.011, 1.008])
    if kind == "water":
        return (np.array([[0.0, 0, 0], [0.96, 0.3, 0], [-0.3, 0.96, 0]]),
                [(0, 1), (0, 2), (1, 2)], [15.999, 1.008, 1.008])
    oct6 = np.array([[1.0, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                     [0, 0, 1], [0, 0, -1]])
    edges = [(i, j) for i in range(6) for j in range(i + 1, 6)
             if abs((oct6[i] * oct6[j]).sum()) < 0.5]
    return oct6, edges, [12.0] * 6


def _shake_synthetic(kind, flt, acc, copies=2000, L=60.0):
    """Rotated copies of one cluster kind in a periodic box, in slot
    layout with empty slots: (tables, slot map, L, planes)."""
    rng = np.random.default_rng(SEED + 5)
    xl0, cons, m = _shake_molecule(kind)
    k = len(xl0)
    pairs, d2, x = [], [], []
    for c in range(copies):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        xl = xl0 @ q.T + rng.uniform(0, L, 3)
        pairs += [(c * k + i, c * k + j) for i, j in cons]
        d2 += [float(((xl[i] - xl[j]) ** 2).sum()) for i, j in cons]
        x.append(xl)
    x = np.concatenate(x)
    n = len(x)
    sc = shake.ShakeConstraints(pairs=np.asarray(pairs, np.int32),
                                d2=np.asarray(d2),
                                invm=1.0 / np.tile(m, copies), iters=30)
    ns = n + n // 3
    slot = rng.permutation(ns)[:n]
    empty = np.setdiff1d(np.arange(ns), slot)
    inv = torch.as_tensor(np.append(slot, empty[-1]).astype(np.int32),
                          device="cuda")

    def planes(a, dt, fill=0.0):
        p = np.full((ns, 3), fill)
        p[slot] = a
        return tuple(torch.as_tensor(p[:, c].copy()).to("cuda", dt)
                     for c in range(3))

    xn = x + 0.05 * rng.normal(size=x.shape)
    return (shake.make_clusters(sc).tables_on("cuda", flt), inv,
            np.full(3, L), planes(x % L, flt, 7.0), planes(xn % L, flt, 7.0),
            planes(0.1 * rng.normal(size=x.shape), flt),
            planes(30.0 * rng.normal(size=x.shape), acc),
            planes(3.0 * rng.normal(size=x.shape), acc))


def _k13_compare(label, t, inv, L, xo, xn, vs, fa, fb, dt, iters, ftm2v,
                 acc):
    """The four constraint kernels against their plain versions on the
    same planes; returns max abs errors by kernel and the work tensors."""
    flt = xo[0].dtype
    tol = TOL_K13[flt]
    ulp = float(torch.finfo(flt).eps) * float(max(L))
    xtol, vtol = (0.0, 0.0) if flt == torch.float64 else (4 * ulp,
                                                          4 * ulp / dt)
    errs = {}

    def close(name, k, p, abs_tol=0.0):
        k, p = torch.stack(list(k)), torch.stack(list(p))
        d = float((k - p).abs().max())
        errs[name] = max(errs.get(name, 0.0), d)
        scale = float(p.abs().max())
        if not d <= tol * scale + abs_tol or scale == 0.0:
            raise AssertionError(f"K13 {name} {label} disagrees with its "
                                 f"plain version: {d:.3e} (tol {tol} of "
                                 f"{scale:.3e} + {abs_tol:.3e})")
        return d / scale

    ro_k = shake.shake_ref(t, xo, inv, L)
    ro_p = shake.shake_ref_plain(t, xo, inv, L)
    e = {"ref": close("shake_ref", ro_k, ro_p)}
    kx, kv, px, pv = _clone(xn), _clone(vs), _clone(xn), _clone(vs)
    rn_k = shake.shake_positions(t, ro_k, kx, kv, inv, L, dt, iters)
    rn_p = shake.shake_positions_plain(t, ro_p, px, pv, inv, L, dt, iters)
    e["rn"] = close("shake_positions", rn_k, rn_p)
    e["x"] = close("shake_positions", kx, px, xtol)
    e["v"] = close("shake_positions", kv, pv, vtol)
    shake.rattle_velocities(t, kv, inv, L, r=rn_k)
    shake.rattle_velocities_plain(t, pv, inv, L, r=rn_p)
    e["rattle"] = close("rattle_velocities", kv, pv, vtol)
    for part in ((fa, None), (fa, fb)):
        wk = shake.shake_virial(t, kx, kv, *part, inv, L, ftm2v, acc)
        wp = shake.shake_virial_plain(t, px, pv, *part, inv, L, ftm2v, acc)
        e["virial"] = close("shake_virial", [wk], [wp])
    print(f"[K13] {label}: " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
          + f" (rel; tol {tol}, x +{xtol:.2e}, v +{vtol:.2e})")
    return errs, dict(ro=ro_k, rn=rn_k, xs=kx, vs=kv)


def _k13_work(t, inv, flt, acc, iters):
    """(bytes, operations) by kernel for one launch on these tables: the
    tables once; per real atom its slot-map entry and the planes the
    kernel reads and writes; per real constraint its bond vectors.
    Operations counted per constraint (minimum image 4 per component, the
    Newton iteration's residual, Jacobian, solve and update) for the
    clusters' width C."""
    fs = torch.empty((), dtype=flt).element_size()
    accs = torch.empty((), dtype=acc).element_size()
    C, M = t["pi"].shape
    A = t["atoms"].shape[0]
    na = int((t["atoms"] >= 0).sum())
    nc = int((t["pi"] >= 0).sum())
    idx = 4 * (A * M + 2 * C * M) + 4 * na
    coup = (C * nc + na) * fs                # K rows, 1/m
    solve = M * (7 * C * C + 12 * C + (2 * C ** 3) // 3 + 2)
    nbytes = {
        "shake_ref": idx + 3 * na * fs + 3 * C * M * fs,
        "shake_positions": idx + coup + nc * fs + 12 * na * fs
        + 3 * nc * fs + 3 * C * M * fs,
        "rattle_velocities": idx + coup + 6 * na * fs + 3 * nc * fs,
        "shake_virial": idx + coup + 6 * na * fs + 6 * na * accs,
    }
    nops = {"shake_ref": 15 * nc,
            "shake_positions": 15 * nc + min(iters, 4) * (solve + 9 * nc)
            + 12 * nc + 9 * na,
            "rattle_velocities": solve + 21 * nc + 3 * na,
            "shake_virial": solve + 49 * nc + 9 * na}
    return nbytes, nops


def _k13_time(label, t, inv, L, xo, xn, vs, fa, fb, dt, iters, ftm2v, acc,
              errs):
    """Times of the four kernels (CUDA events, profiler) and of their plain
    versions at these shapes, with their bounds."""
    work = _k13_work(t, inv, xo[0].dtype, acc, iters)
    ro = shake.shake_ref(t, xo, inv, L)
    kx, kv = _clone(xn), _clone(vs)
    rn = shake.shake_positions(t, ro, kx, kv, inv, L, dt, iters)
    rows = {
        "shake_ref": (lambda: shake.shake_ref(t, xo, inv, L),
                      lambda: shake.shake_ref_plain(t, xo, inv, L)),
        # in place: the constraints already hold, the work is the same
        "shake_positions": (
            lambda: shake.shake_positions(t, ro, kx, kv, inv, L, dt, iters),
            lambda: shake.shake_positions_plain(t, ro, kx, kv, inv, L, dt,
                                                iters)),
        "rattle_velocities": (
            lambda: shake.rattle_velocities(t, kv, inv, L, r=rn),
            lambda: shake.rattle_velocities_plain(t, kv, inv, L, r=rn)),
        "shake_virial": (
            lambda: shake.shake_virial(t, kx, kv, fa, fb, inv, L, ftm2v, acc),
            lambda: shake.shake_virial_plain(t, kx, kv, fa, fb, inv, L,
                                             ftm2v, acc)),
    }
    out = {}
    for name, (kern, plain) in rows.items():
        ms, dev_ms = cuda_ms(kern), device_ms(kern)
        plain_ms = cuda_ms(plain, reps=5)
        b_ms, b_by = bound(work[0][name], work[1][name])
        print(f"[K13] {name} {label}: kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}; {work[0][name]:,} bytes, {work[1][name]:,} "
              "operations)")
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=errs[name],
                         library_ms=None)
    return out


def phase_shake_kernels():
    """K13a-d against their plain versions on the card: synthetic clusters
    with C = 1, 3 and 12 in f32 and f64, then the rhodo clusters of
    rhodo_nve.yaml's state (one C-H bond each) at the deck's 31,104 atoms
    and at 248,832, where the f32 kernels are timed."""
    for kind in ("ch", "water", "octahedron"):
        for flt, acc in ((torch.float32, torch.float64),
                         (torch.float64, torch.float64)):
            t, inv, L, xo, xn, vs, fa, fb = _shake_synthetic(kind, flt, acc)
            _k13_compare(f"{kind} C={t['pi'].shape[0]} {flt}", t, inv, L, xo,
                         xn, vs, fa, fb, 0.7, 30, 4.184e-4, acc)
    cfg = load_deck("rhodo_nve.yaml")
    out = {}
    for replicate in (tuple(cfg["replicate"]), BIG_REPLICATE):
        for prec in ("single", "double"):
            sim = build_simulation(dict(cfg, precision=prec,
                                        replicate=list(replicate)),
                                   device="cuda")
            st, acc, t = sim.state, sim.precision.acc, sim._shake_t
            inv, L = sim._inv_map(st), sim.box.lengths
            xo = (st.x, st.y, st.z)
            # one step's drift, and the step's forces for the virial
            xn = tuple(x + sim.dtv * v for x, v in zip(xo, (st.vx, st.vy,
                                                            st.vz)))
            fa, fb, *_ = sim._forces(st, False, False)
            sim._bonded_forces(st, inv, fa, False)
            label = f"rhodo x{'x'.join(map(str, replicate))}/{prec}"
            errs, _ = _k13_compare(label, t, inv, L, xo, xn, _clone(
                (st.vx, st.vy, st.vz)), fa, fb, sim.dtv, sim.shake.iters,
                sim.units.ftm2v, acc)
            if replicate == BIG_REPLICATE and prec == "single":
                print(f"[K13] {label}: {sim.shake.n_constraints} constraints "
                      f"in {t['pi'].shape[1]} clusters of "
                      f"{t['pi'].shape[0]}")
                out = _k13_time(label, t, inv, L, xo, xn, _clone(
                    (st.vx, st.vy, st.vz)), fa, fb, sim.dtv, sim.shake.iters,
                    sim.units.ftm2v, acc, errs)
            del sim, st, xn, fa, fb
            torch.cuda.empty_cache()
    return out


def phase_shake_decks(rec: dict):
    """The literal rhodo decks in full: rhodo_nve.yaml (31,104 atoms, NVE +
    shake) against the JAX package's record long_rhodo_nve.json (step 0 at
    the _STEP0_FIELDS tolerances, its drift gate), rhodo_32k.yaml (NVT +
    shake) against the JAX package's own f32 run of one copy, every row's
    temperature; then rhodo_nve.yaml at replicate [6, 6, 4] (248,832
    atoms) against the one-copy row scaled to 144 copies.  Every thermo
    row holds the constraints to the decks' tol.  Returns the big run's
    launch counts and ms/step."""
    path = ("cellpair", "rebin_incremental", "rebin", "pppm_deposit",
            "pppm_spectral", "pppm_gather") + BONDED_KERNELS \
        + VERLET_KERNELS + SHAKE_KERNELS
    full = rec["full"]["3x3x2"]
    nve_rec = load_golden("long_rhodo_nve.json")
    gate = nve_rec["drift_gate"]
    # the record holds rows only: the mesh and splitting of the same box
    # come from the JAX host set-up recorded beside the scaled row
    deck = dict(nve_rec, pppm_grid=full["pppm_grid"],
                g_ewald=full["g_ewald"])
    print(f"[deck] rhodo shake: long_rhodo_nve.json step 0 temp "
          f"{nve_rec['rows'][0]['temp']:.6g} (the one-copy f32 row scaled: "
          f"{full['row']['temp']:.6g}); drift gate {gate} kcal/mol per atom "
          f"(the record drifted {nve_rec['drift_per_atom']:.4e}; the JAX "
          f"f32 run of 1,728 atoms {rec['single']['drift_per_atom']:.4e})")
    phase_deck("rhodo_nve.yaml", deck, 50, path, gate)
    nvt_rec = load_golden("long_rhodo_32k.json")
    one = rec["single_nvt"]
    ts = full["temp_scale"]
    print(f"[deck] rhodo_32k NVT: temperature of each row against the JAX "
          f"package's f32 run of {one['n_atoms']} atoms moved to "
          f"{full['dof']} degrees of freedom (x {ts:.6f}): " + ", ".join(
              f"{ts * r['temp']:.3f} K @ {r['step']:.0f}" for r in one["rows"])
          + f" (rtol {rec['nvt_temp_rtol']}); long_rhodo_32k.json: "
          + ", ".join(f"{r['temp']:.3f} K @ {r['step']:.0f}"
                      for r in nvt_rec["rows"]))
    nvt = phase_deck(
        "rhodo_32k.yaml", dict(nvt_rec, pppm_grid=full["pppm_grid"],
                               g_ewald=full["g_ewald"]), 50,
        path + ("nhc_scale",), None,
        temp_ref=({int(r["step"]): ts * r["temp"] for r in one["rows"]},
                  rec["nvt_temp_rtol"]))
    big_rec = dict(rec["full"]["x".join(map(str, BIG_REPLICATE))])
    big = phase_deck("rhodo_nve.yaml", big_rec, 50, path, gate,
                     replicate=BIG_REPLICATE)
    big["launches"]["nhc_scale"] = nvt["launches"]["nhc_scale"]
    return big


# ---- fix npt on the neighbor-list engine (K9, K16): rhodo_npt.yaml ----

NPT_KERNELS = ("nlist_build", "nlist_pair", "traced_greens", "npt_ke3",
               "npt_vscale_kick", "npt_drift_dilate")
NPT_PATH = NPT_KERNELS + ("pppm_deposit", "pppm_spectral", "pppm_gather") \
    + BONDED_KERNELS + ("verlet_kick", "verlet_ke", "nhc_scale")
NPT_SHAKE = ("shake_ref", "shake_positions", "rattle_velocities")
# f64 on one copy against the JAX package's f64 record: the CPU parity
# tolerance of tests/test_torch_npt.py for rows, boxL, omega_dot, the
# chain and forces; positions in A (their magnitude ~50 A)
NPT_RECORD_TOL = {"rows": 1e-10, "f": 1e-10, "x": 1e-8}
# per list entry of the pair pass: the difference and its minimum image
# 17 (3 subtractions, per axis multiply, rint, multiply, subtract), rsq
# and the cut tests; inside the cutoff the lj/charmm + coul/long terms
# (OPS_PAIR less the other atom's force) and the force and virial sums 15
OPS_LIST_ENTRY = 22
OPS_LIST_PAIR = OPS_PAIR[("ljcharmm", "long")] - 9 + 15
# per candidate of the build: difference, minimum image by division (4
# per axis), rsq 5, the compare
OPS_BUILD_CAND = 21
# per mesh point of the influence function: per alias term kmx..kmz 3,
# kmsq 5, the Green's function 4 and an exp, k . k_m 5, the product 4
OPS_GREENS_TERM = 22


def _npt_state(cfg, prec, replicate, stretch=(1.0, 1.0, 1.01)):
    """A rhodo_npt.yaml engine on the card and a box stretched about its
    centre (positions with it), so the kernels read lengths that no host
    constant holds."""
    sim = build_simulation(dict(cfg, precision=prec,
                                replicate=list(replicate)), device="cuda")
    st = sim.state
    s = torch.as_tensor(stretch).to(st.boxL)
    c = torch.as_tensor(sim._center).to(st.boxL)
    x = (c[:, None] + (st.x - c[:, None]) * s[:, None]).contiguous()
    return sim, x, st.boxL * s


def _build_candidates(sim, nl_spec, x, boxL):
    """Candidates the build tests: sum over cells of count(c) times the
    atoms of its 27-cell stencil."""
    from lammps_buck_intel_tpu_torch.core.box import traced_lo

    nc = nl_spec.nc
    lo = traced_lo(sim._center, boxL)
    s = (x - lo[:, None]) / boxL[:, None]
    s = s - torch.floor(s)
    ncs = torch.tensor(nc, device=x.device)
    ci = torch.minimum((s * ncs[:, None].to(s.dtype)).long(),
                       ncs[:, None] - 1)
    cid = (ci[0] * nc[1] + ci[1]) * nc[2] + ci[2]
    count = torch.bincount(cid, minlength=int(np.prod(nc))).view(nc)
    total = torch.zeros_like(count)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                total += torch.roll(count, (dx, dy, dz), (0, 1, 2))
    return int((count * total).sum()) - x.shape[1]


def _npt_compare(label, name, k, p, tol, errs):
    k = k if isinstance(k, torch.Tensor) else torch.stack(list(k))
    p = p if isinstance(p, torch.Tensor) else torch.stack(list(p))
    d = float((k.double() - p.double()).abs().max())
    scale = float(p.double().abs().max())
    errs[name] = max(errs.get(name, 0.0), d)
    ok = d <= tol * scale and scale > 0.0
    print(f"[NPT] {label} {name}: max|d| {d:.3e} of {scale:.3e} "
          f"(tol {tol:g} rel)")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its plain "
                             "version")


def _npt_kernels_at(sim, x, boxL, label, time_it):
    """Every kernel of the NPT path against its plain version on the card,
    on this state; with time_it the f32 times and bounds."""
    from lammps_buck_intel_tpu_torch.core.box import traced_lo
    from lammps_buck_intel_tpu_torch.integrate import npt as npt_mod
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_npt
    from lammps_buck_intel_tpu_torch.models.pair import driver
    from lammps_buck_intel_tpu_torch.neighbor import neighbor_list as nlm

    flt, acc, dev = x.dtype, sim.precision.acc, x.device
    ftol, etol = TOL[flt]
    n = sim.n_atoms
    errs, work, fns = {}, {}, {}
    lo = traced_lo(sim._center, boxL)
    # K9a: the same lists (exact: both keep the candidates in scan order)
    nk = nlm.build_cell(x, lo, boxL, sim.spec, sim._special)
    npl = nlm.build_cell_plain(x, lo, boxL, sim.spec, sim._special)
    torch.cuda.synchronize()
    same = (torch.equal(nk.idx, npl.idx) and torch.equal(nk.sb, npl.sb)
            and torch.equal(nk.nnei, npl.nnei))
    errs["nlist_build"] = 0.0 if same else float("inf")
    entries = int(nk.nnei.sum())
    print(f"[NPT] {label} nlist_build: lists identical {same}; K "
          f"{sim.spec.kmax}, cells {sim.spec.nc} cap {sim.spec.cell_cap}, "
          f"{entries / n:.1f} neighbors per atom (max "
          f"{int(nk.nnei.max())}), overflow {bool(nk.overflow)}")
    if not same or bool(nk.overflow):
        raise AssertionError(f"nlist_build {label} disagrees with its plain "
                             "version or overflowed")
    # K9b: force-only (every step) and with energies (thermo rows)
    args = (sim.pair, x, sim.typ, sim.q, boxL, nk)
    kw = dict(acc_dtype=acc, use_special=sim._special is not None)
    for ev in (False, True):
        rk = driver.compute_pair(*args, eflag=ev, **kw)
        rp = driver.compute_pair_plain(*args, eflag=ev, **kw)
        _npt_compare(label, "nlist_pair", rk[:3], rp[:3], ftol, errs)
        _npt_compare(label, "nlist_pair virial", rk.virial, rp.virial, etol,
                     {})
        if ev:
            for e in ("evdwl", "ecoul"):
                _npt_compare(label, f"nlist_pair {e}", getattr(rk, e),
                             getattr(rp, e), etol, {})
    rsq_in = 0
    j = nk.idx.long()
    for a0 in range(0, n, 1 << 15):
        jj = j[a0:a0 + (1 << 15)]
        ok = jj < n
        jj = torch.where(ok, jj, torch.zeros_like(jj))
        r2 = 0.0
        for ax in range(3):
            d = x[ax, a0:a0 + (1 << 15), None] - x[ax][jj]
            d = d - torch.round(d / boxL[ax]) * boxL[ax]
            r2 = r2 + d * d
        rsq_in += int(((r2 < sim.pair.cutsq_max) & ok).sum())
    fs = x.element_size()
    accs = torch.empty((), dtype=acc).element_size()
    work["nlist_pair"] = (entries * 5 + n * (3 * fs + fs + 4 + 4)
                          + 3 * n * accs,
                          entries * OPS_LIST_ENTRY + rsq_in * OPS_LIST_PAIR)
    fns["nlist_pair"] = (lambda: driver.compute_pair(*args, eflag=False,
                                                     **kw),
                         lambda: driver.compute_pair_plain(*args,
                                                           eflag=False, **kw))
    cand = _build_candidates(sim, sim.spec, x, boxL)
    K = sim.spec.kmax
    work["nlist_build"] = (3 * n * fs + K * n * 5 + 4 * n
                           + 2 * 4 * int(np.prod(sim.spec.nc))
                           * sim.spec.cell_cap, cand * OPS_BUILD_CAND)
    fns["nlist_build"] = (
        lambda: nlm.build_cell(x, lo, boxL, sim.spec, sim._special),
        lambda: nlm.build_cell_plain(x, lo, boxL, sim.spec, sim._special))
    # K16a
    tp = sim.kspace
    st_ = tp.consts(dev, flt)
    Gk = tp.tables(boxL)["G"]
    Gp = pppm_npt.traced_greens_plain(st_, boxL, tp.g_ewald)
    _npt_compare(label, "traced_greens", Gk, Gp, etol, errs)
    npts = int(np.prod(tp.grid))
    S = st_["ms"][0].shape[0]
    work["traced_greens"] = (npts * 2 * accs + 6 * S * max(tp.grid) * accs,
                             npts * (S ** 3 * OPS_GREENS_TERM + 12))
    fns["traced_greens"] = (lambda: tp.tables(boxL),
                            lambda: pppm_npt.traced_greens_plain(
                                st_, boxL, tp.g_ewald))
    # K16c
    v = sim.state.v
    vs = tuple(v.unbind(0))
    kk = npt_mod.ke3(vs, sim.typ, sim._mass_t, acc).sum(0)
    kp = npt_mod.ke3_plain(vs, sim.typ, sim._mass_t, acc).sum(0)
    _npt_compare(label, "npt_ke3", kk, kp, etol, errs)
    work["npt_ke3"] = (n * (3 * fs + 4), 9 * n)
    fns["npt_ke3"] = (lambda: npt_mod.ke3(vs, sim.typ, sim._mass_t, acc),
                      lambda: npt_mod.ke3_plain(vs, sim.typ, sim._mass_t,
                                                acc))
    vfac = torch.tensor([1.0, 1.0, 0.9999993], dtype=flt, device=dev)
    fl = tuple(sim.state.f.unbind(0))
    vk, vp = v.clone(), v.clone()
    npt_mod.vscale_kick(tuple(vk.unbind(0)), fl, sim.typ, sim._minv_t, vfac,
                        sim.dtf)
    npt_mod.vscale_kick_plain(tuple(vp.unbind(0)), fl, sim.typ, sim._minv_t,
                              vfac, sim.dtf)
    _npt_compare(label, "npt_vscale_kick", vk, vp, 0.0, errs)
    work["npt_vscale_kick"] = (n * (9 * fs + 4), 12 * n)
    vk_s = tuple(vk.unbind(0))
    fns["npt_vscale_kick"] = (
        lambda: npt_mod.vscale_kick(vk_s, fl, sim.typ, sim._minv_t, vfac,
                                    0.0),
        lambda: npt_mod.vscale_kick_plain(vk_s, fl, sim.typ, sim._minv_t,
                                          vfac, 0.0))
    s3 = torch.tensor([1.0, 1.0, 1.0000004], dtype=flt, device=dev)
    xk, xp = x.clone(), x.clone()
    npt_mod.drift_dilate(tuple(xk.unbind(0)), vs, s3, sim._center, sim.dtv)
    npt_mod.drift_dilate_plain(tuple(xp.unbind(0)), vs, s3, sim._center,
                               sim.dtv)
    _npt_compare(label, "npt_drift_dilate", xk, xp, 0.0, errs)
    work["npt_drift_dilate"] = (n * 9 * fs, 15 * n)
    xk_s = tuple(xk.unbind(0))
    fns["npt_drift_dilate"] = (
        lambda: npt_mod.drift_dilate(xk_s, vs, s3, sim._center, 0.0),
        lambda: npt_mod.drift_dilate_plain(xk_s, vs, s3, sim._center, 0.0))
    # K5-K8 with the box on the card, atom order
    kc = tp.tables(boxL)
    rk = tp.compute_traced(x, sim.q, boxL, eflag=True, kc=kc)
    xc, qc, Lc = x.cpu(), sim.q.cpu(), boxL.cpu()
    rp = tp.compute_traced(xc, qc, Lc, eflag=True, kc=tp.tables(Lc))
    _npt_compare(label, "traced pppm forces", torch.stack(rk.f).cpu(),
                 torch.stack(rp.f), ftol, errs)
    _npt_compare(label, "traced pppm elong", rk.elong.cpu(), rp.elong, etol,
                 {})
    _npt_compare(label, "traced pppm virial", rk.virial.cpu(), rp.virial,
                 etol, {})
    # K13 with the box on the card and the step's constraint virial
    if sim.shake is not None:
        t, inv = sim._shake_t, sim._inv
        xs0 = tuple(x.unbind(0))
        xn = (x + sim.dtv * v).contiguous()
        ro_k = shake.shake_ref(t, xs0, inv, boxL)
        ro_p = shake.shake_ref_plain(t, xs0, inv, boxL)
        _npt_compare(label, "shake_ref", ro_k, ro_p, etol, errs)
        pk, pv_ = xn.clone(), v.clone()
        pp, pvp = xn.clone(), v.clone()
        vf = 1.0 / (sim.dtv * sim.dtf)
        rn_k, wk = shake.shake_positions(t, ro_k, tuple(pk.unbind(0)),
                                         tuple(pv_.unbind(0)), inv, boxL,
                                         sim.dtv, sim.shake.iters, vf)
        rn_p, wp = shake.shake_positions_plain(
            t, ro_p, tuple(pp.unbind(0)), tuple(pvp.unbind(0)), inv, boxL,
            sim.dtv, sim.shake.iters, vf)
        ulp = float(torch.finfo(flt).eps) * float(boxL.max())
        xt = 0.0 if flt == torch.float64 else 4 * ulp / float(pp.abs().max())
        _npt_compare(label, "shake_positions x", pk, pp, xt + etol, errs)
        _npt_compare(label, "shake_positions virial", wk, wp, etol, {})
        rk_v, rp_v = pv_.clone(), pvp.clone()
        shake.rattle_velocities(t, tuple(rk_v.unbind(0)), inv, boxL,
                                xs=tuple(pk.unbind(0)))
        shake.rattle_velocities_plain(t, tuple(rp_v.unbind(0)), inv, boxL,
                                      xs=tuple(pp.unbind(0)))
        vt = 0.0 if flt == torch.float64 else \
            4 * ulp / sim.dtv / float(rp_v.abs().max())
        _npt_compare(label, "rattle_velocities", rk_v, rp_v, vt + etol, errs)
    # K14 with the box on the card, atom order
    if sim.bonded is not None:
        for name, style in _bonded_by_kernel(sim.bonded).items():
            errs[name] = _bonded_compare(f"{label} {name} (box on the card)",
                                         style, tuple(x.unbind(0)), boxL,
                                         None, acc)
    out = {}
    if time_it:
        for name, (kern, plain) in fns.items():
            ms, dev_ms = cuda_ms(kern), device_ms(kern)
            plain_ms = cuda_ms(plain, reps=3)
            b_ms, b_by = bound(*work[name])
            print(f"[NPT] {name} {label}: kernel {ms:.4f} ms (device "
                  f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by}; {work[name][0]:,} bytes, "
                  f"{work[name][1]:,} operations)")
            out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=errs[name], library_ms=None)
    return out


def phase_npt_kernels():
    """K9a, K9b, K16a, K16c and the extended K5-K8 / K13 / K14 entry points
    against their plain versions on the card: rhodo_npt.yaml's stack on
    one copy in f64 and f32, and at 248,832 atoms in f32, where the new
    kernels are timed."""
    cfg = load_deck("rhodo_npt.yaml")
    out = {}
    for replicate, precs in (((1, 1, 1), ("double", "single")),
                             (BIG_REPLICATE, ("single",))):
        for prec in precs:
            sim, x, boxL = _npt_state(cfg, prec, replicate)
            label = f"rhodo_npt x{'x'.join(map(str, replicate))}/{prec}"
            big = replicate == BIG_REPLICATE
            res = _npt_kernels_at(sim, x, boxL, label, time_it=big)
            if big:
                out = res
            del sim, x, boxL
            torch.cuda.empty_cache()
    return out


def phase_npt_record(rec: dict):
    """rhodo_npt.yaml in f64 on one copy (1,728 atoms, the box on the card
    from the first step) against the JAX package's f64 record: step-0
    forces, the rows every 5 steps to 20 with boxL and omega_dot, the final
    positions, images, box, strain rate and chain."""
    f64 = rec["f64"]
    cfg = load_deck("rhodo_npt.yaml")
    cfg.update(replicate=[1, 1, 1], precision="double")
    ops.reset_launches()
    sim = build_simulation(cfg, device="cuda")
    if (sim.n_atoms != f64["n_atoms"] or list(sim.kspace.grid)
            != f64["pppm_grid"] or sim.kspace.g_ewald != f64["g_ewald"]
            or sim.spec.kmax != f64["spec"]["kmax"]):
        raise AssertionError("rhodo_npt f64: atoms, mesh, g_ewald or list "
                             "capacity differ from the record")
    pick = np.asarray(f64["atoms"])
    f0 = sim.get_atoms()["f"]
    rows = sim.run(f64["steps"], thermo_every=f64["every"], log=False)
    at = sim.get_atoms()
    ref_f = np.asarray(f64["f0"])
    errs = {"f0": float(np.abs(f0[pick] - ref_f).max()) / np.abs(ref_f).max(),
            "x_end": float(np.abs(at["x"][pick] - np.asarray(f64["x_end"]))
                           .max()),
            "boxL_end": float(np.abs(at["boxL"] - f64["boxL_end"]).max()
                              / max(f64["boxL_end"])),
            "omega_dot_end": float(np.abs(sim.state.omega_dot.cpu().numpy()
                                          - f64["omega_dot_end"]).max()
                                   / np.abs(f64["omega_dot_end"]).max()),
            "therm": float(np.abs(sim.state.therm.cpu().numpy()
                                  - np.asarray(f64["therm"])).max()
                           / np.abs(np.asarray(f64["therm"])).max())}
    tol = {"f0": NPT_RECORD_TOL["f"], "x_end": NPT_RECORD_TOL["x"],
           "boxL_end": NPT_RECORD_TOL["rows"],
           "omega_dot_end": NPT_RECORD_TOL["rows"],
           "therm": NPT_RECORD_TOL["rows"]}
    for r, ref in zip(rows, f64["rows"], strict=True):
        for k in ("temp", "press", "vol", "evdwl", "ecoul", "elong", "emol",
                  "etotal"):
            errs[f"{k}@{ref['step']}"] = scalar_rel(r[k], ref[k])
            tol[f"{k}@{ref['step']}"] = NPT_RECORD_TOL["rows"]
        for k in ("boxL", "omega_dot"):
            want = np.asarray(ref[k])
            errs[f"{k}@{ref['step']}"] = float(
                np.abs(r[k] - want).max() / max(np.abs(want).max(), 1e-300))
            tol[f"{k}@{ref['step']}"] = NPT_RECORD_TOL["rows"]
    images_ok = bool(np.array_equal(at["image"][pick],
                                    np.asarray(f64["image_end"])))
    ran = dict(ops.LAUNCHES)
    print(f"[NPT record] rhodo_npt.yaml f64, {sim.n_atoms} atoms, mesh "
          f"{sim.kspace.grid}, K {sim.spec.kmax}: worst row "
          f"{max(v for k, v in errs.items() if '@' in k):.3e}, "
          + ", ".join(f"{k} {errs[k]:.3e}" for k in errs if "@" not in k)
          + f", images equal {images_ok}; launches {ran}")
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    if bad or not images_ok or any(ran[k] <= 0
                                   for k in NPT_PATH + NPT_SHAKE):
        raise AssertionError(f"rhodo_npt f64 disagrees with the JAX record: "
                             f"{bad}")


def phase_npt_deck(rec: dict, replicate=None):
    """rhodo_npt.yaml through build_simulation and run as run_deck calls
    them, launch counts set to 0 just before and read just after: at
    31,104 atoms unedited (step 0 against long_rhodo_npt.json under the
    _STEP0_FIELDS rule, the rows at 50 and 100 against the scaled one-copy
    record at its row_tol); at replicate [6, 6, 4] step 0 against the
    record scaled to 144 copies.  Every kernel of the path launched, no
    guard fired; returns launches and ms/step."""
    cfg = load_deck("rhodo_npt.yaml")
    key = "3x3x2"
    if replicate is not None:
        cfg["replicate"] = list(replicate)
        key = "x".join(map(str, replicate))
    full = rec["full"][key]
    name = f"rhodo_npt.yaml x{key}"
    ops.reset_launches()
    sim = build_simulation(cfg, device="cuda")
    rows = sim.run(int(cfg["run"]), thermo_every=int(cfg["thermo"]),
                   log=False)
    ran = dict(ops.LAUNCHES)
    n, steps = sim.n_atoms, int(cfg["run"])
    missing = [k for k in NPT_PATH + NPT_SHAKE if ran[k] <= 0]
    if missing or n != full["n_atoms"] or rows[-1]["step"] != steps:
        raise AssertionError(f"{name}: {n} atoms, {rows[-1]['step']} steps, "
                             f"kernels not launched {missing}")
    if (list(sim.kspace.grid) != full["pppm_grid"]
            or abs(sim.kspace.g_ewald - full["g_ewald"])
            > 1e-12 * full["g_ewald"] or sim.dof != full["dof"]):
        raise AssertionError(f"{name}: mesh, g_ewald or degrees of freedom "
                             "differ from the record")
    step0 = (load_golden("long_rhodo_npt.json")["rows"][0]
             if replicate is None else full["rows"][0])
    row = rows[0]
    scale = max(abs(step0["epair"]), 1.0)
    for k, rtol in STEP0.items():
        if k == "press" and n > 5000:
            rtol = 2e-2
        t = rtol * (scale if k not in ("temp", "press")
                    else max(abs(step0[k]), 1.0))
        if not abs(row[k] - step0[k]) <= t:
            raise AssertionError(f"{name} step-0 {k}: {row[k]:.8g} vs "
                                 f"record {step0[k]:.8g} (tol {t:.3g})")
    report = []
    for r in rows:
        for k in ("temp", "press", "etotal", "vol"):
            if not np.isfinite(r[k]):
                raise AssertionError(f"{name}: non-finite {k}")
    if replicate is None:
        rt = rec["row_tol"]
        want = {int(r["step"]): r for r in full["rows"]}
        for r in rows[1:]:
            w = want[r["step"]]
            d = {"temp": abs(r["temp"] - w["temp"]),
                 "press": abs(r["press"] - w["press"]),
                 "vol": abs(r["vol"] - w["vol"]) / w["vol"],
                 "etotal": abs(r["etotal"] - w["etotal"]) / n}
            report.append(f"step {r['step']}: " + ", ".join(
                f"{k} {r[k]:.6g} (record {w[k]:.6g}, |d| {d[k]:.3e}, tol "
                f"{rt[k]:.3e})" for k in d))
            bad = [k for k in d if not d[k] <= rt[k]]
            if bad:
                raise AssertionError(f"{name} step {r['step']}: {bad} off "
                                     "the record: " + report[-1])
    wall = sim.timings["run"]
    print(f"[NPT deck] {name}: {n} atoms x {steps} steps in {wall:.3f} s -> "
          f"{n * steps / wall:,.0f} atom-steps/s, {1e3 * wall / steps:.4f} "
          f"ms/step (thermo every {cfg['thermo']}); mesh {sim.kspace.grid}, "
          f"K {sim.spec.kmax}, cells {sim.spec.nc} cap {sim.spec.cell_cap}; "
          f"step 0 temp {row['temp']:.6g} etotal {row['etotal']:.8g} press "
          f"{row['press']:.6g} (record {step0['temp']:.6g}, "
          f"{step0['etotal']:.8g}, {step0['press']:.6g}); rows " + "; ".join(
              f"{r['step']}: T {r['temp']:.4f} P {r['press']:.4f} E "
              f"{r['etotal']:.6f} L {np.round(r['boxL'], 5).tolist()}"
              for r in rows) + f"; launches {ran}")
    for line in report:
        print(f"[NPT deck] {name} {line}")
    return dict(launches=ran, ms_step=1e3 * wall / steps, row=row)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    k1 = phase_k1()
    k2_big = phase_k2("buck_big.yaml")
    k2 = phase_k2("cristobalite_pppm.yaml")
    k1c = phase_cristobalite_k1()
    pp = phase_pppm()
    golden = load_golden("torch_cristobalite_pppm_step0.json")
    phase_jittered(golden)
    torch.cuda.empty_cache()

    pair = ("cellpair", "rebin_incremental", "rebin", "verlet_kick_drift",
            "verlet_kick", "verlet_ke")
    phase_deck("buck.yaml", load_golden("long_buck.json"), 10, pair,
               load_golden("long_buck.json")["drift_gate"])
    phase_deck("buck_big.yaml", load_golden("long_buck_big.json"), 100, pair,
               load_golden("long_buck_big.json")["drift_gate"])
    # the north-star path: gated like long_silica_pppm.json
    launches = phase_deck(
        "cristobalite_pppm.yaml",
        golden, 50,
        pair + ("pppm_deposit", "pppm_spectral", "pppm_gather"),
        load_golden("long_silica_pppm.json")["drift_gate"])["launches"]
    torch.cuda.empty_cache()

    rk = phase_rhodo_kernels()
    rhodo = load_golden("torch_rhodo_flex.json")
    phase_rhodo_record(rhodo, "nve")
    phase_rhodo_record(rhodo, "nvt")
    big = phase_rhodo_decks(rhodo)
    n_big = rhodo["full"]["x".join(map(str, BIG_REPLICATE))]["n_atoms"]
    print(f"[deck] rhodo_flex_nve.yaml at {n_big} atoms: "
          f"{big['ms_step']:.4f} ms/step, "
          f"{n_big / big['ms_step'] * 1e3:,.0f} atom-steps/s")
    torch.cuda.empty_cache()

    # the literal rhodo decks: SHAKE/RATTLE (K13)
    k13 = phase_shake_kernels()
    shake_rec = load_golden("torch_rhodo_shake.json")
    phase_rhodo_record(shake_rec, "nve", SHAKE_RECORD_TOL)
    phase_rhodo_record(shake_rec, "nvt", SHAKE_RECORD_TOL)
    sbig = phase_shake_decks(shake_rec)
    print(f"[deck] rhodo_nve.yaml at {n_big} atoms: "
          f"{sbig['ms_step']:.4f} ms/step, "
          f"{n_big / sbig['ms_step'] * 1e3:,.0f} atom-steps/s")
    torch.cuda.empty_cache()

    # fix npt on the neighbor-list engine (K9, K16): rhodo_npt.yaml
    knpt = phase_npt_kernels()
    npt_rec = load_golden("torch_rhodo_npt.json")
    phase_npt_record(npt_rec)
    npt = phase_npt_deck(npt_rec)
    nbig = phase_npt_deck(npt_rec, BIG_REPLICATE)
    for r, size in ((npt, 31104), (nbig, n_big)):
        print(f"[deck] rhodo_npt.yaml at {size} atoms: {r['ms_step']:.4f} "
              f"ms/step, {size / r['ms_step'] * 1e3:,.0f} atom-steps/s")

    def row(name, source, replaces, launch_key, r, launches=launches):
        return dict(name=name, route="cuda", source=f"{SRC}/{source}",
                    replaces=f"lammps_buck_intel_tpu/{replaces}",
                    launches=launches[launch_key],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    device_ms=r["device_ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"],
                    library_ms=r.get("library_ms"))

    kernels = [
        row("cellpair_forces", "cellpair.cu",
            "models/pair/cellpair.py:291", "cellpair", k1c),
        row("rebin_incremental", "rebin.cu",
            "neighbor/cell_slots.py:314", "rebin_incremental",
            dict(k2["incremental"], max_abs_err=k2["max_abs_err"])),
        row("rebin_full", "rebin.cu", "neighbor/cell_slots.py:289", "rebin",
            dict(k2["full"], max_abs_err=k2["max_abs_err"])),
        row("pppm_deposit", "pppm.cu", "models/kspace/pppm_cells.py:580",
            "pppm_deposit", pp["deposit"]),
        row("pppm_spectral", "pppm.cu", "models/kspace/pppm_cells.py:801",
            "pppm_spectral", pp["spectral"]),
        row("pppm_gather", "pppm.cu", "models/kspace/pppm_cells.py:633",
            "pppm_gather", pp["gather"]),
        # the molecular path: times at 248,832 atoms, launches of the NVE
        # deck's run at that size
        row("cellpair_forces_ljcharmm_special", "cellpair.cu",
            "models/pair/cellpair.py:291", "cellpair",
            rk["cellpair_ljcharmm"], big["launches"]),
        row("bonded_bond_angle", "bonded.cu",
            "models/bonded/harmonic.py:116", "bonded_bond_angle",
            rk["bonded_bond_angle"], big["launches"]),
        row("dihedral_charmm", "bonded.cu", "models/bonded/charmm.py:114",
            "dihedral_charmm", rk["dihedral_charmm"], big["launches"]),
        row("improper_harmonic", "bonded.cu", "models/bonded/charmm.py:185",
            "improper_harmonic", rk["improper_harmonic"], big["launches"]),
        # the integrator, on every path; nhc_scale's launches are the NVT
        # deck's (31,104 atoms), the NVE run launches none
        row("verlet_kick_drift", "verlet.cu",
            "integrate/cellpair_verlet.py:475", "verlet_kick_drift",
            rk["verlet_kick_drift"], big["launches"]),
        row("verlet_kick", "verlet.cu", "integrate/cellpair_verlet.py:475",
            "verlet_kick", rk["verlet_kick"], big["launches"]),
        row("verlet_ke", "verlet.cu", "integrate/cellpair_verlet.py:661",
            "verlet_ke", rk["verlet_ke"], big["launches"]),
        row("nhc_scale", "verlet.cu", "integrate/nvt.py:51", "nhc_scale",
            rk["nhc_scale"], big["launches"]),
        # the constraints: times at 248,832 atoms (124,416 C-H clusters),
        # launches of rhodo_nve.yaml's run at that size
        row("shake_ref", "shake.cu", "integrate/cellpair_verlet.py:503",
            "shake_ref", k13["shake_ref"], sbig["launches"]),
        row("shake_positions", "shake.cu", "integrate/shake.py:459",
            "shake_positions", k13["shake_positions"], sbig["launches"]),
        row("rattle_velocities", "shake.cu", "integrate/shake.py:540",
            "rattle_velocities", k13["rattle_velocities"], sbig["launches"]),
        row("shake_virial", "shake.cu", "integrate/shake.py:578",
            "shake_virial", k13["shake_virial"], sbig["launches"]),
        # fix npt: times at 248,832 atoms, launches of rhodo_npt.yaml's run
        # at that size
        row("nlist_build", "nlist.cu", "neighbor/neighbor_list.py:210",
            "nlist_build", knpt["nlist_build"], nbig["launches"]),
        row("nlist_pair", "nlist.cu", "models/pair/driver.py:78",
            "nlist_pair", knpt["nlist_pair"], nbig["launches"]),
        row("traced_greens", "npt.cu", "models/kspace/pppm_npt.py:202",
            "traced_greens", knpt["traced_greens"], nbig["launches"]),
        row("npt_ke3", "npt.cu", "integrate/npt.py:442", "npt_ke3",
            knpt["npt_ke3"], nbig["launches"]),
        row("npt_vscale_kick", "npt.cu", "integrate/npt.py:553",
            "npt_vscale_kick", knpt["npt_vscale_kick"], nbig["launches"]),
        row("npt_drift_dilate", "npt.cu", "integrate/npt.py:579",
            "npt_drift_dilate", knpt["npt_drift_dilate"], nbig["launches"]),
    ]
    print(f"[K1] buck_big buck branch: {json.dumps(k1['buck_big'])}")
    print(f"[K2] buck_big: {json.dumps(k2_big)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
