#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc builds csrc/cellpair.cu, csrc/rebin.cu, csrc/pppm.cu,
     csrc/bonded.cu, csrc/verlet.cu, csrc/shake.cu, csrc/nlist.cu,
     csrc/npt.cu, csrc/ewald.cu, csrc/pppm_disp.cu and csrc/rigid.cu (with
     the shared headers csrc/pair_terms.cuh and csrc/pppm_stencil.cuh)
     from the checkout into
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
  5. the PPPM kernels (deposit in slot order and by cell, spectral,
     gather) against their plain versions at cristobalite_pppm.yaml's
     mesh, atoms drifted up to skin/2 out of their cells, f32 and f64,
     with K5 by cell's counters (deposited, spilled); timed;
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
     half step) and K5 by cell against their plain versions at the
     decks' 31,104 atoms and at 248,832 atoms, f32 and f64, timed at the
     larger size (K5 by cell beside K5 in slot order);
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
     and the NPT launch counts of that last run in the kernels line;
 11. the neighbor-list Simulation (engine: nlist, the JAX package's
     default): the dense list build (K9c) against its plain version at
     500 and 1,440 atoms, f32 and f64, K forced to overflow too, timed at
     both (the kernels line takes 500, buck_small.yaml's shape); the
     generic-mesh PPPM (K10: PPPM.compute through the deposit,
     spectral and gather kernels in atom order) against the plain
     full-spectrum version (forces, elong, its reciprocal part alone,
     virial) on one cristobalite copy in f64;
     cristobalite_pppm_nlist.yaml (259,200 atoms, 100 steps, f32: step 0
     against the cell engine's record, which the other mesh's accuracy
     does not leave, elong's reciprocal part within RECIP_TOL of the
     record's, the silica drift gate, ms/step beside the cell
     engine's; K10 against its plain version on the run's last state and
     timed there); rhodo_nve_nlist.yaml at 31,104 atoms and at replicate
     [6, 6, 4] (step 0 against long_rhodo_nve.json and its scaled row,
     drift gate 1.3e-3, the constraints within tol at every row, ms/step
     beside rhodo_nve.yaml on the cell engine, the list pair pass's
     device time beside K1's); the 2x2x2 jittered cristobalite and one
     rhodo copy (NVT + SHAKE) in f64 against the JAX package's record
     (tests/goldens/torch_nlist.json); buck_small.yaml unedited through
     run_deck: the cell engine's box-too-small fallback into Simulation
     and K9c, the drift under buck's gate, whose launches the kernels
     line reports for K9c;
 12. Ewald (K11a ewald_sk, K11b ewald_force, csrc/ewald.cu) and coul/cut
     on the neighbor-list Simulation: K11a and K11b against
     ewald_compute_plain at cristobalite_ewald.yaml's 11,520 atoms of the
     jittered crystal (K 31,248), f64 and f32, each timed in f32 beside
     the plain (matmul) route and its bound; cristobalite_ewald.yaml at
     1x1x2 and cristobalite_coul_cut.yaml at one copy, f64, 20 steps,
     against the JAX package's record (tests/goldens/torch_ewald.json,
     re-recorded on the CPU with `python tools/record_ewald.py`);
     cristobalite_ewald.yaml unedited (11,520 atoms, 500 steps, f32: step
     0 and the reciprocal part of elong against the record, the silica
     drift gate 5e-3, ms/step); the coul/cut branch of K1 and K9b against
     their plain versions at 92,160 atoms, K9b timed beside its coul/long
     branch on the same list; cristobalite_coul_cut.yaml unedited (92,160
     atoms, 100 steps, f32: step 0 against the record scaled from 11,520
     atoms, elong 0; the deck conserves no energy (the truncated Coulomb
     sum), so its drift is held to the deck's f64 run on the card, whose
     rows and drift at the record's 11,520 atoms equal the JAX record's);
 13. the hexane path (lj/long/coul/long coul off + pppm/disp + fix
     rigid/small on the cell engine, examples/decks/hexane_gen.yaml: the
     reference's in.hexane on the generated liquid of
     examples/gen_hexane.py): K1's lj/long branch with the same-molecule
     mol plane, K5 / K12a (csrc/pppm_disp.cu: one and seven channels) /
     K8 on the dispersion mesh and K15a-c (csrc/rigid.cu, at both lane
     widths) against their plain versions at 6,000 atoms in f64 and f32;
     the deck in f64 (50 steps, thermo 10) against the JAX package's
     record (tests/goldens/torch_disp.json, re-recorded on the CPU with
     `python tools/record_hexane.py`: mesh, g_ewald_6, cells, the host
     terms of elong, every row within 1e-9, positions and images at step
     50); the deck unedited in f32 (6,000 atoms, 200 steps: step-0 epair,
     elong, etotal within 2e-5 of the record, the relative drift under
     5e-4) and hexane_gen_big.yaml (192,000 atoms: step 0 against the
     record scaled to 32 copies, the same drift gate), every kernel of
     the path launched; the kernels timed at the big deck's state beside
     their plain versions, bounds and library calls;
 14. long-range dispersion beside long-range Coulomb and the arithmetic
     and no-mix channel pipelines (buck/long/coul/long and
     lj/long/coul/long with pppm/disp: the Coulomb PPPM beside the
     dispersion PPPM bound to the atoms): the DISP_LONG variants of K1
     and K9b (buck and lj, coul none and coul long) and the
     multi-channel deposit and gather (csrc/pppm_disp.cu: K12b
     disp_deposit, K12c disp_gather) against their plain versions, f64
     (1e-12) and f32 (forces 5e-4), at 2 channels on the jittered 2x2x2
     cristobalite and 7 on hexane_gen_arith.yaml; the f64 record
     (tests/goldens/torch_disp_mix.json, re-recorded on the CPU with
     `python tools/record_disp_mix.py`: the jittered 2x2x2 cristobalite on
     both engines and hexane_gen_arith.yaml, 20 steps, every row within
     1e-9); cristobalite_buck_long.yaml and
     cristobalite_buck_long_nlist.yaml unedited (259,200 atoms, 100 steps,
     f32: step-0 elong within 2e-5 of the record scaled to 22.5 copies,
     the other fields under the _STEP0_FIELDS rule, drift under the silica
     gate) and hexane_gen_arith.yaml (6,000 atoms, 200 steps: step 0
     within 2e-5, relative drift under 5e-4), every kernel of each path
     launched; K1 and K9b buck/long timed beside their buck/coul/long
     branches on the same state, K12b and K12c beside the per-channel
     K5 / K8 loops they replace, at 2 channels (259,200 atoms) and at 7
     (hexane_gen_big.yaml with mix arithmetic, 192,000 atoms); K1's
     lj/long + coul/long variant, which no deck runs, timed on
     hexane_gen_big.yaml's slots with a neutral +-0.25 e charge pattern;
 15. the per-atom computes (compute pe/atom, compute stress/atom, dump
     custom): the four cases of tests/goldens/torch_peratom.json (written
     on the CPU by `python tools/record_peratom.py`; examples/
     peratom_cases.py builds them: jittered silica with
     PPPM and with Ewald on the list engine, rhodo_class.yaml on the cell
     engine, one copy of rhodo_npt.yaml) in f64: K9d (csrc/nlist.cu
     nlist_pair_peratom), K10pa (csrc/pppm.cu pppm_peratom_spectral,
     pppm_peratom_gather), K11pa (csrc/ewald.cu ewald_peratom) and K18b
     (csrc/bonded.cu bonded_peratom) against their plain versions
     (1e-12), the f64 functions against the JAX package's record (1e-9),
     pe_atom and stress_atom against the JAX computes (2e-5 of the sums,
     1e-4 of the sampled atoms), and the pins to thermo (sum pe against
     epair + emol; the pressure identity without SHAKE; rhodo_npt again
     20 steps on, at the dilated box); then cristobalite_pppm_dump.yaml
     (259,200 atoms), cristobalite_ewald_dump.yaml (11,520) and
     rhodo_nve_dump.yaml (31,104) unedited through run_deck with their
     dump file in a temporary directory: every kernel of the path
     launched, each frame read back with read_lammpstrj, sum c_pe
     against the frame's thermo row within 5e-4 and, on the silica decks,
     -trace(sum c_stress) / (3 V) against press within 2e-4; ms/step
     without the frames beside the deck without dump earlier in this
     call, and the seconds a frame costs; the per-atom kernels in f32
     against their plain versions at each deck's last state, timed there;
 16. the per-atom dispersion PPPM (K12pa: csrc/pppm_disp.cu
     disp_peratom_spectral, disp_peratom_gather) and the slot-order
     per-atom PPPM (K18 slots: pppm_peratom_gather and disp_peratom_gather
     over the cell engine's slots): the three cases of
     tests/goldens/torch_peratom_disp.json (`python tools/record_peratom.py
     disp`; cristobalite_buck_long.yaml on the jittered copy, hexane_gen.yaml
     and hexane_gen_arith.yaml on a 4x4x4 cut-out) in f64: every per-atom
     kernel against its plain version (1e-12), K18 slots on the hexane
     cell engine with their pins, the f64 functions against the record
     (1e-9), the computes against the JAX computes and the thermo pins;
     then cristobalite_buck_long_dump.yaml (259,200 atoms),
     hexane_gen_dump.yaml and hexane_gen_arith_dump.yaml (6,000) unedited
     through run_deck: every kernel of the path launched, every frame's
     sum c_pe within 5e-4 of thermo, on the buck/long deck the pressure
     identity within 2e-4 (the rigid bodies' virial is global only), ms/step
     without the frames beside the decks without dump earlier in this call,
     a frame's seconds; the per-atom kernels in f32 against their plain
     versions at each deck's last state, timed there, with the dispersion
     per-atom virial's miss at the deck's mesh in f64; K12pa (one channel)
     and K18 slots (dispersion) timed at hexane_gen_big.yaml's state in
     phase 13 and K18 slots (Coulomb) at cristobalite_pppm_dump.yaml's in
     phase 15, each launched by one compute_peratom_slots with the counts
     set to 0 just before, against its plain version, 0 on empty slots,
     its sums pinned to compute_slots in f64 (the Coulomb form with and
     without the full-spectrum Nyquist rule, printed); K9c's device time at
     500 atoms traced once more;
 17. the rest of the Coulomb k-space: K10 ad spectral and K10 ad gather
     (csrc/pppm.cu pppm_spectral with ad, pppm_gather_ad) on
     cristobalite_pppm_ad.yaml's slots, the ad gather and K10 slab
     (pppm_slab; also on a charged copy, Q != 0) with the box on the card
     at rhodo_npt_ad.yaml's 31,104 atoms, K11 traced (csrc/ewald.cu
     ewald_traced) and the traced Ewald at cristobalite_ewald_npt.yaml's
     11,520 atoms and K 31,248, each against its plain version in f64 and
     f32, timed in f32; the six shrunk decks of
     tests/goldens/torch_kspace_rest.json (`python
     tools/record_kspace_rest.py`; examples/kspace_rest_cases.py) in f64
     against the JAX record (1e-9), the two NPT cases in f32 against the
     record's rows (REST_NPT_F32_TOL); then cristobalite_pppm_ad.yaml and
     cristobalite_pppm_ad_nlist.yaml (259,200 atoms, step 0 against the
     cell deck's record, the silica drift gate), kspace_modify mesh
     (cristobalite_pppm_nlist.yaml on a 120x128x96 mesh, 10 steps),
     cristobalite_slab.yaml (259,200 atoms on the generic z-extended mesh
     over the cell engine's slots: step 0 against the record of one copy
     scaled to 30, the drift under twice the record's; K10 slab against
     its plain version at its last state, f32 and f64, neutral and
     charged), cristobalite_ewald_cell.yaml and
     cristobalite_ewald_npt.yaml (11,520 atoms, 500 steps),
     rhodo_npt_ad.yaml (31,104) and its x6x6x4, each unedited with every
     kernel of its path launched, ms/step beside the decks they vary; the
     two NPT decks at full width in f32 against f64 on the card over the
     record's steps (REST_NPT_F32_TOL).
The last lines are the kernels' JSON summary (ms: CUDA events around a
run of calls, what a caller pays; device_ms: the card's own time from
torch.profiler; the plain version's and a library call's time; the
least time the card could take; launches on the main path), the card's
name and power limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
from lammps_buck_intel_tpu_torch.interop import jax_torsion_deck as jax_deck
from lammps_buck_intel_tpu_torch.models.bonded import (compute_bonded,
                                                       compute_bonded_plain,
                                                       make_bonded)
from lammps_buck_intel_tpu_torch.models.kspace import pppm_cells
from lammps_buck_intel_tpu_torch.models.pair import build_buck
from lammps_buck_intel_tpu_torch.models.pair.cellpair import (
    _chunk_cells, candidate_mask, compute_cellpair, compute_cellpair_plain,
    half_offsets, half_stencil_tables)
from lammps_buck_intel_tpu_torch.neighbor import cell_slots as cs
from lammps_buck_intel_tpu_torch.ops import build
from lammps_buck_intel_tpu_torch.ops import pppm as pppm_ops
from lammps_buck_intel_tpu_torch.run import build_simulation
from lammps_buck_intel_tpu_torch.utils import device_trace, trace

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
# a PPPM that returned zero would be off by all of it.  The neighbor-list
# engine's generic mesh is not the record's: its solver's own accuracy
# enters too, and is printed beside the gate.
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
# grij and exp 3, A&S erfc 13, force 5) or coul/cut 3 (qq q_j / r), scalar
# 1, both atoms' forces 9;
# lj/charmm 10 (r^-6 2, forcelj 4, philj 4) in place of buck's 8, and 15
# more for a pair in the switching region (tt 1, switch1 6, switch2 5,
# combination 3)
OPS_PAIR = {("buck", "none"): 29, ("buck", "long"): 53,
            ("ljcharmm", "long"): 55, ("buck", "cut"): 32,
            ("ljcharmm", "cut"): 34}
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


def list_pass_bytes(entries: int, n: int, fs: int, use_special: bool,
                    out_bytes: int) -> int:
    """Bytes a neighbor-list pass (K9b, K9d) must move: a 4-byte index per
    entry and its 1-byte special code only under SPECIAL; x, y, z, q in
    flt, typ and nnei per atom; ``out_bytes`` written."""
    return (entries * (4 + int(use_special)) + n * (4 * fs + 8)
            + out_bytes)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, nops / PEAK_F32_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def load_deck(name: str) -> dict:
    """A deck of examples/decks under the JAX package's torsion angle: the
    gates here are the JAX package's records, whose angle is LAMMPS' plus
    180 degrees, so the dihedral and improper coefficients are mapped
    (``interop.jax_torsion_deck``)."""
    import yaml

    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    if "read_data" in cfg:
        cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    return jax_deck(cfg)


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
    the losses come in runs, and a longer lead ends them).  A trace that
    kept its lead but recorded no device time after it is lost the same
    way, and taken again.  After ``tries`` lost traces the device time is
    not measured: NaN, printed as such and null in the kernels line (the
    caller's time, ``cuda_ms``, is measured all the same)."""
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
        if ms > 0:
            return ms
        print("[trace] the device trace recorded nothing after its lead; "
              "tracing again")
    print(f"[trace] device time not measured: torch.profiler lost the "
          f"trace {tries} times (its lead, or every device event after it)")
    return float("nan")


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


def pairs_in_cutoff(style, grid, box, st, rsq_min: float = -1.0,
                    slot_mol=None) -> int:
    """Unordered pairs of this state within the style's largest cutoff
    (and beyond rsq_min; of two molecules with ``slot_mol``): the pair
    work the function needs, each pair once over the Newton half stencil,
    as the kernel decides it."""
    ncell, cap, n = grid.ncell, grid.cap, grid.n_atoms
    offs = half_offsets(grid.reach_z)
    K = offs.shape[0]
    nbr, _, shifts = half_stencil_tables(grid.nc, offs)
    nbr_t = torch.as_tensor(nbr, dtype=torch.long, device=st.x.device)
    shift_t = torch.as_tensor(shifts * np.asarray(box.lengths),
                              device=st.x.device).to(st.x.dtype)
    pos = [p.view(ncell, cap) for p in (st.x, st.y, st.z)]
    aid = st.aid.view(ncell, cap)
    own = candidate_mask(cap, K, st.x.device)
    total = 0
    chunk = _chunk_cells(cap, K, ncell)
    for c0 in range(0, ncell, chunk):
        c1 = min(ncell, c0 + chunk)
        js = nbr_t[c0:c1]
        rsq = 0.0
        for ax in range(3):
            pj = (pos[ax][js] + shift_t[c0:c1, :, ax, None]).reshape(
                c1 - c0, 1, K * cap)
            rsq = rsq + (pos[ax][c0:c1, :, None] - pj) ** 2
        ai = aid[c0:c1, :, None]
        aj = aid[js].reshape(c1 - c0, 1, K * cap)
        ok = ((ai < n) & (aj < n) & own & (rsq < style.cutsq_max)
              & (rsq > rsq_min))
        if slot_mol is not None:
            mol = slot_mol.view(ncell, cap)
            ok &= mol[c0:c1, :, None] != mol[js].reshape(c1 - c0, 1, K * cap)
        total += int(ok.sum())
    return total


def step0_check(name: str, row: dict, ref: dict, n: int):
    """The _STEP0_FIELDS rule (press 2e-2 above 5,000 atoms): energies
    within 2e-3 of |epair|, temp 1e-3 and press of their magnitude."""
    scale = max(abs(ref["epair"]), 1.0)
    for key, rtol in STEP0.items():
        if key == "press" and n > 5000:
            rtol = 2e-2
        tol = rtol * (scale if key not in ("temp", "press")
                      else max(abs(ref[key]), 1.0))
        if not abs(row[key] - ref[key]) <= tol:
            raise AssertionError(f"{name} step-0 {key}: {row[key]:.8g} vs "
                                 f"record {ref[key]:.8g} (tol {tol:.3g})")


def recip_check(name: str, row: dict, elong_self: float, golden: dict):
    """The step-0 reciprocal part of elong (elong - elong_self) within
    RECIP_TOL of the record's, and the solver's self and background terms
    those of the record (rel 1e-12)."""
    recip, ref_recip = row["elong"] - elong_self, golden["elong_recip"]
    print(f"[deck] {name}: step-0 elong - elong_self {recip:.6g} (record "
          f"{ref_recip:.6g}, tol rel {RECIP_TOL}); elong_self "
          f"{elong_self:.10g} (record {golden['elong_self']:.10g})")
    if (abs(elong_self - golden["elong_self"])
            > 1e-12 * abs(golden["elong_self"])
            or not abs(recip - ref_recip) <= RECIP_TOL * abs(ref_recip)):
        raise AssertionError(f"{name}: reciprocal part of elong off")


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


def _k1_compare(label, style, grid, box, st, acc, special=None,
                slot_mol=None, tol=None):
    """Kernel vs plain, force-only and with e/v; returns the f32/f64
    force-only max |df|.  tol: (forces, energies) in place of TOL's."""
    ftol, etol = TOL[st.x.dtype] if tol is None else tol
    abs_err = 0.0
    for ev in (False, True):
        k = compute_cellpair(style, grid, box, st, eflag=ev, vflag=ev,
                             acc_dtype=acc, special=special,
                             slot_mol=slot_mol)
        p = compute_cellpair_plain(style, grid, box, st, eflag=ev, vflag=ev,
                                   acc_dtype=acc, special=special,
                                   slot_mol=slot_mol)
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
            if style.cfg.has_coul:
                errs["ecoul"] = scalar_rel(k.ecoul, p.ecoul)
            msg += "".join(f", {n} rel {e:.3e}" for n, e in errs.items())
            ok = ok and all(e <= etol for e in errs.values())
        print(msg)
        if not ok:
            raise AssertionError(f"K1 {label} disagrees with its plain "
                                 f"version (tol {ftol}, {etol})")
    return abs_err


def _k1_counts(style, grid, box, st, special=None, slot_mol=None) -> dict:
    """K1's device counters (utils/trace.py) over one f32 force-only
    launch: candidates tested, pairs in range, evaluate lane slots, and
    from them the filter's hit share, the evaluate phase's lane use and
    the candidates tested an atom over cap (the tiles an atom walks: 14
    on the half stencil at reach_z 1, 23 at reach_z 2)."""
    names = ("tested", "in_range", "eval_lanes")
    was_on = trace.enabled()
    before = trace.counters()
    trace.enable()
    try:
        compute_cellpair(style, grid, box, st, acc_dtype=torch.float32,
                         special=special, slot_mol=slot_mol)
        after = trace.counters()
    finally:
        if not was_on:
            trace.disable()
    out = {k: after[f"cellpair.{k}"] - before[f"cellpair.{k}"]
           for k in names}
    out.update(hit_share=out["in_range"] / max(out["tested"], 1),
               lane_use=out["in_range"] / max(out["eval_lanes"], 1),
               tiles=out["tested"] / max(grid.n_atoms * grid.cap, 1))
    return out


def _k1_time(label, sim, st, reps_plain=3):
    """Force-only f32 kernel and plain times, the kernel's bound and its
    counters."""
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
        (st.q,) if coul != "none" else ())
    nbytes = (grid.nslots * plane_bytes(st.aid)
              + grid.n_atoms * (plane_bytes(*planes) + 3 * 4))
    nops = pairs * OPS_PAIR[style.cfg.vdw, coul]
    if style.cfg.vdw == "ljcharmm":
        nops += OPS_SWITCH * pairs_in_cutoff(style, grid, box, st,
                                             rsq_min=style.inner_sq)
    if special is not None:
        nbytes += special.packed.numel() * 4
    b_ms, b_by = bound(nbytes, nops)
    cnt = _k1_counts(style, grid, box, st, special)
    print(f"[K1] {label} f32 force-only: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f}), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}; {pairs:,} pairs in cutoff, {nbytes:,} bytes) (grid "
          f"{grid.nc} cap {grid.cap} reach_z {grid.reach_z}); counters: "
          f"{cnt['tested']:,} tested, {cnt['in_range']:,} in range, "
          f"{cnt['eval_lanes']:,} evaluate lanes: hit share "
          f"{cnt['hit_share']:.4f}, lane use {cnt['lane_use']:.4f}, tested "
          f"an atom / cap {cnt['tiles']:.2f}")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, hit_share=cnt["hit_share"],
                lane_use=cnt["lane_use"], tiles=cnt["tiles"])


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


def _k5_cells(label, sim, st, out=None):
    """K5 by cell (``pppm_deposit_cells``) on a cell engine's slots against
    the plain deposit, the device counters ``pppm.deposited`` (every
    charged slot) and ``pppm.spilled`` read around it; with ``out`` both
    K5 paths timed on the same slots, K5 in slot order
    (``pppm_deposit``) beside it, with the deposit's bound."""
    solver, n = sim.kspace, sim.n_atoms
    pm, bricks = solver.pm, solver.bricks
    c = solver.consts(st.x.device, st.x.dtype, sim.precision.acc)
    ns = st.x.shape[0]
    if not pppm_cells.takes_bricks(bricks, ns, st.x.element_size()):
        raise AssertionError(f"K5 {label}: the slots do not take K5 by "
                             f"cell (bricks {bricks})")
    plain = pppm_cells.deposit_plain(pm, st)
    res = {}
    trace.enable()
    try:
        c0 = trace.counters()
        mesh_c = pppm_ops.deposit_cells(pm, st, n, c["coef"], bricks)
        c1 = trace.counters()
    finally:
        trace.disable()
    _pppm_compare(label, "deposit_cells", mesh_c, plain,
                  TOL[st.x.dtype][0], res)
    dep, spill = (c1[f"pppm.{k}"] - c0[f"pppm.{k}"]
                  for k in ("deposited", "spilled"))
    charged = int(((st.aid < n) & (st.q != 0)).sum())
    ncell = int(np.prod(bricks.nc))
    print(f"[K5] {label}: mesh {pm.grid} order {pm.order} on {bricks.nc} "
          f"cells of {ns // ncell} slots, bricks {bricks.w} from "
          f"{bricks.off}: deposited {dep} (charged slots {charged}), "
          f"spilled {spill}")
    if dep != charged:
        raise AssertionError(f"K5 {label}: deposited {dep} of {charged}")
    res["deposit_cells"].update(deposited=dep, spilled=spill)
    if out is None:
        return res
    flt_size = st.x.element_size()
    nbytes = ns * plane_bytes(st.x, st.y, st.z, st.q, st.aid) \
        + int(np.prod(pm.grid)) * flt_size
    nops = n * (OPS_WEIGHTS(pm.order) + pm.order**3 * OPS_DEPOSIT_PT)
    b_ms, b_by = bound(nbytes, nops)
    for name, kern in (
            ("deposit_cells", lambda: pppm_ops.deposit_cells(
                pm, st, n, c["coef"], bricks)),
            ("deposit", lambda: pppm_ops.deposit(pm, st, n, c["coef"]))):
        ms, dev_ms = cuda_ms(kern), device_ms(kern)
        res.setdefault(name, {}).update(ms=ms, device_ms=dev_ms,
                                        bound_ms=b_ms, bound_by=b_by)
        print(f"[K5] {label} {name}: kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f}), bound {b_ms:.4f} ms ({b_by})")
    out.update(res)
    return res


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
        res.update(_k5_cells(label, sim, st))
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
            _pppm_time(pm, st, n, c, rhat, e_mesh, acc, out,
                       solver.bricks)
        del sim, st, solver
        torch.cuda.empty_cache()
    return out


def _pppm_time(pm, st, n, c, rhat, e_mesh, acc, out, bricks):
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
        # K5 by cell on the same slots: the same work and bound
        "deposit_cells": (
            lambda: pppm_ops.deposit_cells(pm, st, n, c["coef"], bricks),
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
    step0_check(name, row, ref, n)
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
        recip_check(name, row, pm.elong_self, golden)
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
    k5 = _k5_cells(label, sim, st, {} if out is not None else None)
    if out is not None:
        out["pppm_deposit_cells"] = k5


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
    path = ("cellpair", "rebin_incremental", "rebin", "pppm_deposit_cells",
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
    launch counts and ms/step, and the 31,104-atom run's ms/step."""
    path = ("cellpair", "rebin_incremental", "rebin", "pppm_deposit_cells",
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
    small = phase_deck("rhodo_nve.yaml", deck, 50, path, gate)
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
    big["small_ms_step"] = small["ms_step"]
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


def list_pairs_in_cutoff(x, boxL, nl, cutsq: float) -> int:
    """List entries (i, j) of nl within cutsq of each other (minimum image
    under boxL): the pairs whose physics the list pair pass evaluates."""
    n = x.shape[1]
    rsq_in = 0
    j = nl.idx.long()
    for a0 in range(0, n, 1 << 15):
        jj = j[a0:a0 + (1 << 15)]
        ok = jj < n
        jj = torch.where(ok, jj, torch.zeros_like(jj))
        r2 = 0.0
        for ax in range(3):
            d = x[ax, a0:a0 + (1 << 15), None] - x[ax][jj]
            d = d - torch.round(d / boxL[ax]) * boxL[ax]
            r2 = r2 + d * d
        rsq_in += int(((r2 < cutsq) & ok).sum())
    return rsq_in


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
    rsq_in = list_pairs_in_cutoff(x, boxL, nk, sim.pair.cutsq_max)
    fs = x.element_size()
    accs = torch.empty((), dtype=acc).element_size()
    work["nlist_pair"] = (list_pass_bytes(entries, n, fs,
                                          kw["use_special"], 3 * n * accs),
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
    step0_check(name, row, step0, n)
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


# ---- the neighbor-list Simulation (K9c, K10): engine: nlist ----

NLIST_PATH = ("nlist_pair", "verlet_kick_drift", "verlet_kick", "verlet_ke")
NLIST_PPPM = ("pppm_deposit", "pppm_spectral", "pppm_gather")
NLIST_SHAKE = ("shake_ref", "shake_positions", "rattle_velocities",
               "shake_virial")
# f64 on the card against the JAX package's f64 record of the
# neighbor-list engine (tests/goldens/torch_nlist.json): the CPU parity
# tolerance of tests/test_torch_simulation.py; rows and forces relative,
# positions of the box length
NLIST_RECORD_TOL = 1e-10
# per mesh point of a real-to-complex FFT or its inverse: half of a
# complex FFT's 5 log2(M) operations
OPS_RFFT_PT = lambda m: 2.5 * np.log2(m)  # noqa: E731


def _nlist_sim(name: str, precision: str = "single", replicate=None,
               jitter=None):
    """A neighbor-list deck built on the card; jitter = amplitude: read a
    copy of examples/data.cristobalite that gen_cristobalite.jitter
    displaced (written to a temporary directory)."""
    cfg = load_deck(name)
    cfg["precision"] = precision
    if replicate is not None:
        cfg["replicate"] = list(replicate)
    if jitter is None:
        return build_simulation(cfg, device="cuda")
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import gen_cristobalite

    with tempfile.TemporaryDirectory() as tmp:
        cfg["read_data"] = os.path.join(tmp, "data.cristobalite_jitter")
        gen_cristobalite.write(cfg["read_data"], jitter_amp=jitter)
        return build_simulation(cfg, device="cuda")


def phase_nlist_dense():
    """K9c against build_dense's plain version on the card: buck_small's
    500-atom lattice (the fallback of buck_small.yaml) and one jittered
    copy of the cristobalite crystal (1,440 atoms, one cell along z), f32
    and f64, at the decks' K and with K forced to 16 (overflow): the same
    lists, codes, counts and flags.  Timed in f32 at both sizes, with
    torch.cdist + topk (no periodic image) beside it as the nearest
    library pair; the kernels line takes the 500-atom numbers, the shape
    of buck_small.yaml's run that gives its launches, and the 1,440-atom
    time is printed beside them."""
    import dataclasses

    from lammps_buck_intel_tpu_torch.neighbor import neighbor_list as nlm

    out = {}
    for n, prec in ((500, "single"), (500, "double"), (1440, "double"),
                    (1440, "single")):
        sim = (_nlist_sim("buck_small.yaml", prec) if n == 500 else
               _nlist_sim("cristobalite_pppm_nlist.yaml", prec, (1, 1, 1),
                          jitter=0.1))
        if sim.n_atoms != n or not sim.spec.dense:
            raise AssertionError(f"dense build: {sim.n_atoms} atoms, spec "
                                 f"{sim.spec}")
        x, lo, L = sim.state.x, sim._lo, sim._boxL
        for spec in (sim.spec, dataclasses.replace(sim.spec, kmax=16)):
            nk = nlm.build_dense(x, lo, L, spec, sim._special)
            npl = nlm.build_dense_plain(x, lo, L, spec, sim._special)
            same = (torch.equal(nk.idx, npl.idx)
                    and torch.equal(nk.sb, npl.sb)
                    and torch.equal(nk.nnei, npl.nnei)
                    and bool(nk.overflow) == bool(npl.overflow)
                    == (spec is not sim.spec))
            print(f"[K9c] {n} atoms {prec} K {spec.kmax}: lists identical "
                  f"{same}, {float(nk.nnei.double().mean()):.1f} neighbors "
                  f"per atom (max {int(nk.nnei.max())}), overflow "
                  f"{bool(nk.overflow)}")
            if not same:
                raise AssertionError(f"nlist_dense {n}/{prec} disagrees "
                                     "with its plain version")
        if prec == "single":
            spec, k = sim.spec, min(sim.spec.kmax, n)
            xt = x.t().contiguous()

            def kern():
                return nlm.build_dense(x, lo, L, spec, sim._special)

            ms, dev_ms = cuda_ms(kern), device_ms(kern)
            plain_ms = cuda_ms(
                lambda: nlm.build_dense_plain(x, lo, L, spec, sim._special),
                reps=3)
            pair_ms = cuda_ms(lambda: torch.topk(torch.cdist(xt, xt), k,
                                                 largest=False))
            fs = x.element_size()
            b_ms, b_by = bound(3 * n * fs + k * n * 5 + 4 * n,
                               n * n * OPS_BUILD_CAND)
            print(f"[K9c] nlist_dense f32 at {n} atoms, K {k}: kernel "
                  f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} "
                  f"ms, torch.cdist + topk {pair_ms:.4f} ms (not the same "
                  f"function: no periodic image), bound {b_ms:.5f} ms "
                  f"({b_by})")
            if n == 500:
                out = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
                           library_ms=None, cdist_topk_ms=pair_ms)
        del sim
        torch.cuda.empty_cache()
    return out


def _k10_compare(label, pm, x, q, flt):
    """PPPM.compute on the card (K10 through K5 / K7 / K8) against
    pppm_compute_plain (the JAX _pppm_compute's full spectrum) on the
    same card: forces, elong and the virial at the TOL of the PPPM
    kernels.  elong adds the host's self and background terms (on
    cristobalite 10^4 times the rest) to the kernels' energy sum, so that
    sum is held on its own too: the same solver with no self term (qsum
    and qsqsum 0; neither enters the kernels) returns it alone as elong.
    Returns the largest force difference."""
    import dataclasses

    from lammps_buck_intel_tpu_torch.models.kspace.pppm import \
        pppm_compute_plain

    ftol, etol = TOL[flt]
    rk = pm.compute(x, q, eflag=True, vflag=True)
    rp = pppm_compute_plain(pm, x, q, True, True)
    recip = dataclasses.replace(pm, qsum=0.0, qsqsum=0.0)
    ek_k = recip.compute(x, q, eflag=True, vflag=False).elong
    ek_p = pppm_compute_plain(recip, x, q, True, False).elong
    fk, fp = torch.stack(rk.f), torch.stack(rp.f)
    errs = {"f": rel_err(fk, fp), "elong": scalar_rel(rk.elong, rp.elong),
            "ek": scalar_rel(ek_k, ek_p),
            "virial": rel_err(rk.virial, rp.virial)}
    print(f"[K10] {label}: mesh {pm.grid} order {pm.order}; forces "
          f"{errs['f']:.3e} of max|f| {float(fp.abs().max()):.4g}, elong "
          f"{errs['elong']:.3e} ({float(rk.elong):.10g} vs "
          f"{float(rp.elong):.10g}), its reciprocal part {errs['ek']:.3e} "
          f"({float(ek_k):.10g} vs {float(ek_p):.10g}), virial "
          f"{errs['virial']:.3e}")
    if not (errs["f"] <= ftol and errs["elong"] <= etol
            and errs["ek"] <= etol and errs["virial"] <= etol):
        raise AssertionError(f"PPPM.compute {label} disagrees with its "
                             "plain version")
    return float((fk - fp).abs().max())


def _k10_time(pm, x, q):
    """K10 in f32 at the deck's generic mesh: the staged route as a caller
    pays for it (force-only, as on every step but the thermo rows), its
    device time, the plain version; the bound counts x, y, z, q in and
    the three force planes out, and the deposit's, spectral kernel's,
    gather's and the four real FFTs' operations."""
    from lammps_buck_intel_tpu_torch.models.kspace.pppm import \
        pppm_compute_plain

    n, p = x.shape[1], pm.order
    m = int(np.prod(pm.grid))
    npts = pm.grid[0] * pm.grid[1] * (pm.grid[2] // 2 + 1)

    def kern():
        return pm.compute(x, q, eflag=False, vflag=False)

    ms, dev_ms = cuda_ms(kern), device_ms(kern)
    plain_ms = cuda_ms(lambda: pppm_compute_plain(pm, x, q, False, False),
                       reps=3)
    acc = torch.empty((), dtype=pm.acc_dtype).element_size()
    b_ms, b_by = bound(
        n * 4 * x.element_size() + 3 * n * acc,
        n * (2 * OPS_WEIGHTS(p) + p ** 3 * (OPS_DEPOSIT_PT + OPS_GATHER_PT))
        + npts * OPS_SPECTRAL_PT + 4 * m * OPS_RFFT_PT(m))
    print(f"[K10] pppm_compute f32 at {n} atoms, mesh {pm.grid}: staged "
          f"route {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} "
          f"ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def nlist_violation(sim) -> float:
    """max |r^2/d^2 - 1| over the constraints, in f64 on the card (the
    neighbor-list engine keeps atom order)."""
    x = sim.state.x.double().t()
    return float(max_violation(sim.shake, x, sim.box.lengths))


def phase_nlist_deck(name: str, step0_ref: dict, full: dict, drift_gate,
                     kernels: tuple, thermo: int = 50, replicate=None,
                     recip_ref: dict | None = None):
    """A neighbor-list deck through build_simulation and run as run_deck
    calls them, launch counts set to 0 just before and read just after:
    the Simulation engine, the record's generic mesh, g_ewald and cells,
    step 0 under the _STEP0_FIELDS rule, the NVE drift under its gate,
    every kernel of the path launched, and with fix shake the constraint
    violation within the deck's tol at every thermo row.  With
    ``recip_ref`` (a record with elong_recip) the step-0 reciprocal part
    of elong is held to it too (``recip_check``): the generic mesh is not
    the record's, but the solvers agree far inside RECIP_TOL.  Returns the
    launches, ms/step, the step-0 row and the engine."""
    from lammps_buck_intel_tpu_torch.integrate import Simulation

    cfg = load_deck(name)
    cfg["thermo"] = thermo
    if replicate is not None:
        cfg["replicate"] = list(replicate)
        name = f"{name} x{'x'.join(map(str, replicate))}"
    ops.reset_launches()
    sim = build_simulation(cfg, device="cuda")
    viol = []
    if sim.shake is not None:
        thermo_row = sim.thermo

        def thermo_with_violation():
            row = thermo_row()
            viol.append(nlist_violation(sim))
            return row

        sim.thermo = thermo_with_violation
    steps = int(cfg["run"])
    rows = sim.run(steps, thermo_every=thermo, log=False)
    ran = dict(ops.LAUNCHES)
    n = sim.n_atoms
    missing = [k for k in kernels if ran[k] <= 0]
    if (not isinstance(sim, Simulation) or missing or n != full["n_atoms"]
            or rows[-1]["step"] != steps):
        raise AssertionError(f"{name}: {type(sim).__name__}, {n} atoms, "
                             f"{rows[-1]['step']} steps, kernels not "
                             f"launched {missing}")
    pm = sim.kspace
    if (list(pm.grid) != full["pppm_grid"]
            or abs(pm.g_ewald - full["g_ewald"]) > 1e-12 * full["g_ewald"]
            or list(sim.spec.nc) != full["spec"]["nc"]
            or sim.spec.cutneigh != full["spec"]["cutneigh"]):
        raise AssertionError(f"{name}: mesh, g_ewald or cells differ from "
                             "the JAX host set-up (torch_nlist.json)")
    row = rows[0]
    step0_check(name, row, step0_ref, n)
    if recip_ref is not None:
        recip_check(name, row, pm.elong_self, recip_ref)
    e0 = row["etotal"]
    drift = max(abs(r["etotal"] - e0) for r in rows) / n
    for r in rows:
        for k in ("temp", "epair", "emol", "etotal", "press"):
            if not np.isfinite(r[k]):
                raise AssertionError(f"{name}: non-finite {k}")
    if not drift <= drift_gate:
        raise AssertionError(f"{name}: drift {drift:.3e}/atom > gate "
                             f"{drift_gate}")
    if sim.shake is not None:
        tol = next(f["tol"] for f in cfg["fixes"] if f["name"] == "shake")
        print(f"[nlist deck] {name}: violation max|r^2/d^2 - 1| " + ", ".join(
            f"{v:.3e} @ {r['step']}" for v, r in zip(viol, rows))
            + f" (gate {tol})")
        if len(viol) != len(rows) or not max(viol) <= tol:
            raise AssertionError(f"{name}: constraint violation {viol} over "
                                 f"the deck's tol {tol}")
    wall = sim.timings["run"]
    print(f"[nlist deck] {name}: {n} atoms x {steps} steps in {wall:.3f} s "
          f"-> {n * steps / wall:,.0f} atom-steps/s, "
          f"{1e3 * wall / steps:.4f} ms/step (thermo every {thermo}); mesh "
          f"{pm.grid} (the generic mesh of the box; the cell engine's is "
          f"cell-aligned, so elong differs by the solver's accuracy, which "
          f"the step-0 rule admits), K {sim.spec.kmax}, cells "
          f"{sim.spec.nc} cap {sim.spec.cell_cap}; step 0 temp "
          f"{row['temp']:.6g} etotal {e0:.8g} elong {row['elong']:.8g} press "
          f"{row['press']:.6g} (record {step0_ref['temp']:.6g}, "
          f"{step0_ref['etotal']:.8g}, {step0_ref['elong']:.8g}, "
          f"{step0_ref['press']:.6g}); drift {drift:.3e}/atom (gate "
          f"{drift_gate}); launches {ran}")
    return dict(launches=ran, ms_step=1e3 * wall / steps, row=row, sim=sim)


def phase_nlist_cristobalite(golden: dict, nlist_rec: dict, cell_ms: float):
    """cristobalite_pppm_nlist.yaml at 259,200 atoms, f32, 100 steps (the
    binned build K9a, the list pair pass K9b, K10 on the generic mesh),
    held to the cell engine's record (step 0, the silica drift gate),
    beside the cell engine's ms/step of this run; then K10 against its
    plain version on the run's last state and timed there."""
    r = phase_nlist_deck(
        "cristobalite_pppm_nlist.yaml", golden["row"],
        nlist_rec["full"]["cristobalite_pppm_nlist"],
        load_golden("long_silica_pppm.json")["drift_gate"],
        NLIST_PATH + NLIST_PPPM + ("nlist_build",), recip_ref=golden)
    n = r["sim"].n_atoms
    print(f"[nlist deck] cristobalite at {n} atoms: list engine "
          f"{r['ms_step']:.4f} ms/step ({n / r['ms_step'] * 1e3:,.0f} "
          f"atom-steps/s), cell engine {cell_ms:.4f} ms/step "
          f"({n / cell_ms * 1e3:,.0f}) in this run")
    sim = r.pop("sim")
    x, q, pm = sim.state.x, sim.q, sim.kspace
    err = _k10_compare(f"cristobalite {n} atoms/single", pm, x, q, x.dtype)
    r["k10"] = dict(_k10_time(pm, x, q), max_abs_err=err)
    del sim, x, q, pm
    torch.cuda.empty_cache()
    return r


def phase_nlist_k10_f64():
    """K10 in f64 on one jittered copy of the cristobalite crystal (its
    generic mesh) against its plain version."""
    sim = _nlist_sim("cristobalite_pppm_nlist.yaml", "double", (1, 1, 1),
                     jitter=0.1)
    _k10_compare(f"cristobalite {sim.n_atoms} atoms/double", sim.kspace,
                 sim.state.x, sim.q, sim.state.x.dtype)
    del sim
    torch.cuda.empty_cache()


def phase_nlist_rhodo(shake_rec: dict, nlist_rec: dict, cell: dict,
                      k1_device_ms: float):
    """rhodo_nve_nlist.yaml (NVE + SHAKE + the CHARMM stack) at 31,104
    atoms and at replicate [6, 6, 4]: step 0 against long_rhodo_nve.json
    (the record scaled to 144 copies at 6x6x4), the drift gate 1.3e-3, the
    constraints within tol at every row; ms/step beside rhodo_nve.yaml on
    the cell engine in this run, and at 248,832 atoms the list pair
    pass's device time (K9b, on the run's own list) beside K1's on the
    same atoms."""
    from lammps_buck_intel_tpu_torch.models.pair import driver

    nve_rec = load_golden("long_rhodo_nve.json")
    gate = nve_rec["drift_gate"]
    path = (NLIST_PATH + NLIST_PPPM + ("nlist_build",) + BONDED_KERNELS
            + NLIST_SHAKE)
    small = phase_nlist_deck("rhodo_nve_nlist.yaml", nve_rec["rows"][0],
                             nlist_rec["full"]["rhodo_nve_nlist"], gate,
                             path)
    del small["sim"]
    key = "x".join(map(str, BIG_REPLICATE))
    big = phase_nlist_deck("rhodo_nve_nlist.yaml",
                           shake_rec["full"][key]["row"],
                           nlist_rec["full"][f"rhodo_nve_nlist_{key}"],
                           gate, path, replicate=BIG_REPLICATE)
    sim = big.pop("sim")
    from lammps_buck_intel_tpu_torch.core.box import wrap

    x, _ = wrap(sim.state.x, sim.state.image, sim._lo, sim._boxL)
    nl = sim._build(x)
    k9b = device_ms(lambda: driver.compute_pair(
        sim.pair, x, sim.typ, sim.q, sim._boxL, nl, eflag=False,
        acc_dtype=sim.precision.acc, use_special=True))
    entries = float(nl.nnei.double().mean())
    for size, r, c in ((31104, small, cell["small_ms_step"]),
                       (sim.n_atoms, big, cell["ms_step"])):
        print(f"[nlist deck] rhodo_nve at {size} atoms: list engine "
              f"{r['ms_step']:.4f} ms/step ({size / r['ms_step'] * 1e3:,.0f}"
              f" atom-steps/s), cell engine {c:.4f} ms/step "
              f"({size / c * 1e3:,.0f}) in this run")
    print(f"[nlist deck] rhodo_nve at {sim.n_atoms} atoms: pair pass device "
          f"time K9b {k9b:.4f} ms (K {sim.spec.kmax}, {entries:.1f} entries "
          f"an atom) against K1 lj/charmm + specials {k1_device_ms:.4f} ms "
          f"on the same atoms (rhodo_flex x6x6x4, the same pair terms)")
    big.update(small_ms_step=small["ms_step"], k9b_device_ms=k9b)
    del sim, x, nl
    torch.cuda.empty_cache()
    return big


def record_run(label, sim, r, need):
    """A deck built on the card in f64, held to the JAX package's record r
    (tests/goldens/torch_nlist.json, torch_ewald.json): the atoms and the
    list sizing, the step-0 forces, every row, the final positions (of the
    box length), images and chain (where the record has one) within
    NLIST_RECORD_TOL, every kernel of ``need`` launched since the counts
    were last set to 0."""
    spec = dict(cutneigh=sim.spec.cutneigh, kmax=sim.spec.kmax,
                nc=None if sim.spec.nc is None else list(sim.spec.nc))
    if sim.n_atoms != r["n_atoms"] or spec != r["spec"]:
        raise AssertionError(f"{label}: atoms or list differ from the record")
    pick = np.asarray(r["atoms"])
    f0 = sim.get_atoms()["f"][pick]
    rows = sim.run(r["steps"], thermo_every=r["thermo_every"], log=False)
    at = sim.get_atoms()
    ref_f = np.asarray(r["f0"])
    L = float(np.max(sim.box.lengths))
    errs = {"f0": float(np.abs(f0 - ref_f).max() / np.abs(ref_f).max()),
            "x_end": float(np.abs(at["x"][pick] - np.asarray(r["x_end"]))
                           .max()) / L}
    therm = np.asarray(r.get("therm_end", []))
    if therm.size:
        errs["therm"] = float(np.abs(sim.state.therm.cpu().numpy()
                                     - therm).max() / np.abs(therm).max())
    for row, ref in zip(rows, r["rows"], strict=True):
        for k in ("temp", "evdwl", "ecoul", "elong", "emol", "etotal",
                  "press"):
            if ref[k] != 0.0 or row[k] != 0.0:
                errs[f"{k}@{ref['step']}"] = scalar_rel(row[k], ref[k])
    images = bool(np.array_equal(at["image"][pick],
                                 np.asarray(r["image_end"])))
    ran = dict(ops.LAUNCHES)
    print(f"{label} f64, {sim.n_atoms} atoms, K {sim.spec.kmax}, cells "
          f"{sim.spec.nc}: worst row "
          f"{max(v for k, v in errs.items() if '@' in k):.3e}, "
          + ", ".join(f"{k} {errs[k]:.3e}" for k in errs if "@" not in k)
          + f", images equal {images} (tol {NLIST_RECORD_TOL})")
    bad = {k: v for k, v in errs.items() if not v <= NLIST_RECORD_TOL}
    if bad or not images or any(ran[k] <= 0 for k in need):
        raise AssertionError(f"{label} disagrees with the JAX record or "
                             f"skipped a kernel: {bad}")


def phase_nlist_record(rec: dict):
    """The neighbor-list engine in f64 against the JAX package's record
    (tests/goldens/torch_nlist.json): the jittered cristobalite at 2x2x2
    (11,520 atoms, binned build, PPPM order 7) and one rhodo copy on
    engine nlist (NVT + SHAKE, PPPM order 5): the spec, mesh and g_ewald,
    step-0 forces, every row, the final positions (of the box length),
    images and chain within NLIST_RECORD_TOL."""
    for key, deck in (("cristobalite", "cristobalite_pppm_nlist.yaml"),
                      ("rhodo", "rhodo_class.yaml")):
        r = rec[key]
        ops.reset_launches()
        if key == "cristobalite":
            sim = _nlist_sim(deck, "double", r["replicate"], jitter=r["amp"])
        else:
            cfg = load_deck(deck)
            cfg.update(engine="nlist", precision="double",
                       replicate=r["replicate"])
            sim = build_simulation(cfg, device="cuda")
        if (list(sim.kspace.grid) != r["pppm_grid"]
                or sim.kspace.g_ewald != r["g_ewald"]):
            raise AssertionError(f"nlist record {key}: mesh or g_ewald "
                                 "differ from the record")
        need = NLIST_PATH + NLIST_PPPM + ("nlist_build",)
        if key == "rhodo":
            need += BONDED_KERNELS + NLIST_SHAKE + ("nhc_scale",)
        record_run(f"[nlist record] {key}", sim, r, need)
        del sim
        torch.cuda.empty_cache()


def phase_buck_small():
    """buck_small.yaml unedited through run_deck (what the CLI calls): the
    cell engine's box-too-small fallback into the neighbor-list engine with
    the dense build (K9c), launch counts set to 0 just before and read
    just after; rows finite, the NVE drift under buck's gate."""
    from lammps_buck_intel_tpu_torch.integrate import Simulation
    from lammps_buck_intel_tpu_torch.run import run_deck

    cfg = load_deck("buck_small.yaml")
    gate = load_golden("long_buck.json")["drift_gate"]
    ops.reset_launches()
    sim, rows = run_deck(cfg, device="cuda", log=False)
    ran = dict(ops.LAUNCHES)
    n, steps = sim.n_atoms, int(cfg["run"])
    missing = [k for k in NLIST_PATH + ("nlist_dense",) if ran[k] <= 0]
    if not isinstance(sim, Simulation) or not sim.spec.dense or missing:
        raise AssertionError(f"buck_small.yaml: {type(sim).__name__}, spec "
                             f"{sim.spec}, kernels not launched {missing}")
    for r in rows:
        for k in ("temp", "epair", "etotal", "press"):
            if not np.isfinite(r[k]):
                raise AssertionError(f"buck_small.yaml: non-finite {k}")
    drift = max(abs(r["etotal"] - rows[0]["etotal"]) for r in rows) / n
    wall = sim.timings["run"]
    print(f"[nlist deck] buck_small.yaml: {n} atoms on {type(sim).__name__} "
          f"(dense K {sim.spec.kmax}) x {steps} steps in {wall:.3f} s, "
          f"{1e3 * wall / steps:.4f} ms/step; rows " + ", ".join(
              f"{r['etotal']:.8g} @ {r['step']}" for r in rows)
          + f"; drift {drift:.6g}/atom (gate {gate}); launches {ran}")
    if not drift <= gate:
        raise AssertionError(f"buck_small.yaml: drift {drift:.3e}/atom > "
                             f"gate {gate}")
    return dict(launches=ran, ms_step=1e3 * wall / steps)


# ---- Ewald (K11a, K11b) and coul/cut on the neighbor-list Simulation ----

EWALD_PATH = NLIST_PATH + ("ewald_sk", "ewald_force")
# kernel against plain version on the card.  f64: 1e-12 relative.  f32:
# energy and virial the PPPM kernels' 1e-5; forces 3e-4 of the largest
# force, not TOL's 1e-4: each force is a sum over K = 31,248 k vectors
# whose terms are ~10^2 times the sum (the jittered crystal's forces are
# small), summed in f32 in another order by each (the kernel per thread in
# K ranges, the plain version through cuBLAS), so each sits ~4e-5 of
# max|f| from the f64 result on the same positions (printed) and the two
# differ by up to twice that.
EWALD_TOL = {torch.float32: (3e-4, 1e-5), torch.float64: (1e-12, 1e-12)}
# per (atom, k) pair: the phase 5 (3 multiplies, 2 adds), sine and cosine
# 2 (counted as one operation each, as exp is), then K11a's accumulation
# 4 (q cos, q sin, two adds) or K11b's 9 (s wre - c wim 3, three
# multiply-adds 6); per k vector K11a's epilogue 20 (the two partial sums,
# |S|^2 3, ug, qqrd2e, six virial products and seven sums)
# the f32 run of cristobalite_coul_cut.yaml against its f64 run on the
# card (_coul_cut_drift_f64): a deck that conserves no energy loses it at
# a rate that depends on the trajectory, and the f32 and f64 trajectories
# part as rounding grows: 2% of the f64 run's loss per atom over the 100
# steps bounds how far the two may part (both are printed)
COUL_CUT_DRIFT_REL = 0.02
OPS_EWALD_SK_PAIR = 11
OPS_EWALD_FORCE_PAIR = 16
OPS_EWALD_SK_K = 20


def _ewald_work(ew, n, flt, acc):
    """(bytes, operations) of K11a and K11b at n atoms (each input read
    once, each output written once)."""
    K = ew.kvecs.shape[0]
    fs = torch.empty((), dtype=flt).element_size()
    accs = torch.empty((), dtype=acc).element_size()
    sk = (n * 4 * fs + K * (4 * fs + 7 * accs) + K * (2 * accs + 2 * fs)
          + 7 * accs, n * K * OPS_EWALD_SK_PAIR + K * OPS_EWALD_SK_K)
    force = (n * 4 * fs + K * 5 * fs + 3 * n * accs,
             n * K * OPS_EWALD_FORCE_PAIR + 4 * n)
    return {"ewald_sk": sk, "ewald_force": force}


def _ewald_compare(label, ew, x, q):
    """Ewald.compute on the card (K11a, K11b) against ewald_compute_plain
    on the same card: forces, elong, its reciprocal part alone (the same
    solver with no self term, as _k10_compare holds K10's) and the
    virial; in f32 each one's forces against the f64 plain version on the
    same positions too (printed).  Returns the largest force
    difference."""
    import dataclasses

    from lammps_buck_intel_tpu_torch.models.kspace.ewald import \
        ewald_compute_plain

    ftol, etol = EWALD_TOL[x.dtype]
    rk = ew.compute(x, q, eflag=True, vflag=True)
    rp = ewald_compute_plain(ew, x, q, True, True)
    if x.dtype == torch.float32:
        e64 = dataclasses.replace(ew, acc_dtype=torch.float64, _consts={})
        f64 = torch.stack(ewald_compute_plain(e64, x.double(), q.double(),
                                              False, False).f)
        print(f"[K11] {label}: against the f64 plain version on the same "
              f"positions, forces of the kernels "
              f"{rel_err(torch.stack(rk.f).double(), f64):.3e}, of the f32 "
              f"plain version {rel_err(torch.stack(rp.f).double(), f64):.3e}")
        del f64
    recip = dataclasses.replace(ew, qsum=0.0, qsqsum=0.0, _consts={})
    ek_k = recip.compute(x, q, eflag=True, vflag=False).elong
    ek_p = ewald_compute_plain(recip, x, q, True, False).elong
    fk, fp = torch.stack(rk.f), torch.stack(rp.f)
    errs = {"f": rel_err(fk, fp), "elong": scalar_rel(rk.elong, rp.elong),
            "ek": scalar_rel(ek_k, ek_p),
            "virial": rel_err(rk.virial, rp.virial)}
    print(f"[K11] {label}: K {ew.kvecs.shape[0]} kmax {ew.kmax} g_ewald "
          f"{ew.g_ewald:.6f}; forces {errs['f']:.3e} of max|f| "
          f"{float(fp.abs().max()):.4g}, elong {errs['elong']:.3e} "
          f"({float(rk.elong):.10g} vs {float(rp.elong):.10g}), its "
          f"reciprocal part {errs['ek']:.3e} ({float(ek_k):.10g} vs "
          f"{float(ek_p):.10g}), virial {errs['virial']:.3e} (tol {ftol}, "
          f"{etol})")
    if not (errs["f"] <= ftol and errs["elong"] <= etol
            and errs["ek"] <= etol and errs["virial"] <= etol):
        raise AssertionError(f"Ewald {label} disagrees with its plain "
                             "version")
    return float((fk - fp).abs().max())


def phase_ewald_kernels():
    """K11a and K11b against ewald_compute_plain on the card, f32 and f64,
    on cristobalite_ewald.yaml's 11,520 atoms of the jittered crystal (K
    31,248); in f32 each kernel timed alone (CUDA events and the device
    trace), the plain version (which is also the matmul route: the phase
    and force products through cuBLAS, torch's cos and sin; it computes
    both kernels' work in one pass) and the bound of each kernel."""
    from lammps_buck_intel_tpu_torch.models.kspace.ewald import \
        ewald_compute_plain
    from lammps_buck_intel_tpu_torch.ops import ewald as ewald_ops

    out = {}
    for prec in ("double", "single"):
        sim = _nlist_sim("cristobalite_ewald.yaml", prec, jitter=0.1)
        ew, x, q = sim.kspace, sim.state.x, sim.q
        err = _ewald_compare(f"cristobalite_ewald {sim.n_atoms} atoms/"
                             f"{prec}", ew, x, q)
        if prec == "single":
            acc = ew.acc_dtype
            c = ew.consts(x.device, x.dtype)
            xs = tuple(x.unbind(0))
            sk = ewald_ops.ewald_sk(xs, q, c, ew.qqrd2e, acc)
            fns = {"ewald_sk": lambda: ewald_ops.ewald_sk(
                       xs, q, c, ew.qqrd2e, acc),
                   "ewald_force": lambda: ewald_ops.ewald_force(
                       xs, q, c, sk.wre, sk.wim, ew.qqrd2e, acc)}
            plain_ms = cuda_ms(lambda: ewald_compute_plain(ew, x, q, False,
                                                           False), reps=3)
            work = _ewald_work(ew, sim.n_atoms, x.dtype, acc)
            for name, fn in fns.items():
                ms, dev_ms = cuda_ms(fn), device_ms(fn)
                b_ms, b_by = bound(*work[name])
                print(f"[K11] {name} f32 at {sim.n_atoms} atoms, K "
                      f"{ew.kvecs.shape[0]}: kernel {ms:.4f} ms (device "
                      f"{dev_ms:.4f}), bound {b_ms:.5f} ms ({b_by}; "
                      f"{work[name][1]:.4g} operations, {work[name][0]:,} "
                      "bytes)")
                out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 max_abs_err=err, library_ms=None)
            print(f"[K11] matmul route (ewald_compute_plain, force-only: "
                  f"cuBLAS phase and force products, torch cos / sin, both "
                  f"kernels' work): {plain_ms:.4f} ms; the two kernels "
                  f"{out['ewald_sk']['ms'] + out['ewald_force']['ms']:.4f} "
                  "ms")
        del sim, ew, x, q
        torch.cuda.empty_cache()
    return out


def phase_ewald_record(rec: dict):
    """cristobalite_ewald.yaml at 1x1x2 (2,880 atoms, K 8,820) and
    cristobalite_coul_cut.yaml at one copy (1,440 atoms) of the jittered
    crystal, f64, 20 steps on the card, against the JAX package's record:
    the k set's size, g_ewald and self energy too."""
    for key in ("ewald_traj", "coul_cut_traj"):
        r = rec[key]
        ops.reset_launches()
        sim = _nlist_sim(r["deck"], "double", r["replicate"], jitter=r["amp"])
        need = NLIST_PATH
        if key == "ewald_traj":
            ew = sim.kspace
            if ((ew.g_ewald, list(ew.kmax), ew.kvecs.shape[0])
                    != (r["g_ewald"], r["kmax"], r["n_k"])
                    or ew.elong_self != r["elong_self"]):
                raise AssertionError("ewald record: the k set differs")
            need = EWALD_PATH
        record_run(f"[ewald record] {key}", sim, r, need)
        del sim
        torch.cuda.empty_cache()


def _deck_run(name, step0, gate, need, rec_spec):
    """A deck unedited through build_simulation and run on the card in
    f32, launch counts set to 0 just before and read just after: the
    Simulation engine, the JAX list sizing, step 0 under the _STEP0_FIELDS
    rule, finite rows, the NVE drift max |etotal - e0| / N under ``gate``
    (the caller's, where None), every kernel of ``need`` launched.
    Returns the launches, ms/step, the step-0 row, the drift and the
    engine."""
    from lammps_buck_intel_tpu_torch.integrate import Simulation

    cfg = load_deck(name)
    ops.reset_launches()
    sim = build_simulation(cfg, device="cuda")
    steps = int(cfg["run"])
    rows = sim.run(steps, thermo_every=int(cfg["thermo"]), log=False)
    ran = dict(ops.LAUNCHES)
    n = sim.n_atoms
    missing = [k for k in need if ran[k] <= 0]
    spec = dict(cutneigh=sim.spec.cutneigh, kmax=sim.spec.kmax,
                nc=list(sim.spec.nc))
    if (not isinstance(sim, Simulation) or missing
            or rows[-1]["step"] != steps
            or spec != {k: rec_spec[k] for k in spec}):
        raise AssertionError(f"{name}: {type(sim).__name__}, {n} atoms, spec "
                             f"{spec} (record {rec_spec}), kernels not "
                             f"launched {missing}")
    row = rows[0]
    step0_check(name, row, step0, n)
    for r in rows:
        for k in ("temp", "epair", "etotal", "press"):
            if not np.isfinite(r[k]):
                raise AssertionError(f"{name}: non-finite {k}")
    drift = max(abs(r["etotal"] - row["etotal"]) for r in rows) / n
    wall = sim.timings["run"]
    print(f"[ewald deck] {name}: {n} atoms x {steps} steps in {wall:.3f} s "
          f"-> {n * steps / wall:,.0f} atom-steps/s, "
          f"{1e3 * wall / steps:.4f} ms/step (thermo every {cfg['thermo']}); "
          f"K {sim.spec.kmax}, cells {sim.spec.nc}; step 0 temp "
          f"{row['temp']:.6g} ecoul {row['ecoul']:.8g} elong "
          f"{row['elong']:.8g} press {row['press']:.6g} (record "
          f"{step0['temp']:.6g}, {step0['ecoul']:.8g}, {step0['elong']:.8g},"
          f" {step0['press']:.6g}); rows " + ", ".join(
              f"{r['etotal']:.8g} @ {r['step']}" for r in rows)
          + f"; drift {drift:.6g}/atom (gate {gate}); launches {ran}")
    if gate is not None and not drift <= gate:
        raise AssertionError(f"{name}: drift {drift:.3e}/atom > gate {gate}")
    return dict(launches=ran, ms_step=1e3 * wall / steps, row=row, sim=sim,
                drift=drift)


def phase_ewald_deck(rec: dict):
    """cristobalite_ewald.yaml unedited at 11,520 atoms, 500 steps, f32
    (the binned build K9a, K9b's coul/long branch, K11a and K11b): the
    record's step-0 row, the reciprocal part of elong (elong - elong_self
    within RECIP_TOL of the record's, the self term to 1e-12), the k set
    of the record, and the NVE drift under long_silica_pppm.json's gate
    (the same chemistry and units: the JAX package has no buck_coul_long
    golden)."""
    r0 = rec["ewald_step0"]
    gate = load_golden("long_silica_pppm.json")["drift_gate"]
    r = _deck_run("cristobalite_ewald.yaml", r0["row"], gate,
                  EWALD_PATH + ("nlist_build",), r0["spec"])
    sim = r.pop("sim")
    ew = sim.kspace
    if ((ew.g_ewald, list(ew.kmax), ew.kvecs.shape[0])
            != (r0["g_ewald"], r0["kmax"], r0["n_k"])):
        raise AssertionError("cristobalite_ewald.yaml: the k set differs "
                             "from the record's")
    recip_check("cristobalite_ewald.yaml", r["row"], ew.elong_self, r0)
    del sim, ew
    torch.cuda.empty_cache()
    return r


def _coul_cut_drift_f64(name: str, r0: dict) -> float:
    """The drift gate of cristobalite_coul_cut.yaml.  The truncated,
    unshifted Coulomb sum conserves no energy on the ideal crystal: the
    JAX package's own f64 run at 11,520 atoms loses 7.93 eV an atom in
    100 steps (torch_ewald.json), far over the silica gate of 5e-3, and
    the loss grows with the system, so that record is no gate for the
    92,160-atom deck.  Here the port runs the deck in f64 on the card (1)
    at the record's 11,520 atoms, every row and the drift held to the
    record within NLIST_RECORD_TOL, then (2) at the deck's full size: that
    run's drift is the gate of the deck's f32 run (returned)."""
    drifts = []
    for rep in (r0["recorded_at"]["replicate"], None):
        cfg = load_deck(name)
        cfg["precision"] = "double"
        if rep is not None:
            cfg["replicate"] = list(rep)
        sim = build_simulation(cfg, device="cuda")
        rows = sim.run(int(cfg["run"]), thermo_every=int(cfg["thermo"]),
                       log=False)
        n = sim.n_atoms
        drifts.append(max(abs(r["etotal"] - rows[0]["etotal"])
                          for r in rows) / n)
        if rep is not None:
            errs = {f"{k}@{ref['step']}": scalar_rel(row[k], ref[k])
                    for row, ref in zip(rows, r0["recorded_at"]["rows"],
                                        strict=True)
                    for k in ("temp", "evdwl", "ecoul", "etotal", "press")}
            errs["drift"] = scalar_rel(drifts[-1], r0["drift"])
            print(f"[ewald deck] {name} f64 at {n} atoms on the card: drift "
                  f"{drifts[-1]:.10g} eV/atom (record {r0['drift']:.10g}); "
                  f"worst row {max(errs.values()):.3e} (tol "
                  f"{NLIST_RECORD_TOL})")
            if not max(errs.values()) <= NLIST_RECORD_TOL:
                raise AssertionError(f"{name} f64 at {n} atoms disagrees "
                                     "with the JAX record")
        else:
            print(f"[ewald deck] {name} f64 at {n} atoms on the card: drift "
                  f"{drifts[-1]:.10g} eV/atom, etotal/N "
                  + ", ".join(f"{r['etotal'] / n:.6f} @ {r['step']}"
                              for r in rows))
        del sim
        torch.cuda.empty_cache()
    return drifts[-1]


def phase_coul_cut(rec: dict):
    """The coul/cut branch of K1 and K9b against their plain versions at
    cristobalite_coul_cut.yaml's 92,160 atoms of the jittered crystal (K1
    on the cell engine's grid of the same deck, f32, and timed there; K9b
    on the list engine's list, f32 and f64); K9b timed there beside its
    coul/long
    branch on the same list (the same coefficients with g_ewald 0.3);
    then the deck unedited at 92,160 atoms, 100 steps, f32: the record's
    step-0 row scaled from 11,520 atoms, elong 0 with the Coulomb energy
    in ecoul, and the drift within COUL_CUT_DRIFT_REL of the deck's f64
    run on the card (``_coul_cut_drift_f64``)."""
    from lammps_buck_intel_tpu_torch.models.pair import driver
    from lammps_buck_intel_tpu_torch.models.pair.styles import PairConfig

    name = "cristobalite_coul_cut.yaml"
    cfg = load_deck(name)
    sim, st = jittered_state(dict(cfg, engine="cellpair"), "single")
    err = _k1_compare(f"coul_cut {sim.grid.n_atoms} atoms/single", sim.pair,
                      sim.grid, sim.box, st, sim.precision.acc)
    k1 = dict(_k1_time("coul_cut", sim, st), max_abs_err=err)
    del sim, st
    torch.cuda.empty_cache()
    out = {"k1": k1}
    for prec in ("double", "single"):
        sim = _nlist_sim(name, prec, jitter=0.1)
        x, boxL = sim.state.x, sim._boxL
        nl = sim._build(x)
        ftol, etol = TOL[x.dtype]
        acc = sim.precision.acc
        args = (sim.pair, x, sim.typ, sim.q, boxL, nl)
        for ev in (False, True):
            kw = dict(eflag=ev, acc_dtype=acc, use_special=False)
            rk = driver.compute_pair(*args, **kw)
            rp = driver.compute_pair_plain(*args, **kw)
            errs = {"f": rel_err(torch.stack(rk[:3]), torch.stack(rp[:3])),
                    "virial": rel_err(rk.virial, rp.virial)}
            if ev:
                errs.update(evdwl=scalar_rel(rk.evdwl, rp.evdwl),
                            ecoul=scalar_rel(rk.ecoul, rp.ecoul))
            print(f"[K9b] coul_cut {sim.n_atoms} atoms/{prec} ev={ev}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f" (tol {ftol}, {etol})")
            if not (errs["f"] <= ftol
                    and all(v <= etol for k, v in errs.items() if k != "f")):
                raise AssertionError(f"K9b coul/cut {prec} disagrees with "
                                     "its plain version")
            if not ev:
                err = float((torch.stack(rk[:3])
                             - torch.stack(rp[:3])).abs().max())
        if prec == "single":
            n = sim.n_atoms
            kw = dict(eflag=False, acc_dtype=acc, use_special=False)
            long = sim.pair.replace(
                cfg=PairConfig("buck/coul/long", "buck", "long", "cut"),
                g_ewald=0.3)

            def kern():
                return driver.compute_pair(*args, **kw)

            ms, dev_ms = cuda_ms(kern), device_ms(kern)
            plain_ms = cuda_ms(lambda: driver.compute_pair_plain(*args, **kw),
                               reps=3)
            long_dev = device_ms(lambda: driver.compute_pair(
                long, *args[1:], **kw))
            entries = int(torch.minimum(nl.nnei, torch.tensor(
                nl.idx.shape[1], device=nl.nnei.device)).sum())
            pairs = list_pairs_in_cutoff(x, boxL, nl, sim.pair.cutsq_max)
            fs = x.element_size()
            b_ms, b_by = bound(list_pass_bytes(entries, n, fs, False,
                                               3 * n * 4),
                               entries * OPS_LIST_ENTRY + pairs * (
                                   OPS_PAIR[("buck", "cut")] - 9 + 15))
            print(f"[K9b] nlist_pair coul/cut f32 at {n} atoms, K "
                  f"{sim.spec.kmax} ({entries / n:.1f} entries, "
                  f"{pairs / n:.1f} in the cutoff an atom): kernel {ms:.4f} "
                  f"ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by}); the coul/long branch on the "
                  f"same list: device {long_dev:.4f} ms")
            out.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                       library_ms=None, long_device_ms=long_dev)
        del sim, x, nl, args
        torch.cuda.empty_cache()
    r0 = rec["coul_cut_step0"]
    d64 = _coul_cut_drift_f64(name, r0)
    r = _deck_run(name, r0["row"], None, NLIST_PATH + ("nlist_build",),
                  r0["spec"])
    d32 = r["drift"]
    print(f"[ewald deck] {name}: f32 drift {d32:.6g} eV/atom against the "
          f"f64 run's {d64:.6g} at the same size (|d| {abs(d32 - d64):.3g}, "
          f"gate {COUL_CUT_DRIFT_REL} of it)")
    if not abs(d32 - d64) <= COUL_CUT_DRIFT_REL * d64:
        raise AssertionError(f"{name}: f32 drift {d32:.6g} is not the f64 "
                             f"run's {d64:.6g}")
    sim = r.pop("sim")
    if r["row"]["elong"] != 0.0 or sim.kspace is not None:
        raise AssertionError(f"{name}: a k-space term on a coul/cut deck")
    del sim
    torch.cuda.empty_cache()
    out.update(launches=r["launches"], ms_step=r["ms_step"])
    return out


# ---- the hexane path: lj/long + pppm/disp (K12a) + fix rigid/small (K15) ----

HEX_DECK, HEX_BIG = "hexane_gen.yaml", "hexane_gen_big.yaml"
HEX_COPIES = 32          # hexane_gen_big.yaml: replicate [2, 4, 4]
HEX_PATH = ("cellpair", "rebin_incremental", "pppm_deposit_cells",
            "disp_spectral", "pppm_gather", "rigid_force_torque",
            "rigid_update", "rigid_virial", "verlet_ke")
# f64 on the card against the JAX record (tests/goldens/torch_disp.json):
# the CPU parity tolerance of tests/test_torch_rigid.py
HEX_F64_TOL = 1e-9
# f32 step-0 thermo against the record: the bound the JAX suite grants its
# two dispersion pipelines (tests/test_hexane.py:80-81)
HEX_F32_TOL = 2e-5
# relative etotal drift of the f32 run: tests/test_hexane.py:53's gate, or
# the record's own drift plus it where the JAX f64 run drifts more
HEX_DRIFT = 5e-4
# per pair inside the cutoff (lj/long, disp long): distance 8, clamp 1,
# 1/r^2 and r 2, r^-6 2, lj1 r^-12 2, g6^2 r^2 1, 1/x 1, exp 1, x2 2, the
# polynomial 7, the force 3, scalar 1, both atoms' forces 9
OPS_PAIR_DISP = 40
# K12a per half-spectrum point and channel: chi 2 (one channel), phi 2,
# three ik spectra 6
OPS_DISP_SPECTRAL_PT = 10
# K15a per atom: the force (3), d x f (9), the sums (6); K15b per body
# (initial form): the kicks and drift 15, Richardson's four qdot (~50
# each) and normalisations (~12 each), per atom the rotation 27 and the
# position 6; K15c per body ~80 (two rotations, Euler), per atom ~40
OPS_RIGID_FT_ATOM = 18
OPS_RIGID_UPDATE_BODY, OPS_RIGID_UPDATE_ATOM = 263, 33
OPS_RIGID_VIRIAL_BODY, OPS_RIGID_VIRIAL_ATOM = 80, 40


def _hex_sim(name: str, precision: str, **kw):
    cfg = load_deck(name)
    cfg.update(precision=precision, **kw)
    return cfg, build_simulation(cfg, device="cuda")


def _hex_disp_stages(label, sim, st, out=None):
    """K5, K12a and K8 on the dispersion mesh against their plain versions
    (the dispersion charge B[type] of each slot as q); K12a with e/v and
    without, and with the seven arithmetic channels of the deck's eps,
    sigma on the same mesh (its channel loop).  Returns the largest force
    difference."""
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as pd

    solver = sim.kspace
    pm, pmd = solver.pm, solver.pmd
    flt, acc, n = st.x.dtype, pmd.acc_dtype, sim.n_atoms
    ftol, etol = TOL[flt]
    c = pmd.consts(st.x.device, flt)
    bst = st._replace(q=solver._slot_b(st))
    res = {}
    # the deposit the deck runs: K5 by cell where the brick fits
    mesh_k = pppm_cells.deposit(pm, bst, n, c, bricks=solver.bricks)
    mesh_p = pppm_cells.deposit_plain(pm, bst)
    _pppm_compare(label, "deposit_disp", mesh_k, mesh_p, ftol, res)
    S = torch.fft.rfftn(mesh_p.to(acc)).contiguous()[None]
    for ev in (False, True):
        ek, esk, vsk = pd.disp_spectral(c, S, pmd.P, ev)
        ep, esp, vsp = pd.disp_spectral_plain(c, S, pmd.P, ev)
        _pppm_compare(label, "disp_spectral", torch.view_as_real(ek),
                      torch.view_as_real(ep), ftol, res)
        if ev:
            e_err, v_err = scalar_rel(esk, esp), rel_err(vsk, vsp)
            print(f"[K12a] {label} e/v: energy sum rel {e_err:.3e}, virial "
                  f"rel {v_err:.3e}")
            if not (e_err <= etol and v_err <= etol):
                raise AssertionError(f"K12a {label}: energy or virial off")
    e_mesh = (torch.fft.irfftn(ep[0], s=pm.grid, dim=(1, 2, 3))
              * (float(np.prod(pm.grid)) / pm.volume)).to(flt).contiguous()
    fk = torch.stack(pppm_ops.gather(pm, bst, e_mesh, n, acc, c["coef"]))
    fp = torch.stack(pppm_cells.gather_plain(pm, bst, e_mesh, acc))
    _pppm_compare(label, "gather_disp", fk, fp, ftol, res)
    # the arithmetic channels (A, P of the deck's eps and sigma)
    eps = np.array([0.1744742, 0.1147228])
    A, P = pd.mixing_channels("arithmetic", epsilon=eps,
                              sigma=np.array([3.97, 3.97]))
    a = torch.as_tensor(A).to(st.x.device, flt)[:, st.typ.long()]
    a = torch.where(st.aid < n, a, torch.zeros_like(a))
    S7 = torch.fft.rfftn(torch.stack([
        pppm_cells.deposit_plain(pm, st._replace(q=a[ch].contiguous()))
        for ch in range(A.shape[0])]).to(acc), dim=(1, 2, 3)).contiguous()
    ek, esk, vsk = pd.disp_spectral(c, S7, P, True)
    ep, esp, vsp = pd.disp_spectral_plain(c, S7, P, True)
    _pppm_compare(label + " 7 channels", "disp_spectral",
                  torch.view_as_real(ek), torch.view_as_real(ep), ftol, {})
    e_err, v_err = scalar_rel(esk, esp), rel_err(vsk, vsp)
    print(f"[K12a] {label} 7 channels e/v: energy sum rel {e_err:.3e}, "
          f"virial rel {v_err:.3e}")
    if not (e_err <= etol and v_err <= etol):
        raise AssertionError(f"K12a {label} 7 channels: energy or virial off")
    if out is not None:
        out.update(res)
    return float((fk - fp).abs().max())


def _hex_rigid_stages(label, sim, st, width=None):
    """K15a, K15b (its three forms) and K15c against their plain versions
    on the state's bodies and slot layout, with the forces of this state.
    Returns the largest absolute differences: body force and torque, the
    initial form's positions, the virial."""
    from lammps_buck_intel_tpu_torch.integrate import rigid as rgd

    t, acc = sim._rt, sim.precision.acc
    ftol, etol = TOL[st.x.dtype]
    inv = sim._inv_map(st)
    fa, fb, *_ = sim._forces(st, False, False, sim._slot_mol(st))

    def check(name, k, p, tol, scale=None):
        scale = float(p.abs().max()) if scale is None else scale
        err = float((k - p).abs().max()) / max(scale, 1e-300)
        if not err <= tol:
            raise AssertionError(f"K15 {name} {label} width {width}: "
                                 f"{err:.3e} > {tol}")
        return err

    def cl(planes):
        return tuple(p.clone() for p in planes)

    fo_k, fo_p = cl((st.fx, st.fy, st.fz)), cl((st.fx, st.fy, st.fz))
    Fk, Tk = rgd.slot_force_torque(t, sim._d, inv, fa, fb, fo_k, width)
    Fp, Tp = rgd.slot_force_torque_plain(t, sim._d, inv, fa, fb, fo_p)
    errs = {"F": check("F", Fk, Fp, ftol), "T": check("T", Tk, Tp, ftol),
            "f_out": check("f_out", torch.stack(fo_k), torch.stack(fo_p),
                           ftol)}
    vk = rgd.slot_constraint_virial(t, sim.body, sim._d, inv, fa, fb, Tp,
                                    sim.units.ftm2v, acc, width)
    vp = rgd.slot_constraint_virial_plain(t, sim.body, sim._d, inv, fa, fb,
                                          Tp, sim.units.ftm2v, acc)
    errs["virial"] = check("virial", vk, vp, etol)
    off_k = tuple(torch.zeros_like(st.x) for _ in range(3))
    off_p = tuple(torch.zeros_like(st.x) for _ in range(3))
    for mode, name in ((rgd.MODE_OFFSETS, "offsets"),
                       (rgd.MODE_INITIAL, "initial"),
                       (rgd.MODE_FINAL, "final")):
        bk, bp = sim.body.clone(), sim.body.clone()
        dk, dp = sim._d.clone(), sim._d.clone()
        pk = cl((st.vx, st.vy, st.vz) if mode == rgd.MODE_FINAL
                else (st.x, st.y, st.z))
        pp = cl(pk)
        rgd.rigid_update(t, bk, dk, inv, pk, off_k, Fp, Tp, sim.dtv,
                         sim.dtf, mode, width)
        rgd.rigid_update_plain(t, bp, dp, inv, pp, off_p, Fp, Tp, sim.dtv,
                               sim.dtf, mode)
        for field, a, b in zip(("X", "V", "q", "L"), bk, bp):
            errs[f"{name} {field}"] = check(f"{name} {field}", a, b, ftol)
        errs[f"{name} d"] = check(f"{name} d", dk, dp, ftol)
        scale = float(torch.stack(pp).abs().max())
        errs[f"{name} planes"] = check(f"{name} planes", torch.stack(pk),
                                       torch.stack(pp), ftol, scale)
        if mode == rgd.MODE_OFFSETS:
            # x - (X + d) is zero to rounding: held to the positions' scale
            errs["offsets off"] = check("off", torch.stack(off_k),
                                        torch.stack(off_p), ftol, scale)
        if mode == rgd.MODE_INITIAL:
            pos_err = float((torch.stack(pk) - torch.stack(pp)).abs().max())
    print(f"[K15] {label} width {width}: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    return dict(ft=float(max((Fk - Fp).abs().max(), (Tk - Tp).abs().max())),
                update=pos_err, virial=float((vk - vp).abs().max()))


def phase_hexane_kernels():
    """K1's lj/long + exclusion branch, K5 / K12a / K8 on the dispersion
    mesh and K15a-c against their plain versions on hexane_gen.yaml's
    6,000 atoms, f64 and f32 (K15 at both lane widths)."""
    for prec in ("double", "single"):
        _, sim = _hex_sim(HEX_DECK, prec)
        st, acc = sim.state, sim.precision.acc
        label = f"hexane/{prec}"
        _k1_compare(label, sim.pair, sim.grid, sim.box, st, acc,
                    slot_mol=sim._slot_mol(st))
        _hex_disp_stages(label, sim, st)
        for width in (None, 32):
            _hex_rigid_stages(label, sim, st, width)
        del sim, st
        torch.cuda.empty_cache()


def _row_close(a, b, tol):
    return abs(a - b) <= tol * max(abs(b), 1.0)


def phase_hexane_record(rec: dict):
    """hexane_gen.yaml in f64 on the card, 50 steps, thermo every 10,
    against the JAX package's record: the mesh, g_ewald_6, the cell grid,
    the removed degrees of freedom and the host terms of elong to 1e-12,
    every row within HEX_F64_TOL (of max(|value|, 1)), the positions of
    every 60th atom at step 50 within HEX_F64_TOL of the box length and
    their image flags."""
    s0, tr = rec["step0"], rec["traj"]
    ops.reset_launches()
    _, sim = _hex_sim(HEX_DECK, "double")
    pmd = sim.kspace.pmd
    if (list(pmd.grid) != s0["mesh"] or pmd.g_ewald_6 != s0["g_ewald_6"]
            or list(sim.grid.nc) != s0["nc"] or sim.grid.cap != s0["cap"]
            or sim.rigid.n_constraints != s0["n_constraints"]
            or abs(sim.kspace.elong_const - s0["elong_const"])
            > 1e-12 * abs(s0["elong_const"])):
        raise AssertionError(
            f"hexane record: mesh {pmd.grid} g6 {pmd.g_ewald_6} cells "
            f"{sim.grid.nc} cap {sim.grid.cap} Nc {sim.rigid.n_constraints} "
            f"elong_const {sim.kspace.elong_const!r} differ from the "
            "record's")
    rows = sim.run(tr["steps"], thermo_every=tr["every"], log=False)
    ran = dict(ops.LAUNCHES)
    worst = 0.0
    for r, want in zip(rows, tr["rows"]):
        for k in ("temp", "evdwl", "elong", "epair", "ke", "etotal",
                  "press"):
            err = abs(r[k] - want[k]) / max(abs(want[k]), 1.0)
            worst = max(worst, err)
            if not err <= HEX_F64_TOL:
                raise AssertionError(
                    f"hexane f64 row {r['step']} {k}: {r[k]!r} vs record "
                    f"{want[k]!r}")
    atoms = sim.get_atoms()
    sel = np.asarray(tr["atoms"])
    L = float(np.max(np.asarray(sim.box.lengths)))
    x_err = float(np.abs(atoms["x"][sel] - np.asarray(tr["x_end"])).max())
    if (len(rows) != len(tr["rows"]) or not x_err <= HEX_F64_TOL * L
            or not np.array_equal(atoms["image"][sel],
                                  np.asarray(tr["image_end"]))
            or any(ran[k] <= 0 for k in HEX_PATH)):
        raise AssertionError(f"hexane f64: {len(rows)} rows, positions "
                             f"{x_err:.3e}, launches {ran}")
    print(f"[hexane record] f64 {sim.n_atoms} atoms x {tr['steps']} steps: "
          f"rows within {worst:.3e} of the record (tol {HEX_F64_TOL}), "
          f"positions {x_err:.3e} A, images equal; mesh {pmd.grid} cells "
          f"{sim.grid.nc} cap {sim.grid.cap}; step-0 elong "
          f"{rows[0]['elong']:.10g} = mesh sum "
          f"{rows[0]['elong'] - sim.kspace.elong_const:.10g} + host terms "
          f"{sim.kspace.elong_const:.10g} (record {s0['elong_mesh']:.10g} + "
          f"{s0['elong_const']:.10g})")
    del sim
    torch.cuda.empty_cache()


def _hex_deck_run(name, rec, copies=1):
    """A hexane deck unedited through build_simulation and run on the card
    in f32, launch counts set to 0 just before and read just after:
    every kernel of HEX_PATH launched, finite rows, step 0 against the
    record (scaled to ``copies``; epair, elong, etotal within HEX_F32_TOL
    of max(|value|, 1) at one copy, the _STEP0_FIELDS rule at 32), the
    relative etotal drift under the gate.  Returns the launches, ms/step,
    the sim and the drift."""
    s0 = rec["step0"]["row"]
    gate = max(HEX_DRIFT, rec["deck"]["drift"] + HEX_DRIFT) \
        if rec["deck"]["drift"] > HEX_DRIFT else HEX_DRIFT
    cfg = load_deck(name)
    ops.reset_launches()
    sim = build_simulation(cfg, device="cuda")
    steps = int(cfg["run"])
    rows = sim.run(steps, thermo_every=int(cfg["thermo"]), log=False)
    ran = dict(ops.LAUNCHES)
    missing = [k for k in HEX_PATH if ran[k] <= 0]
    if missing or rows[-1]["step"] != steps:
        raise AssertionError(f"{name}: kernels not launched {missing}")
    for r in rows:
        for k in ("temp", "epair", "etotal", "press"):
            if not np.isfinite(r[k]):
                raise AssertionError(f"{name}: non-finite {k}")
    row = rows[0]
    if copies == 1:
        for k in ("epair", "elong", "etotal"):
            if not _row_close(row[k], s0[k], HEX_F32_TOL):
                raise AssertionError(f"{name} step-0 {k}: {row[k]:.8g} vs "
                                     f"record {s0[k]:.8g}")
    else:
        ext = ("evdwl", "ecoul", "elong", "emol", "epair", "ke", "etotal")
        step0_check(name, row, {k: s0[k] * (copies if k in ext else 1)
                                for k in s0}, sim.n_atoms)
    e0 = row["etotal"]
    drift = max(abs(r["etotal"] - e0) for r in rows) / abs(e0)
    wall = sim.timings["run"]
    print(f"[hexane] {name}: {sim.n_atoms} atoms x {steps} steps in "
          f"{wall:.3f} s -> {sim.n_atoms * steps / wall:,.0f} atom-steps/s, "
          f"{1e3 * wall / steps:.4f} ms/step (thermo every {cfg['thermo']}); "
          f"mesh {sim.kspace.pmd.grid} cells {sim.grid.nc} cap "
          f"{sim.grid.cap}; step 0 epair {row['epair']:.8g} elong "
          f"{row['elong']:.8g} etotal {e0:.8g} (record x{copies}: "
          f"{s0['epair'] * copies:.8g}, {s0['elong'] * copies:.8g}, "
          f"{s0['etotal'] * copies:.8g}); rows " + ", ".join(
              f"{r['etotal']:.8g} @ {r['step']}" for r in rows)
          + f"; drift {drift:.3e} (gate {gate}; the JAX f64 record's own "
          f"{rec['deck']['drift']:.3e}); launches {ran}")
    if not drift <= gate:
        raise AssertionError(f"{name}: drift {drift:.3e} > gate {gate}")
    return dict(launches=ran, ms_step=1e3 * wall / steps, sim=sim,
                drift=drift)


def _hex_time(sim) -> dict:
    """Times at the big deck's last state (f32): K1's lj/long branch, K5 /
    K12a / K8 on the dispersion mesh and K15a-c, each beside its plain
    version, its bound and, where one PyTorch call does the same work, that
    call; K15a and K15b at both lane widths."""
    from lammps_buck_intel_tpu_torch.integrate import rigid as rgd
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as pd
    from lammps_buck_intel_tpu_torch.ops import rigid as rigid_ops

    st = cs.rebin_incremental(sim.grid, sim.box, sim.state.clone())
    out = {}
    mol = sim._slot_mol(st)
    style, grid, box = sim.pair, sim.grid, sim.box
    n, flt, acc = sim.n_atoms, st.x.dtype, sim.precision.acc
    fsz, asz = st.x.element_size(), torch.empty((), dtype=acc).element_size()

    def record(name, kern, plain, lib, nbytes, nops, err, reps_plain=3):
        ms, dev_ms = cuda_ms(kern), device_ms(kern)
        plain_ms = cuda_ms(plain, reps=reps_plain)
        lib_ms = cuda_ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, nops)
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=err)
        print(f"[hexane time] {name} f32 at {n} atoms: kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f}), plain {plain_ms:.4f} ms, library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
              f"{b_ms:.5f} ms ({b_by}; {nops:.4g} operations, "
              f"{int(nbytes):,} bytes)")

    # K1, lj/long with the exclusion
    err = _k1_compare(f"hexane_big/{n}", style, grid, box, st, acc,
                      slot_mol=mol)
    pairs = pairs_in_cutoff(style, grid, box, st, slot_mol=mol)
    record("cellpair_lj_long",
           lambda: compute_cellpair(style, grid, box, st, acc_dtype=acc,
                                    slot_mol=mol),
           lambda: compute_cellpair_plain(style, grid, box, st,
                                          acc_dtype=acc, slot_mol=mol),
           None,
           grid.nslots * 2 * 4 + n * (plane_bytes(st.x, st.y, st.z, st.typ)
                                      + 3 * asz),
           pairs * OPS_PAIR_DISP, err, reps_plain=1)
    cnt = _k1_counts(style, grid, box, st, slot_mol=mol)
    out["cellpair_lj_long"].update(hit_share=cnt["hit_share"],
                                   lane_use=cnt["lane_use"],
                                   tiles=cnt["tiles"])
    print(f"[hexane time] K1: {pairs:,} pairs of two molecules in the "
          f"cutoff; cells {grid.nc} cap {grid.cap}; hit share "
          f"{cnt['hit_share']:.4f}, lane use {cnt['lane_use']:.4f}, tested "
          f"an atom / cap {cnt['tiles']:.2f}")
    # K5 / K12a / K8 on the dispersion mesh
    res = {}
    kerr = _hex_disp_stages(f"hexane_big/{n}", sim, st, res)
    solver = sim.kspace
    pm, pmd = solver.pm, solver.pmd
    c = pmd.consts(st.x.device, flt)
    bst = st._replace(q=solver._slot_b(st))
    ns, ngrid = st.x.shape[0], int(np.prod(pm.grid))
    npts = int(np.prod(c["G"].shape))
    p = pm.order
    slot_in = ns * plane_bytes(st.x, st.y, st.z, st.q, st.aid)
    flat, w3 = pppm_cells._stencil(pm, bst, 0, ns,
                                   pppm_cells.mesh_geometry(pm))
    vals = (w3 * bst.q[:, None, None, None]).reshape(-1)
    flat = flat.reshape(-1)
    mesh0 = torch.zeros(ngrid, dtype=flt, device=st.x.device)
    record("pppm_deposit_disp",
           lambda: pppm_cells.deposit(pm, bst, n, c, bricks=solver.bricks),
           lambda: pppm_cells.deposit_plain(pm, bst),
           lambda: mesh0.clone().index_add_(0, flat, vals),
           slot_in + ngrid * fsz,
           n * (OPS_WEIGHTS(p) + p**3 * OPS_DEPOSIT_PT),
           res["deposit_disp"]["max_abs_err"])
    del flat, w3, vals
    mesh = pppm_cells.deposit_plain(pm, bst)
    S = torch.fft.rfftn(mesh.to(acc)).contiguous()[None]
    record("disp_spectral",
           lambda: pd.disp_spectral(c, S, pmd.P, False),
           lambda: pd.disp_spectral_plain(c, S, pmd.P, False), None,
           npts * asz * (2 + 1 + 6), npts * OPS_DISP_SPECTRAL_PT,
           res["disp_spectral"]["max_abs_err"])
    ehat, _, _ = pd.disp_spectral(c, S, pmd.P, False)
    e_mesh = (torch.fft.irfftn(ehat[0], s=pm.grid, dim=(1, 2, 3))
              * (ngrid / pm.volume)).to(flt).contiguous()
    record("pppm_gather_disp",
           lambda: pppm_ops.gather(pm, bst, e_mesh, n, acc, c["coef"]),
           lambda: pppm_cells.gather_plain(pm, bst, e_mesh, acc), None,
           slot_in + 3 * ngrid * fsz + 3 * ns * asz,
           n * (OPS_WEIGHTS(p) + p**3 * OPS_GATHER_PT), kerr)
    print(f"[hexane time] dispersion mesh {pm.grid} ({ngrid:,} points, "
          f"{npts:,} on the half spectrum), order {p}, g6 "
          f"{pmd.g_ewald_6:.6f}")
    del mesh, S, ehat, e_mesh
    # K15a-c
    t = sim._rt
    B = t.nbody
    inv = sim._inv_map(st)
    fa, fb, *_ = sim._forces(st, False, False, mol)
    errs = {w: _hex_rigid_stages(f"hexane_big/{n}", sim, st, w)
            for w in (None, 32)}
    d = sim._d
    f_atoms, _ = rgd._atom_force(t, inv, fa, fb, flt)
    dxf = torch.cross(d, f_atoms, dim=-1)
    F0 = torch.zeros((B, 3), dtype=flt, device=st.x.device)
    fo = tuple(torch.empty_like(st.x) for _ in range(3))
    ft_bytes = (n * (2 * 4 + 3 * fsz + 6 * asz + 3 * fsz)
                + (B + 1) * 4 + 6 * B * fsz)
    record("rigid_force_torque",
           lambda: rgd.slot_force_torque(t, d, inv, fa, fb, fo),
           lambda: rgd.slot_force_torque_plain(t, d, inv, fa, fb, fo),
           lambda: (F0.clone().index_add_(0, t.body_of, f_atoms),
                    F0.clone().index_add_(0, t.body_of, dxf)),
           ft_bytes, n * (OPS_RIGID_FT_ATOM + 3),
           max(e["ft"] for e in errs.values()))
    F, T = rgd.slot_force_torque(t, d, inv, fa, fb)
    bs = sim.body.clone()
    dd = d.clone()
    xs = tuple(p_.clone() for p_ in (st.x, st.y, st.z))
    off = tuple(torch.zeros_like(st.x) for _ in range(3))
    upd_bytes = (B * (26 + 6 + 4) * fsz + (B + 1) * 4
                 + n * (2 * 4 + 12 * fsz))
    record("rigid_update",
           lambda: rgd.rigid_update(t, bs, dd, inv, xs, off, F, T, sim.dtv,
                                    sim.dtf, rgd.MODE_INITIAL),
           lambda: rgd.rigid_update_plain(t, bs, dd, inv, xs, off, F, T,
                                          sim.dtv, sim.dtf,
                                          rgd.MODE_INITIAL),
           None, upd_bytes,
           B * OPS_RIGID_UPDATE_BODY + n * OPS_RIGID_UPDATE_ATOM,
           max(e["update"] for e in errs.values()))
    final_ms = cuda_ms(lambda: rgd.rigid_update(
        t, bs, dd, inv, None, None, F, T, sim.dtv, sim.dtf, rgd.MODE_FINAL))
    record("rigid_virial",
           lambda: rgd.slot_constraint_virial(t, sim.body, d, inv, fa, fb, T,
                                              sim.units.ftm2v, acc),
           lambda: rgd.slot_constraint_virial_plain(
               t, sim.body, d, inv, fa, fb, T, sim.units.ftm2v, acc),
           None,
           n * (2 * 4 + 4 * fsz + 6 * asz) + (B + 1) * 4 + 14 * B * fsz,
           B * OPS_RIGID_VIRIAL_BODY + n * OPS_RIGID_VIRIAL_ATOM,
           max(e["virial"] for e in errs.values()))
    w_def = rigid_ops.default_width(t.max_size)
    alt = {w: (cuda_ms(lambda: rgd.slot_force_torque(t, d, inv, fa, fb, fo,
                                                     w)),
               cuda_ms(lambda: rgd.rigid_update(
                   t, bs, dd, inv, xs, off, F, T, sim.dtv, sim.dtf,
                   rgd.MODE_INITIAL, w)))
           for w in (w_def, 32)}
    print(f"[hexane time] K15b final form (kick only): {final_ms:.4f} ms; "
          f"{B:,} bodies of {t.max_size} atoms; lanes a body "
          + ", ".join(f"{w}: K15a {a:.4f} ms, K15b initial {b:.4f} ms"
                      for w, (a, b) in alt.items()))
    out["widths"] = {str(w): dict(force_torque_ms=a, update_ms=b)
                     for w, (a, b) in alt.items()}
    out["final_ms"] = final_ms
    return out


def phase_hexane(rec: dict):
    """hexane_gen.yaml unedited (6,000 atoms, 200 steps, f32) and
    hexane_gen_big.yaml (192,000 atoms), each through build_simulation
    and run with the launch counts of HEX_PATH, step 0 against the record
    and the drift gate; then the kernels timed at the big deck's state,
    the per-atom ones (K12pa, K18 slots) too."""
    small = _hex_deck_run(HEX_DECK, rec)
    del small["sim"]
    torch.cuda.empty_cache()
    big = _hex_deck_run(HEX_BIG, rec, HEX_COPIES)
    sim = big.pop("sim")
    times = _hex_time(sim)
    # the per-atom kernels (K9d, K12pa with one channel) and K18 slots
    # (dispersion) at the big deck's last state
    times["peratom"] = _pa_twins("hexane_gen_big", sim, torch.float32,
                                 time_it=True)
    times["slots"] = _pa_slots("hexane_gen_big", sim.kspace, sim.state,
                               time_it=True)
    del sim
    torch.cuda.empty_cache()
    return small, big, times


# ---- long-range dispersion with long-range Coulomb and the channel mixes:
# buck/long (K1 / K9b DISP_LONG), K12b disp_deposit, K12c disp_gather ----

MIX_CRIS, MIX_CRIS_NLIST = ("cristobalite_buck_long.yaml",
                            "cristobalite_buck_long_nlist.yaml")
MIX_HEX, MIX_HEX_BIG = "hexane_gen_arith.yaml", "hexane_gen_big.yaml"
MIX_COUL = ("pppm_deposit", "pppm_spectral", "pppm_gather")
MIX_DISP = ("disp_deposit", "disp_spectral", "disp_gather")
MIX_CELL_PATH = (("cellpair", "rebin_incremental", "verlet_kick_drift",
                  "verlet_kick", "verlet_ke") + MIX_COUL + MIX_DISP)
MIX_NLIST_PATH = (("nlist_build", "nlist_pair", "verlet_kick_drift",
                   "verlet_kick", "verlet_ke") + MIX_COUL + MIX_DISP)
MIX_HEX_PATH = (("cellpair", "rebin_incremental", "rigid_force_torque",
                 "rigid_update", "rigid_virial", "verlet_ke") + MIX_DISP)
# the new kernels and variants against their plain versions: f64 1e-12
# relative; f32 forces 5e-4 of the largest (tests/test_computes.py:69),
# energies and virial the PPPM kernels' 1e-5
MIX_TOL = {torch.float32: (5e-4, 1e-5), torch.float64: (1e-12, 1e-12)}
# step-0 elong of the f32 decks against the JAX f64 record: the 2e-5 of
# tests/test_hexane.py:80-81; the other step-0 fields the _STEP0_FIELDS
# rule (cristobalite) or the same 2e-5 (hexane, as phase 13)
MIX_ELONG_TOL = 2e-5
# per pair inside the cutoff, buck/long: distance 8, clamp 1, 1/r^2 and r
# 2, r^-6 2, the repulsion r / rho, exp and rep_f 4, g6^2 r^2 1, 1/x 1,
# exp 1, x2 2, the polynomial 7, the force 3, scalar 1, both atoms' forces
# 9; with coul/long its 24 more
OPS_PAIR_BUCK_LONG = {"none": 42, "long": 66}
# lj/long + coul/long: lj/long's OPS_PAIR_DISP and coul/long's 24
OPS_PAIR_LJ_LONG_COUL = OPS_PAIR_DISP + 24


def _mix_variant(style, coul: str):
    """The DISP_LONG style with another Coulomb mode (coul none or long;
    a g_ewald for coul long where the style has none)."""
    from lammps_buck_intel_tpu_torch.models.pair.styles import PairConfig

    return style.replace(
        cfg=PairConfig(name=style.cfg.name, vdw=style.cfg.vdw, coul=coul,
                       disp="long"),
        g_ewald=style.g_ewald or 0.29)


def _mix_k9b_compare(label, style, x, typ, q, boxL, nl, acc):
    """K9b's DISP_LONG variant against compute_pair_plain on the card,
    force-only and with e/v.  Returns the force-only max |df|."""
    from lammps_buck_intel_tpu_torch.models.pair import driver

    ftol, etol = MIX_TOL[x.dtype]
    err = 0.0
    for ev in (False, True):
        k = driver.compute_pair(style, x, typ, q, boxL, nl, eflag=ev,
                                acc_dtype=acc, use_special=False)
        p = driver.compute_pair_plain(style, x, typ, q, boxL, nl, eflag=ev,
                                      acc_dtype=acc, use_special=False)
        fk = torch.stack([k.fx, k.fy, k.fz])
        fp = torch.stack([p.fx, p.fy, p.fz])
        errs = {"f": rel_err(fk, fp), "virial": rel_err(k.virial, p.virial)}
        if ev:
            errs["evdwl"] = scalar_rel(k.evdwl, p.evdwl)
            if style.cfg.has_coul:
                errs["ecoul"] = scalar_rel(k.ecoul, p.ecoul)
        else:
            err = float((fk - fp).abs().max())
        print(f"[K9b] {label} ev={ev}: " + ", ".join(
            f"{n} rel {e:.3e}" for n, e in errs.items()))
        if not (errs.pop("f") <= ftol
                and all(e <= etol for e in errs.values())):
            raise AssertionError(f"K9b {label} disagrees with its plain "
                                 "version")
    return err


def _mix_rows(bound_ks, x, aid, n):
    """(table, rows) of a BoundKSpace at slot positions: the cell engine's
    compute_slot inputs (aid clamped to n)."""
    table, _, slot_rows, _ = bound_ks._tables(x.device, x.dtype)
    rows = torch.index_select(slot_rows, 0,
                              torch.clamp(aid, max=n).to(torch.int32))
    return table.contiguous(), rows


def _mix_disp_compare(label, bound_ks, x, rows, table, acc):
    """K12b and K12c against their plain versions (the per-channel loops of
    the deposit and of the gather scaled by a_c), and the whole channel
    solve through the kernels against disp_compute_plain, on the same
    inputs.  Returns the max |d| of the meshes and of the forces."""
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as pd

    pmd = bound_ks.solver
    ftol, etol = MIX_TOL[x.dtype]
    c = pmd.consts(x.device, x.dtype)
    shim = c["shim"]
    mk = pd.deposit_multi(shim, x, rows, table, c["coef"])
    mp = pd.deposit_multi_plain(shim, x, rows, table)
    S = torch.fft.rfftn(mp.to(acc), dim=(1, 2, 3)).contiguous()
    ehat, _, _ = pd.disp_spectral(c, S, pmd.P, False)
    e_fields = (torch.fft.irfftn(ehat, s=pmd.grid, dim=(2, 3, 4))
                * (float(np.prod(pmd.grid)) / pmd.volume)).to(
                    x.dtype).contiguous()
    fk = torch.stack(pd.gather_multi(shim, x, rows, table, e_fields, acc,
                                     c["coef"]))
    fp = torch.stack(pd.gather_multi_plain(shim, x, rows, table, e_fields,
                                           acc))
    rk = pd.disp_compute_rows(pmd, x, rows, table, pmd.P, True, True)
    rp = pd.disp_compute_plain(pmd, x, table[:, rows.long()], pmd.P, True,
                               True)
    errs = dict(deposit=rel_err(mk, mp), gather=rel_err(fk, fp),
                solve_f=rel_err(torch.stack(rk.f), torch.stack(rp.f)))
    eerr = dict(elong=scalar_rel(rk.elong, rp.elong),
                virial=rel_err(rk.virial, rp.virial))
    print(f"[K12b/K12c] {label}: {table.shape[0]} channels, mesh "
          f"{pmd.grid} order {pmd.order}: " + ", ".join(
              f"{k} rel {v:.3e}" for k, v in {**errs, **eerr}.items()))
    if not (all(v <= ftol for v in errs.values())
            and all(v <= etol for v in eerr.values())):
        raise AssertionError(f"K12b/K12c {label} disagree with their plain "
                             "versions")
    return dict(deposit=float((mk - mp).abs().max()),
                gather=float((fk - fp).abs().max()))


def phase_mix_kernels():
    """K1 and K9b DISP_LONG x (buck, lj) x (coul none, coul long), K12b and
    K12c against their plain versions, f64 and f32: buck on the jittered
    2x2x2 cristobalite (the cell engine's slots, the list engine's atoms),
    lj on hexane_gen_arith.yaml's 6,000 atoms (coul long on charges
    +-0.4 put on the slots), the channels at 2 (no-mix silica) and 7
    (arithmetic hexane).  Returns the f32 max |d| per kernel."""
    out = {}
    for prec in ("double", "single"):
        cfg = load_deck(MIX_CRIS)
        cfg["replicate"] = [2, 2, 2]
        sim, st = jittered_state(cfg, prec)
        acc, n = sim.precision.acc, sim.n_atoms
        for coul in ("long", "none"):
            sty = sim.pair if coul == "long" else _mix_variant(sim.pair,
                                                               coul)
            e = _k1_compare(f"buck/long coul {coul} cristobalite x2x2x2 "
                            f"{prec}", sty, sim.grid, sim.box, st, acc,
                            tol=MIX_TOL[st.x.dtype])
            out[f"k1_buck_{coul}"] = e
        x = torch.stack([st.x, st.y, st.z])
        bks = sim.kspace.solvers[1]
        table, rows = _mix_rows(bks, x, st.aid, n)
        out["k12_2"] = _mix_disp_compare(f"cristobalite slots {prec}", bks,
                                         x, rows, table, acc)
        del sim, st
        nsim = _nlist_sim(MIX_CRIS_NLIST, prec, (2, 2, 2), jitter=0.1)
        xn = nsim.state.x
        nl = nsim._build(xn)
        for coul in ("long", "none"):
            sty = nsim.pair if coul == "long" else _mix_variant(nsim.pair,
                                                                coul)
            out[f"k9b_buck_{coul}"] = _mix_k9b_compare(
                f"buck/long coul {coul} cristobalite x2x2x2 {prec}", sty,
                xn, nsim.typ, nsim.q, nsim._boxL, nl, acc)
        del nsim, nl
        hcfg = load_deck(MIX_HEX)
        hcfg["precision"] = prec
        hs = build_simulation(hcfg, device="cuda")
        hst = hs.state
        mol = hs._slot_mol(hst)
        rng = np.random.default_rng(SEED)
        qs = torch.as_tensor(rng.choice([-0.4, 0.4], hst.x.shape[0])).to(
            hst.x)
        qs = torch.where(hst.aid < hs.n_atoms, qs, torch.zeros_like(qs))
        for coul, s in (("none", hst), ("long", hst._replace(q=qs))):
            sty = hs.pair if coul == "none" else _mix_variant(hs.pair, coul)
            _k1_compare(f"lj/long coul {coul} hexane {prec}", sty, hs.grid,
                        hs.box, s, hs.precision.acc, slot_mol=mol,
                        tol=MIX_TOL[hst.x.dtype])
        x = torch.stack([hst.x, hst.y, hst.z])
        table, rows = _mix_rows(hs.kspace, x, hst.aid, hs.n_atoms)
        out["k12_7"] = _mix_disp_compare(f"hexane slots {prec}", hs.kspace,
                                         x, rows, table, hs.precision.acc)
        del hs, hst
        # the lj/long list pass: the same atoms on engine nlist (fix nve)
        lcfg = dict(load_deck(MIX_HEX), precision=prec, engine="nlist",
                    fixes=[{"name": "nve"}])
        ls = build_simulation(lcfg, device="cuda")
        nl = ls._build(ls.state.x)
        qa = torch.as_tensor(rng.choice([-0.4, 0.4], ls.n_atoms)).to(
            ls.state.x)
        for coul, q in (("none", ls.q), ("long", qa)):
            sty = ls.pair if coul == "none" else _mix_variant(ls.pair, coul)
            _mix_k9b_compare(f"lj/long coul {coul} hexane {prec}", sty,
                             ls.state.x, ls.typ, q, ls._boxL, nl,
                             ls.precision.acc)
        del ls, nl
        torch.cuda.empty_cache()
    return out


def _mix_traj(label, cfg, want, tol=HEX_F64_TOL):
    """A deck in f64 on the card against the JAX record's rows (every row
    within tol of max(|value|, 1)) and its meshes, splits and channels."""
    ops.reset_launches()
    sim = build_simulation(cfg, device="cuda")
    ks = sim.kspace
    parts = list(getattr(ks, "solvers", [ks]))
    pmd = parts[-1].solver
    info = dict(mesh_disp=list(pmd.grid), g_ewald_6=pmd.g_ewald_6,
                nch=int(np.asarray(pmd.A).shape[0]), mix=pmd.mix,
                g_ewald=sim.pair.g_ewald,
                mesh=list(parts[0].grid) if len(parts) > 1 else None)
    for k, v in info.items():
        if v != want[k] and not (isinstance(v, float)
                                 and abs(v - want[k]) <= 1e-12 * abs(v)):
            raise AssertionError(f"{label}: {k} {v} vs record {want[k]}")
    rows = sim.run(want["steps"], thermo_every=want["every"], log=False)
    worst = 0.0
    for r, w in zip(rows, want["rows"]):
        for k in ("temp", "evdwl", "ecoul", "elong", "epair", "ke",
                  "etotal", "press"):
            err = abs(r[k] - w[k]) / max(abs(w[k]), 1.0)
            worst = max(worst, err)
            if not err <= tol:
                raise AssertionError(f"{label} row {r['step']} {k}: "
                                     f"{r[k]!r} vs record {w[k]!r}")
    if len(rows) != len(want["rows"]):
        raise AssertionError(f"{label}: {len(rows)} rows")
    print(f"[disp mix record] {label}: {sim.n_atoms} atoms x "
          f"{want['steps']} steps f64 ({type(sim).__name__}): every row "
          f"within {worst:.3e} of the JAX record (tol {tol}); {info}; "
          f"launches {dict((k, v) for k, v in ops.LAUNCHES.items() if v)}")
    del sim
    torch.cuda.empty_cache()


def phase_mix_record(rec: dict):
    """The three f64 records of tests/goldens/torch_disp_mix.json on the
    card: the jittered 2x2x2 cristobalite on the cell engine and on the
    list engine (20 steps) and hexane_gen_arith.yaml (20 steps)."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import gen_cristobalite

    cr = rec["cristobalite"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.cristobalite_jitter")
        gen_cristobalite.write(path, jitter_amp=cr["traj"]["amp"])
        for key, name in (("traj", MIX_CRIS), ("traj_nlist",
                                                MIX_CRIS_NLIST)):
            cfg = load_deck(name)
            cfg.update(precision="double", read_data=path,
                       replicate=cr[key]["replicate"])
            _mix_traj(f"{name} x2x2x2 jittered", cfg, cr[key])
    hx = rec["hexane"]
    cfg = load_deck(MIX_HEX)
    cfg["precision"] = "double"
    _mix_traj(MIX_HEX, cfg, hx["traj"])


def _mix_deck_run(name, s0, copies, path, drift_gate, relative_drift):
    """A new deck unedited through build_simulation and run on the card in
    f32, launch counts set to 0 just before and read just after: every
    kernel of the path launched, finite rows, step-0 elong within
    MIX_ELONG_TOL of the JAX f64 record scaled to ``copies`` (epair and
    etotal too for one copy; the _STEP0_FIELDS rule for the rest), the
    drift under its gate (per atom, or relative to |e0|)."""
    cfg = load_deck(name)
    ops.reset_launches()
    sim = build_simulation(cfg, device="cuda")
    steps = int(cfg["run"])
    rows = sim.run(steps, thermo_every=int(cfg["thermo"]), log=False)
    ran = dict(ops.LAUNCHES)
    missing = [k for k in path if ran[k] <= 0]
    if missing or rows[-1]["step"] != steps:
        raise AssertionError(f"{name}: kernels not launched {missing}")
    for r in rows:
        for k in ("temp", "epair", "etotal", "press"):
            if not np.isfinite(r[k]):
                raise AssertionError(f"{name}: non-finite {k}")
    ext = ("evdwl", "ecoul", "elong", "emol", "epair", "ke", "etotal")
    ref = {k: s0[k] * (copies if k in ext else 1) for k in s0}
    row = rows[0]
    if copies > 1:
        step0_check(name, row, ref, sim.n_atoms)
    checked = ("elong",) if copies > 1 else ("epair", "elong", "etotal")
    for k in checked:
        if not _row_close(row[k], ref[k], MIX_ELONG_TOL):
            raise AssertionError(f"{name} step-0 {k}: {row[k]:.8g} vs "
                                 f"record x{copies} {ref[k]:.8g}")
    e0 = row["etotal"]
    drift = max(abs(r["etotal"] - e0) for r in rows) / (
        abs(e0) if relative_drift else sim.n_atoms)
    wall = sim.timings["run"]
    ks = sim.kspace
    meshes = "; ".join(
        f"{type(getattr(p, 'solver', p)).__name__} mesh "
        f"{getattr(p, 'solver', p).grid} order {getattr(p, 'solver', p).order}"
        for p in getattr(ks, "solvers", [ks]))
    cells = (f"cells {sim.grid.nc} cap {sim.grid.cap}" if hasattr(sim, "grid")
             else f"list K {sim.spec.kmax} cells {sim.spec.nc}")
    print(f"[disp mix] {name}: {meshes}; {cells}")
    print(f"[disp mix] {name}: {type(sim).__name__}, {sim.n_atoms} atoms x "
          f"{steps} steps in {wall:.3f} s -> "
          f"{sim.n_atoms * steps / wall:,.0f} atom-steps/s, "
          f"{1e3 * wall / steps:.4f} ms/step (thermo every {cfg['thermo']}); "
          f"step 0 epair {row['epair']:.8g} elong {row['elong']:.8g} "
          f"etotal {e0:.8g} (record x{copies}: {ref['epair']:.8g}, "
          f"{ref['elong']:.8g}, {ref['etotal']:.8g}); rows " + ", ".join(
              f"{r['etotal']:.8g} @ {r['step']}" for r in rows)
          + f"; drift {drift:.3e}{'' if relative_drift else '/atom'} (gate "
          f"{drift_gate}); launches {ran}")
    if not drift <= drift_gate:
        raise AssertionError(f"{name}: drift {drift:.3e} > gate {drift_gate}")
    return dict(launches=ran, ms_step=1e3 * wall / steps, sim=sim,
                drift=drift)


def _mix_time_disp(label, bks, x, rows, table, acc, out, key):
    """K12b and K12c (f32) at these inputs beside the per-channel K5 / K8
    loops they replace, their plain versions, bounds and (the deposit) one
    index_add_ over every channel's stencil points."""
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as pd
    from lammps_buck_intel_tpu_torch.models.kspace.pppm_cells import \
        AtomPlanes

    pmd = bks.solver
    c = pmd.consts(x.device, x.dtype)
    shim = c["shim"]
    nch, m = table.shape[0], x.shape[1]
    p, ngrid = pmd.order, int(np.prod(pmd.grid))
    fsz = x.element_size()
    asz = torch.empty((), dtype=acc).element_size()
    live = int((torch.index_select(table.abs().sum(0), 0, rows.long())
                != 0).sum())
    aid = torch.arange(m, dtype=torch.int32, device=x.device)
    a = table[:, rows.long()].contiguous()
    planes = [AtomPlanes(x[0], x[1], x[2], a[ch], aid) for ch in range(nch)]
    errs = _mix_disp_compare(label, bks, x, rows, table, acc)
    entry_bytes = m * (3 * fsz + 4) + table.numel() * fsz

    def dep_loop():
        return [pppm_ops.deposit(shim, pl, m, c["coef"]) for pl in planes]

    flat, w3 = pppm_cells._stencil(shim, planes[0], 0, m,
                                   pppm_cells.mesh_geometry(shim))
    flat = flat.reshape(m, -1)
    flat_all = torch.cat([(flat + ch * ngrid).reshape(-1)
                          for ch in range(nch)])
    vals_all = torch.cat([(w3.reshape(m, -1) * a[ch][:, None]).reshape(-1)
                          for ch in range(nch)])
    del flat, w3
    mesh0 = torch.zeros(nch * ngrid, dtype=x.dtype, device=x.device)
    rec = {"disp_deposit": (
        lambda: pd.deposit_multi(shim, x, rows, table, c["coef"]),
        lambda: pd.deposit_multi_plain(shim, x, rows, table), dep_loop,
        lambda: mesh0.clone().index_add_(0, flat_all, vals_all),
        entry_bytes + nch * ngrid * fsz,
        live * (OPS_WEIGHTS(p) + nch * p**3 * OPS_DEPOSIT_PT),
        errs["deposit"])}
    mesh = pd.deposit_multi_plain(shim, x, rows, table)
    S = torch.fft.rfftn(mesh.to(acc), dim=(1, 2, 3)).contiguous()
    ehat, _, _ = pd.disp_spectral(c, S, pmd.P, False)
    e_fields = (torch.fft.irfftn(ehat, s=pmd.grid, dim=(2, 3, 4))
                * (ngrid / pmd.volume)).to(x.dtype).contiguous()
    del mesh, ehat

    def gat_loop():
        f = None
        for ch in range(nch):
            fc = pppm_ops.gather(shim, planes[ch], e_fields[ch], m, acc,
                                 c["coef"])
            f = fc if f is None else tuple(u + v for u, v in zip(f, fc))
        return f

    rec["disp_gather"] = (
        lambda: pd.gather_multi(shim, x, rows, table, e_fields, acc,
                                c["coef"]),
        lambda: pd.gather_multi_plain(shim, x, rows, table, e_fields, acc),
        gat_loop, None,
        entry_bytes + nch * 3 * ngrid * fsz + 3 * m * asz,
        live * (OPS_WEIGHTS(p) + nch * (p**3 * OPS_GATHER_PT + 3)),
        errs["gather"])
    for name, (kern, plain, loop, lib, nbytes, nops, err) in rec.items():
        ms, dev_ms = cuda_ms(kern), device_ms(kern)
        plain_ms = cuda_ms(plain, reps=1)
        loop_ms, loop_dev = cuda_ms(loop), device_ms(loop)
        lib_ms = cuda_ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, nops)
        out[f"{name}_{key}"] = dict(
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, loop_ms=loop_ms,
            loop_device_ms=loop_dev)
        print(f"[disp mix time] {name} {label} f32, {nch} channels, {m:,} "
              f"entries ({live:,} charged), mesh {pmd.grid} order {p}: "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f}); the per-channel "
              f"{'K5' if name == 'disp_deposit' else 'K8'} loop it replaces "
              f"{loop_ms:.4f} ms (device {loop_dev:.4f}); plain "
              f"{plain_ms:.4f} ms; library "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms; bound "
              f"{b_ms:.5f} ms ({b_by}; {nops:.4g} operations, "
              f"{int(nbytes):,} bytes)")
    del flat_all, vals_all, e_fields, S


def _mix_time_cell(sim, out):
    """At the cell deck's last state (259,200 atoms, f32): K1 buck/long +
    coul/long and its coul-none variant beside K1 buck/coul/long on the
    same slots (cristobalite_pppm.yaml's branch), each with its plain
    version and bound; K12b / K12c at 2 channels."""
    from lammps_buck_intel_tpu_torch.models.pair.styles import PairConfig

    st = cs.rebin_incremental(sim.grid, sim.box, sim.state.clone())
    style, grid, box = sim.pair, sim.grid, sim.box
    n, acc = sim.n_atoms, sim.precision.acc
    fsz, asz = st.x.element_size(), torch.empty((), dtype=acc).element_size()
    pairs = pairs_in_cutoff(style, grid, box, st)
    nbytes = grid.nslots * 2 * 4 + n * (plane_bytes(st.x, st.y, st.z, st.q,
                                                    st.typ) + 3 * asz)
    plain_style = style.replace(cfg=PairConfig(
        name="buck/coul/long", vdw="buck", coul="long", disp="cut"))
    for key, sty in (("long", style), ("none", _mix_variant(style, "none"))):
        err = _k1_compare(f"buck/long coul {key} at {n}", sty, grid, box,
                          st, acc, tol=MIX_TOL[st.x.dtype])

        def kern(sty=sty):
            return compute_cellpair(sty, grid, box, st, acc_dtype=acc)

        ms, dev_ms = cuda_ms(kern), device_ms(kern)
        plain_ms = cuda_ms(lambda: compute_cellpair_plain(
            sty, grid, box, st, acc_dtype=acc), reps=1)
        b_ms, b_by = bound(nbytes, pairs * OPS_PAIR_BUCK_LONG[key])
        cnt = _k1_counts(sty, grid, box, st)
        out[f"k1_buck_long_{key}"] = dict(
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            hit_share=cnt["hit_share"], lane_use=cnt["lane_use"],
            tiles=cnt["tiles"])
        print(f"[disp mix time] K1 buck/long coul {key} f32 at {n} atoms: "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}; {pairs:,} "
              f"pairs); hit share {cnt['hit_share']:.4f}, lane use "
              f"{cnt['lane_use']:.4f}, tested an atom / cap "
              f"{cnt['tiles']:.2f}")
    base_ms = cuda_ms(lambda: compute_cellpair(plain_style, grid, box, st,
                                               acc_dtype=acc))
    base_dev = device_ms(lambda: compute_cellpair(plain_style, grid, box, st,
                                                  acc_dtype=acc))
    out["k1_buck_coul_long_same_state"] = dict(ms=base_ms, device_ms=base_dev)
    print(f"[disp mix time] K1 buck/coul/long (no DISP_LONG, the "
          f"cristobalite_pppm.yaml branch) on the same slots: {base_ms:.4f} "
          f"ms (device {base_dev:.4f}); cells {grid.nc} cap {grid.cap}")
    x = torch.stack([st.x, st.y, st.z])
    bks = sim.kspace.solvers[1]
    table, rows = _mix_rows(bks, x, st.aid, n)
    _mix_time_disp(f"cristobalite slots {n}", bks, x, rows, table, acc, out,
                   "2ch")


def _mix_time_nlist(sim, out):
    """At the list deck's last state: K9b buck/long + coul/long beside its
    coul/long branch without DISP_LONG on the same list."""
    from lammps_buck_intel_tpu_torch.models.pair import driver
    from lammps_buck_intel_tpu_torch.models.pair.styles import PairConfig

    x = sim.state.x
    nl = sim._build(x)
    acc, n = sim.precision.acc, sim.n_atoms
    err = _mix_k9b_compare(f"buck/long coul long at {n}", sim.pair, x,
                           sim.typ, sim.q, sim._boxL, nl, acc)
    entries = int(torch.minimum(nl.nnei, torch.tensor(
        nl.idx.shape[1], device=nl.nnei.device)).sum())
    inside = list_pairs_in_cutoff(x, sim._boxL, nl, sim.pair.cutsq_max)
    fsz, asz = x.element_size(), torch.empty((), dtype=acc).element_size()
    nbytes = list_pass_bytes(entries, n, fsz, False, 3 * n * asz)
    plain_style = sim.pair.replace(cfg=PairConfig(
        name="buck/coul/long", vdw="buck", coul="long", disp="cut"))
    res = {}
    for key, sty in (("long", sim.pair), ("plain_branch", plain_style)):
        def kern(sty=sty):
            return driver.compute_pair(sty, x, sim.typ, sim.q, sim._boxL, nl,
                                       eflag=False, acc_dtype=acc,
                                       use_special=False)

        res[key] = (cuda_ms(kern), device_ms(kern))
    plain_ms = cuda_ms(lambda: driver.compute_pair_plain(
        sim.pair, x, sim.typ, sim.q, sim._boxL, nl, eflag=False,
        acc_dtype=acc, use_special=False), reps=1)
    b_ms, b_by = bound(nbytes, entries * OPS_LIST_ENTRY + inside * (
        OPS_PAIR_BUCK_LONG["long"] - 9 + 15))
    ms, dev_ms = res["long"]
    out["k9b_buck_long_long"] = dict(
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    print(f"[disp mix time] K9b buck/long coul long f32 at {n} atoms "
          f"({entries / n:.0f} entries, {inside / n:.0f} in the cutoff an "
          f"atom): kernel {ms:.4f} ms (device {dev_ms:.4f}), its "
          f"buck/coul/long branch on the same list "
          f"{res['plain_branch'][0]:.4f} ms (device "
          f"{res['plain_branch'][1]:.4f}), plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by})")
    out["k9b_buck_coul_long_same_list"] = dict(
        ms=res["plain_branch"][0], device_ms=res["plain_branch"][1])


def _mix_time_hex_big(out):
    """K12b / K12c at 7 channels on hexane_gen_big.yaml's 192,000 atoms with
    mix arithmetic (the kernels only: the generic dispersion mesh on its
    slots)."""
    cfg = load_deck(MIX_HEX_BIG)
    cfg["kspace_style"] = dict(cfg["kspace_style"], mix="arithmetic")
    sim = build_simulation(cfg, device="cuda")
    st = sim.state
    x = torch.stack([st.x, st.y, st.z])
    table, rows = _mix_rows(sim.kspace, x, st.aid, sim.n_atoms)
    _mix_time_disp(f"hexane_big slots {sim.n_atoms}", sim.kspace, x, rows,
                   table, sim.precision.acc, out, "7ch")
    # K1 lj/long + coul/long, which no deck runs: the deck's slots with a
    # neutral +-0.25 e pattern on alternate atom ids, the mol plane kept
    n, acc = sim.n_atoms, sim.precision.acc
    grid, box = sim.grid, sim.box
    pm_q = torch.where(st.aid % 2 == 0, 0.25, -0.25).to(st.x)
    stq = st._replace(q=torch.where(st.aid < n, pm_q, torch.zeros_like(pm_q)))
    sty, mol = _mix_variant(sim.pair, "long"), sim._slot_mol(st)
    err = _k1_compare(f"lj/long coul long at {n}", sty, grid, box, stq, acc,
                      slot_mol=mol, tol=MIX_TOL[st.x.dtype])
    pairs = pairs_in_cutoff(sty, grid, box, stq, slot_mol=mol)

    def kern():
        return compute_cellpair(sty, grid, box, stq, acc_dtype=acc,
                                slot_mol=mol)

    ms, dev_ms = cuda_ms(kern), device_ms(kern)
    plain_ms = cuda_ms(lambda: compute_cellpair_plain(
        sty, grid, box, stq, acc_dtype=acc, slot_mol=mol), reps=1)
    asz = torch.empty((), dtype=acc).element_size()
    b_ms, b_by = bound(grid.nslots * 2 * 4 + n * (
        plane_bytes(stq.x, stq.y, stq.z, stq.q, stq.typ) + 3 * asz),
        pairs * OPS_PAIR_LJ_LONG_COUL)
    out["k1_lj_long_coul_long"] = dict(
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    print(f"[disp mix time] K1 lj/long + coul/long f32 at {n} atoms "
          f"(charges +-0.25 e): kernel {ms:.4f} ms (device {dev_ms:.4f}), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}; {pairs:,} "
          f"pairs of two molecules)")
    del sim, st, stq
    torch.cuda.empty_cache()


def phase_mix(rec: dict):
    """The three new decks unedited in f32 (cristobalite_buck_long.yaml and
    cristobalite_buck_long_nlist.yaml at 259,200 atoms, 100 steps: step 0
    against the record scaled to 22.5 copies, the silica drift gate 5e-3
    per atom; hexane_gen_arith.yaml at 6,000 atoms, 200 steps: step 0
    within 2e-5, relative drift under 5e-4), every kernel of each path
    launched; then the new kernels timed at the decks' states."""
    cr, hx = rec["cristobalite"], rec["hexane"]
    copies = 259200 / cr["step0"]["n_atoms"]
    gate = load_golden("long_silica_pppm.json")["drift_gate"]
    print(f"[disp mix] the record's step 0 scaled from 11,520 to 17,280 "
          f"atoms (other meshes) holds to "
          + ", ".join(f"{k} {v:.2e}" for k, v in
                      cr["step0"]["scale_dev"].items())
          + f"; the f32 decks' step-0 elong gate is {MIX_ELONG_TOL}")
    times = {}
    cell = _mix_deck_run(MIX_CRIS, cr["step0"]["row"], copies,
                         MIX_CELL_PATH, gate, False)
    _mix_time_cell(cell.pop("sim"), times)
    torch.cuda.empty_cache()
    nlist = _mix_deck_run(MIX_CRIS_NLIST, cr["step0"]["row"], copies,
                          MIX_NLIST_PATH, gate, False)
    _mix_time_nlist(nlist.pop("sim"), times)
    torch.cuda.empty_cache()
    hgate = max(HEX_DRIFT, hx["deck"]["drift"] + HEX_DRIFT) \
        if hx["deck"]["drift"] > HEX_DRIFT else HEX_DRIFT
    hexa = _mix_deck_run(MIX_HEX, hx["step0"]["row"], 1, MIX_HEX_PATH, hgate,
                         True)
    del hexa["sim"]
    torch.cuda.empty_cache()
    _mix_time_hex_big(times)
    print(f"[disp mix] cristobalite_buck_long.yaml {cell['ms_step']:.4f} "
          f"ms/step, cristobalite_buck_long_nlist.yaml "
          f"{nlist['ms_step']:.4f} ms/step, hexane_gen_arith.yaml "
          f"{hexa['ms_step']:.4f} ms/step")
    return cell, nlist, hexa, times


# ---- per-atom energy and virial (K9d, K10pa, K11pa, K18b) and dumps ----

PA_KERNELS = ("nlist_pair_peratom", "pppm_peratom_spectral",
              "pppm_peratom_gather", "ewald_peratom", "bonded_peratom")
# kernel against plain version on the card: f64 1e-12 of each output's
# largest value; f32 TOL's 1e-4 (the pair and bonded sums run in another
# order, the deposit's and the bonded tallies' atomics land in any order)
PA_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
# K11pa in f32: its distance to the f64 sum on the same positions at most
# this many times the plain version's (both sum ~10^4 terms in f32, in
# different orders)
PA_EWALD_F64_RATIO = 2.0
# the f64 functions on the card against the JAX package's f64 record
# (tests/goldens/torch_peratom.json): sums and sampled atoms
PA_RECORD_TOL = 1e-9
# the computes (f32 pair and k-space passes, as the JAX package's) against
# the record's JAX computes: the CPU test's 2e-5 of the sums, 1e-4 of the
# largest sampled atom
PA_COMPUTE_TOL = (2e-5, 1e-4)
# a frame's sum of c_pe against its thermo row (the f32 gate of the JAX
# package's tests/test_computes.py), and -trace(sum c_stress) / (3 V)
# against press on the silica decks
PA_PE_TOL, PA_PRESS_TOL = 5e-4, 2e-4
# per pair inside the cutoff of the per-atom pass: the pair physics less
# the other atom's force and the force sums (OPS_PAIR - 9), then the
# energy and six virial tallies (14)
OPS_PA_PAIR = 14 - 9
# K10pa spectral per half-spectrum point: G rho_hat 2, k^2 5, pref 3, the
# six factors 18, twelve products
OPS_PA_SPECTRAL_PT = 40
# K10pa gather per stencil point: the weight 2, seven multiply-adds 14;
# per atom the weights (OPS_WEIGHTS) and the ~20 of the terms
OPS_PA_WEIGHT_PT, OPS_PA_MAC_PT = 2, 14
OPS_PA_GATHER_PT, OPS_PA_GATHER_ATOM = OPS_PA_WEIGHT_PT + OPS_PA_MAC_PT, 20
# K11pa per (atom, k): the phase 5, sine and cosine 2, the share 3, seven
# multiply-adds 14; per atom the finish ~20
OPS_PA_EWALD, OPS_PA_EWALD_ATOM = 24, 20
# K18b per term: the force kernels' arithmetic (OPS_BONDED) and the
# shares, 7 divides and 7 adds per atom of the term
OPS_PA_SHARE = 14
# a LAMMPS dump custom frame of the per-atom computes
DUMP_COLS = (["id", "type", "x", "y", "z", "c_pe"]
             + [f"c_stress[{i}]" for i in range(1, 7)])


def _peratom_cases():
    """examples/peratom_cases.py: the record's decks and the jittered
    copy."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import peratom_cases

    return peratom_cases


def _pa_err(k, p) -> float:
    """Largest relative difference over a tuple of outputs, each to its
    own largest value (complex tensors as pairs of reals)."""
    def real(t):
        return torch.view_as_real(t) if t.is_complex() else t

    return max(rel_err(real(a).to(torch.float64), real(b).to(torch.float64))
               for a, b in zip(k, p))


def _pa_twins(label, sim, dtype, time_it: bool) -> dict:
    """Each per-atom kernel of the engine's path against its plain version
    on the card, on the engine's snapshot with positions and charges in
    ``dtype`` (the bonded pass on f64 positions with f64 sums, the variant
    the computes launch):
    K9d on the computes' fresh list, per solver K10pa's two kernels (the
    deposit and the FFTs of compute_peratom between them), K11pa after
    K11a or K12pa's two kernels (``_pa_disp_twins``), K18b.  time_it:
    each kernel's CUDA-event and device times beside its plain version's
    and its bound (no one PyTorch call does the same work
    as any of them: library_ms is null)."""
    from lammps_buck_intel_tpu_torch import computes
    from lammps_buck_intel_tpu_torch.models.bonded import (
        compute_bonded_peratom, compute_bonded_peratom_plain)
    from lammps_buck_intel_tpu_torch.models.kspace import (BoundKSpace,
                                                           CellPPPMDisp,
                                                           ewald, pppm)
    from lammps_buck_intel_tpu_torch.models.kspace.pppm_cells import (
        AtomPlanes, deposit)
    from lammps_buck_intel_tpu_torch.models.pair import driver
    from lammps_buck_intel_tpu_torch.ops import ewald as ewald_ops

    at = sim.atoms_on_device()
    n, dev = sim.n_atoms, at["x"].device
    x, q, typ = at["x"].to(dtype), at["q"].to(dtype), at["typ"]
    tol, fs = PA_TOL[dtype], x.element_size()
    out = {}

    def check(name, k, p, t=tol, dt=dtype):
        err = _pa_err(k, p)
        print(f"[peratom] {label} {name} {str(dt)[6:]}: kernel vs plain "
              f"max rel {err:.3e} (tol {t})")
        if not err <= t:
            raise AssertionError(f"{label}: {name} disagrees with its plain "
                                 f"version ({err:.3e} > {t})")
        return err

    def timed(name, kern, plain, nbytes, nops, err, extra="", prec="f32"):
        if not time_it:
            out[name] = dict(max_abs_err=err)
            return
        ms, dev_ms = cuda_ms(kern), device_ms(kern)
        plain_ms = cuda_ms(plain, reps=2)
        b_ms, b_by = bound(nbytes, nops)
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=err)
        print(f"[peratom time] {label} {name} {prec} at {n} atoms: kernel "
              f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}; {nops:.4g} operations, "
              f"{int(nbytes):,} bytes); no one PyTorch call does this "
              f"work{extra}")

    # K9d on the list the computes build
    box, style = sim.box, sim.pair
    _, L, nl, use_special = computes._pair_list(sim, at, dtype)
    args, kw = ((style, x, typ, q, L, nl),
                dict(acc_dtype=dtype, use_special=use_special))
    err = check("K9d nlist_pair_peratom",
                driver.compute_pair_peratom(*args, **kw),
                driver.compute_pair_peratom_plain(*args, **kw))
    if time_it:
        entries = int(torch.clamp(nl.nnei, max=nl.idx.shape[1]).sum())
        pairs = list_pairs_in_cutoff(x, L, nl, style.cutsq_max)
        timed("nlist_pair_peratom",
              lambda: driver.compute_pair_peratom(*args, **kw),
              lambda: driver.compute_pair_peratom_plain(*args, **kw),
              list_pass_bytes(entries, n, fs, kw["use_special"],
                              7 * n * fs),
              entries * OPS_LIST_ENTRY + pairs * (_pair_ops(style.cfg)
                                                  + OPS_PA_PAIR), err,
              f"; K {nl.idx.shape[1]}, {entries / n:.1f} entries and "
              f"{pairs / n:.1f} pairs in the cutoff an atom")
    # the k-space terms, each solver of a CombinedKSpace
    for solver in computes._solvers(sim.kspace):
        if isinstance(solver, ewald.Ewald):
            ew = solver
            c = ew.consts(dev, dtype)
            xs = tuple(x.unbind(0))
            sk = ewald_ops.ewald_sk(xs, q, c, ew.qqrd2e, ew.acc_dtype)
            g, V = ew.g_ewald, float(ew.volume)
            pa = (ew.qqrd2e, ew.acc_dtype, g / np.sqrt(np.pi),
                  np.pi / (2.0 * g * g * V), ew.qsum)
            kern_r = ewald.ewald_compute_peratom(ew, x, q)
            plain_r = ewald.ewald_compute_peratom_plain(ew, x, q)
            if dtype == torch.float32:
                # each per-atom sum runs over K terms ~10^2 times the result,
                # in f32, in another order in each (the kernel per thread in k
                # ranges, the plain version through cuBLAS): the Ewald forces'
                # f32 tolerance (EWALD_TOL), with both versions' distance to
                # the f64 sum on the same positions printed
                import dataclasses

                ew64 = dataclasses.replace(ew, acc_dtype=torch.float64,
                                           _consts={})
                ref = ewald.ewald_compute_peratom_plain(ew64, x.double(),
                                                        q.double())
                d_kern, d_plain = _pa_err(kern_r, ref), _pa_err(plain_r, ref)
                print(f"[peratom] {label} K11pa f32 against the f64 sum: "
                      f"kernel {d_kern:.3e}, plain {d_plain:.3e} (the kernel "
                      f"within {PA_EWALD_F64_RATIO}x the plain version's)")
                if not d_kern <= PA_EWALD_F64_RATIO * d_plain:
                    raise AssertionError(
                        f"{label}: K11pa is {d_kern:.3e} from the f64 sum, "
                        f"more "
                        f"than {PA_EWALD_F64_RATIO}x the plain version's "
                        f"{d_plain:.3e}")
            err = check("K11pa ewald_peratom", kern_r, plain_r,
                        EWALD_TOL[dtype][0])
            K = ew.kvecs.shape[0]
            timed("ewald_peratom",
                  lambda: ewald_ops.ewald_peratom(xs, q, c, sk.s_re, sk.s_im,
                                                  *pa),
                  lambda: ewald.ewald_compute_peratom_plain(ew, x, q),
                  4 * n * fs + 12 * K * fs + 7 * n * fs,
                  n * K * OPS_PA_EWALD + n * OPS_PA_EWALD_ATOM, err,
                  f" (K {K}; the plain time includes its own S(k))")
        elif isinstance(solver, (BoundKSpace, CellPPPMDisp)):
            _pa_disp_twins(label, solver, at, dtype, check, timed)
        else:
            pm = getattr(solver, "pm", solver)
            err = check("K10pa compute_peratom",
                        pppm.compute_peratom(pm, x, q),
                        pppm.compute_peratom_plain(pm, x, q))
            c = pm.consts(dev, dtype)
            planes = AtomPlanes(x[0], x[1], x[2], q,
                                torch.arange(n, dtype=torch.int32, device=dev))
            mesh = deposit(pm, planes, n, c)
            rhat = torch.fft.rfftn(mesh.to(pm.acc_dtype)).contiguous()
            from lammps_buck_intel_tpu_torch.ops import pppm as pppm_ops

            sk = pppm_ops.peratom_spectral(pm, c, rhat, True)
            e1 = check("K10pa pppm_peratom_spectral", (sk,),
                       (pppm.peratom_spectral_plain(pm, c, rhat, True),))
            meshes = torch.fft.irfftn(sk, s=pm.grid,
                                      dim=(1, 2, 3)).contiguous()
            nx, ny, nz = pm.grid
            scale = nx * ny * nz / float(pm.volume)
            e2 = check("K10pa pppm_peratom_gather",
                       pppm_ops.peratom_gather(pm, planes, meshes, c["coef"],
                                               scale),
                       pppm.peratom_gather_plain(pm, planes, meshes, scale))
            asz = torch.empty((), dtype=pm.acc_dtype).element_size()
            npts = int(np.prod(c["G_half"].shape))
            timed("pppm_peratom_spectral",
                  lambda: pppm_ops.peratom_spectral(pm, c, rhat, True),
                  lambda: pppm.peratom_spectral_plain(pm, c, rhat, True),
                  npts * (3 + 14) * asz, npts * OPS_PA_SPECTRAL_PT,
                  max(err, e1),
                  f" (half spectrum {tuple(c['G_half'].shape)})")
            p = pm.order
            timed("pppm_peratom_gather",
                  lambda: pppm_ops.peratom_gather(pm, planes, meshes,
                                                  c["coef"],
                                                  scale),
                  lambda: pppm.peratom_gather_plain(pm, planes, meshes, scale),
                  4 * n * fs + 7 * nx * ny * nz * asz + 7 * n * asz,
                  n * (OPS_WEIGHTS(p) + p ** 3 * OPS_PA_GATHER_PT
                       + OPS_PA_GATHER_ATOM), max(err, e2),
                  f" (mesh {pm.grid}, order {p})")
    if sim.bonded is not None:
        # the computes' precision: f64 positions, f64 sums
        b = sim.bonded
        xs = tuple(at["x"].to(torch.float64).unbind(0))
        kw = dict(acc_dtype=torch.float64)
        err = check("K18b bonded_peratom",
                    compute_bonded_peratom(b, xs, box, **kw),
                    compute_bonded_peratom_plain(b, xs, box, **kw),
                    PA_TOL[torch.float64], torch.float64)
        counts = {"bond": (len(b.bonds), 2), "angle": (len(b.angles), 3),
                  "dihedral": (len(b.dihedrals), 4),
                  "improper": (len(b.impropers), 4)}
        nops = sum(m * (OPS_BONDED[k] + OPS_PA_SHARE * w)
                   for k, (m, w) in counts.items())
        nbytes = (sum(m * 4 * (w + 1) for m, w in counts.values())
                  + 3 * n * 8 + 14 * n * 8)
        timed("bonded_peratom",
              lambda: compute_bonded_peratom(b, xs, box, **kw),
              lambda: compute_bonded_peratom_plain(b, xs, box, **kw),
              nbytes, nops, err,
              " (terms " + ", ".join(f"{k} {m}" for k, (m, _) in
                                     counts.items()) + ")", prec="f64")
    return out


def _pa_close(label, key, a, ref, idx, tols):
    """Column sums and sampled atoms of ``a`` against a record entry:
    tols = (sums, samples), each of the record's largest value."""
    a = a.to(torch.float64).cpu().numpy()
    s, rs = a.sum(0), np.asarray(ref["sum"])
    smp, rsmp = a[idx], np.asarray(ref["sample"])
    es = float(np.abs(s - rs).max()) / max(float(np.abs(rs).max()), 1e-300)
    ep = float(np.abs(smp - rsmp).max()) / max(float(np.abs(rsmp).max()),
                                               1e-300)
    if not (es <= tols[0] and ep <= tols[1]):
        raise AssertionError(f"{label} {key}: sums {es:.3e}, samples "
                             f"{ep:.3e} off the record (tols {tols})")
    return max(es, ep)


def phase_peratom_record(rec: dict):
    """The four cases of tests/goldens/torch_peratom.json (jittered
    silica with PPPM and with Ewald on the list engine, rhodo_class.yaml
    on the cell engine, one copy of rhodo_npt.yaml) built in f64 on the
    card: every per-atom kernel against its plain version (1e-12); the f64
    functions (the PPPM spectra in the JAX package's half-spectrum
    convention) against the JAX package's record within 1e-9; pe_atom and
    stress_atom against the JAX computes at PA_COMPUTE_TOL; sum pe against
    the thermo row (2e-5 of |epair + emol|) and, on silica, the pressure
    identity; then rhodo_npt 20 steps on and the same pins at the dilated
    box (the TracedPPPM rebuilt there)."""
    from lammps_buck_intel_tpu_torch import computes
    from lammps_buck_intel_tpu_torch.models.bonded import (
        compute_bonded_peratom)

    rp = _peratom_cases()
    f64 = torch.float64
    worst = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.cristobalite_jitter")
        rp.write_jitter(path)
        for name in rp.CASES:
            g = rec[name]
            sim = build_simulation(jax_deck(rp.case_config(name, path)),
                                   device="cuda")
            row = sim.thermo()
            _pa_twins(name, sim, f64, time_it=False)
            at = sim.atoms_on_device()
            idx = np.asarray(g["sample"])
            got = dict(zip(("pair_e", "pair_v"),
                           computes._pair_peratom(sim, at, f64)))
            got.update(zip(("kspace_e", "kspace_v"),
                           computes._kspace_peratom(sim, at, f64, False)))
            if sim.bonded is not None:
                got.update(zip(("bonded_e", "bonded_v", "bonded_e14",
                                "bonded_v14"),
                               compute_bonded_peratom(
                                   sim.bonded, tuple(at["x"].unbind(0)),
                                   sim.box)))
            for key, a in got.items():
                worst = max(worst, _pa_close(name, key, a, g["f64"][key], idx,
                                             (PA_RECORD_TOL,) * 2))
            cache = {}
            pe = computes.pe_atom(sim, cache=cache)
            st = computes.stress_atom(sim, cache=cache)
            st_half = rp.half_spectrum_stress(sim, st, cache)
            for key, a in (("pe", pe), ("stress", st_half)):
                _pa_close(name, key, a, g[key], idx, PA_COMPUTE_TOL)
            _pa_pins(name, sim, row, st, pe, 2e-5)
            if name == "rhodo_npt":
                rows = sim.run(20, thermo_every=20, log=False)
                cache = {}
                _pa_pins(f"{name} after 20 steps", sim, rows[-1],
                         computes.stress_atom(sim, cache=cache),
                         computes.pe_atom(sim, cache=cache), 2e-5)
            del sim
    print(f"[peratom] the f64 per-atom functions on the card within "
          f"{worst:.3e} of the JAX package's record (tol {PA_RECORD_TOL})")
    torch.cuda.empty_cache()
    return worst


def _press_identity(sim) -> bool:
    """Whether the deck's whole virial has per-atom shares: not with SHAKE
    or rigid bodies, whose constraint virials are global only."""
    return sim.shake is None and getattr(sim, "rigid", None) is None


def _pa_pins(label, sim, row, stress, pe, pe_tol):
    """sum pe against the row's epair + emol; on decks without SHAKE or
    rigid bodies the pressure identity press = -trace(sum stress) /
    (3 V)."""
    total = row["epair"] + row["emol"]
    pe_sum = float(pe.sum())
    vol = float(np.prod(np.asarray(sim.box.lengths, np.float64)))
    press = -float(stress[:, :3].sum()) / (3.0 * vol)
    print(f"[peratom] {label}: sum pe {pe_sum:.10g} (thermo {total:.10g}, "
          f"rel {abs(pe_sum - total) / abs(total):.3e}); -tr(sum "
          f"stress)/3V {press:.8g} (thermo press {row['press']:.8g})")
    if not abs(pe_sum - total) <= pe_tol * abs(total):
        raise AssertionError(f"{label}: sum pe off thermo")
    if _press_identity(sim) and not (abs(press - row["press"])
                                     <= PA_PRESS_TOL * max(abs(row["press"]),
                                                           1.0)):
        raise AssertionError(f"{label}: pressure identity off")


def _dump_deck(name, base_ms, need, tmp):
    """One dump deck unedited through run_deck in f32, its dump file moved
    into ``tmp``, launch counts set to 0 just before and read just after:
    every kernel of ``need`` launched; each frame read back with
    read_lammpstrj, its sum of c_pe against the thermo row's epair + emol
    (PA_PE_TOL) and, without SHAKE or rigid bodies, -trace(sum c_stress) /
    (3 V) against press (PA_PRESS_TOL); ms/step of the run without the
    frames beside base_ms (the same deck without dump, earlier in this
    call) and the seconds a frame costs.  Returns the launches, ms/step,
    the frames' seconds and the engine."""
    from lammps_buck_intel_tpu_torch.io import dump as dumpmod
    from lammps_buck_intel_tpu_torch.run import run_deck

    cfg = load_deck(name)
    cfg["dump"] = dict(cfg["dump"], file=os.path.join(tmp, name + ".dump"))
    if cfg["dump"]["columns"] != DUMP_COLS:
        raise AssertionError(f"{name}: dump columns {cfg['dump']['columns']}")
    ops.reset_launches()
    sim, rows = run_deck(cfg, device="cuda", log=False)
    ran = dict(ops.LAUNCHES)
    missing = [k for k in need if ran[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels not launched {missing}")
    frames = dumpmod.read_lammpstrj(cfg["dump"]["file"])
    steps, every = int(cfg["run"]), int(cfg["dump"]["every"])
    if [f["step"] for f in frames] != list(range(0, steps + 1, every)):
        raise AssertionError(
            f"{name}: frames at {[f['step'] for f in frames]}")
    by_step = {r["step"]: r for r in rows}
    vol = float(np.prod(np.asarray(sim.box.lengths, np.float64)))
    pins = []
    for f in frames:
        d, row = f["data"], by_step[f["step"]]
        if d.shape != (sim.n_atoms, len(DUMP_COLS)) or not np.isfinite(
                d).all():
            raise AssertionError(f"{name}: frame {f['step']} shape {d.shape}")
        pe = d[:, DUMP_COLS.index("c_pe")].sum()
        s = DUMP_COLS.index("c_stress[1]")
        press = -d[:, s:s + 3].sum() / (3.0 * vol)
        total = row["epair"] + row["emol"]
        pins.append((f["step"], (pe - total) / abs(total),
                     (press - row["press"]) / max(abs(row["press"]), 1.0)))
        if not abs(pe - total) <= PA_PE_TOL * abs(total):
            raise AssertionError(f"{name} frame {f['step']}: sum c_pe {pe} "
                                 f"vs thermo {total}")
        if _press_identity(sim) and not (abs(press - row["press"])
                                         <= PA_PRESS_TOL
                                         * max(abs(row["press"]), 1.0)):
            raise AssertionError(f"{name} frame {f['step']}: pressure "
                                 f"{press} vs thermo {row['press']}")
    ms_step = 1e3 * sim.timings["run"] / steps
    frame_s = sim.timings["dump"] / len(frames)
    print(f"[dump] {name}: {sim.n_atoms} atoms x {steps} steps, "
          f"{len(frames)} frames; run {ms_step:.4f} ms/step without the "
          f"frames (the deck without dump, earlier in this call: "
          f"{base_ms:.4f}); {frame_s:.3f} s a frame; per frame (step, rel "
          f"sum c_pe - thermo, rel press identity): " + ", ".join(
              f"({a}, {b:.2e}, {c:.2e})" for a, b, c in pins)
          + f"; launches {ran}")
    return dict(launches=ran, ms_step=ms_step, frame_s=frame_s,
                frames=len(frames), sim=sim, base_ms=base_ms)


DUMP_PATH = {
    "cristobalite_pppm_dump.yaml": ("cellpair", "rebin_incremental",
                                    "pppm_deposit_cells", "pppm_deposit",
                                    "pppm_spectral",
                                    "pppm_gather", "nlist_build",
                                    "nlist_pair_peratom",
                                    "pppm_peratom_spectral",
                                    "pppm_peratom_gather"),
    "cristobalite_ewald_dump.yaml": ("nlist_build", "nlist_pair", "ewald_sk",
                                     "ewald_force", "nlist_pair_peratom",
                                     "ewald_peratom"),
    "rhodo_nve_dump.yaml": ("cellpair", "pppm_deposit_cells", "pppm_deposit",
                            "pppm_gather",
                            "bonded_bond_angle", "dihedral_charmm",
                            "improper_harmonic", "shake_positions",
                            "nlist_build", "nlist_pair_peratom",
                            "pppm_peratom_spectral", "pppm_peratom_gather",
                            "bonded_peratom"),
}


def phase_dump(base: dict):
    """The three dump decks unedited (``_dump_deck``), each followed by its
    per-atom kernels against their plain versions in f32 at the deck's
    last state, timed there (the result's "times"); K18 slots (Coulomb) at
    cristobalite_pppm_dump.yaml's last slot state (the result's "slots"),
    and before its run on its ideal crystal against the f64 solve
    (``_k18_against_f64``)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, need in DUMP_PATH.items():
            if name == "cristobalite_pppm_dump.yaml":
                # K18 slots (Coulomb) on the deck's ideal crystal, built
                # and not run
                sim = build_simulation(load_deck(name), device="cuda")
                _k18_against_f64(name + " step 0", sim.kspace, sim.state)
                del sim
            r = _dump_deck(name, base[name], need, tmp)
            sim = r.pop("sim")
            r["times"] = _pa_twins(name, sim, torch.float32, time_it=True)
            if name == "cristobalite_pppm_dump.yaml":
                # K18 slots (Coulomb) on the north-star mesh
                r["slots"] = _pa_slots(name, sim.kspace, sim.state,
                                       time_it=True)
            out[name] = r
            del sim
            torch.cuda.empty_cache()
    return out


# ---- per-atom dispersion PPPM (K12pa) and the slot-order per-atom PPPM
# (K18 slots) ----

# K12pa spectral per half-spectrum point: the six factors 15 (vfac k_a k_b
# 9 multiplies, three adds), per channel chi 4 nch (P times a complex
# sum), phi 2, twelve products
OPS_PA_DISP_PT, OPS_PA_DISP_CH = 15, 14
# K12pa gather per entry and channel of non-zero charge: a_c / 2 1, the
# energy 2, the six virials 12, and at each stencil point the seven
# multiply-adds (OPS_PA_MAC_PT); per entry with a non-zero charge the
# weights once (OPS_WEIGHTS, OPS_PA_WEIGHT_PT a point), whatever its
# channels, and the k = 0 and self terms 2 nch^2 + 4 nch + 8
OPS_PA_DISP_GATHER_CH = 15
# K18 slots: the pins of the slot forms in f64 (the sums of the shares
# against compute_slots' elong and virial: the JAX test's tolerances,
# tests/test_pppm_cells.py:150-153)
PA_SLOT_PIN = (1e-10, 1e-9)
# K18 slots (Coulomb) in f32 on the ideal crystal, where the per-atom
# diagonal k-space virials nearly cancel and f32 loses digits in any
# summation order: the kernel's distance to the f64 plain solve on the
# same positions at most this many times the f32 plain version's
PA_SLOT_F64_RATIO = 2.0
DISP_DUMP_PATH = {
    "cristobalite_buck_long_dump.yaml": (
        "cellpair", "rebin_incremental", "pppm_deposit", "pppm_spectral",
        "pppm_gather", "disp_deposit", "disp_spectral", "disp_gather",
        "nlist_build", "nlist_pair_peratom", "pppm_peratom_spectral",
        "pppm_peratom_gather", "disp_peratom_spectral",
        "disp_peratom_gather"),
    "hexane_gen_dump.yaml": (
        "cellpair", "rebin_incremental", "pppm_deposit_cells", "disp_spectral",
        "pppm_gather", "rigid_force_torque", "rigid_update", "rigid_virial",
        "nlist_build", "nlist_pair_peratom", "disp_deposit",
        "disp_peratom_spectral", "disp_peratom_gather"),
    "hexane_gen_arith_dump.yaml": (
        "cellpair", "rebin_incremental", "disp_deposit", "disp_spectral",
        "disp_gather", "rigid_force_torque", "rigid_update", "rigid_virial",
        "nlist_build", "nlist_pair_peratom", "disp_peratom_spectral",
        "disp_peratom_gather"),
}


def _pair_ops(cfg) -> int:
    """Operations per pair in the cutoff of a pair style (OPS_PAIR; the
    DISP_LONG styles' counts of phases 13 and 14)."""
    if cfg.disp == "long":
        if cfg.vdw == "buck":
            return OPS_PAIR_BUCK_LONG[cfg.coul]
        return OPS_PAIR_DISP + (OPS_PAIR_LJ_LONG_COUL - OPS_PAIR_DISP
                                if cfg.coul == "long" else 0)
    return OPS_PAIR[cfg.vdw, cfg.coul]


def _solver_peratom(solver, x, typ):
    """A bound dispersion solver's compute_peratom, called as the computes
    call it."""
    from lammps_buck_intel_tpu_torch.models.kspace import CellPPPMDisp

    if isinstance(solver, CellPPPMDisp):
        return solver.compute_peratom(x, typ)
    return solver.compute_peratom(x)


def _disp_binding(solver, at, dtype):
    """The inputs of the K12pa stages, as the solver's compute_peratom
    binds its channels: (pmd, row, table, P) with the channel charges
    table[:, row] in ``dtype`` (CellPPPMDisp: b = B[type] from its own
    table; BoundKSpace typed: A[:, type]; per-atom: its charges cast to
    f32)."""
    from lammps_buck_intel_tpu_torch.models.kspace import CellPPPMDisp

    typ, dev = at["typ"], at["x"].device
    ident = torch.arange(typ.shape[0], dtype=torch.int32, device=dev)
    one = np.ones((1, 1))
    if isinstance(solver, CellPPPMDisp):
        b = torch.index_select(solver._b_table(dev, dtype), 0, typ)
        return solver.pmd, ident, b[None].contiguous(), one
    pmd = solver.solver
    if solver.typed:
        A = torch.as_tensor(np.asarray(pmd.A, np.float64)).to(dev, dtype)
        return pmd, typ.to(torch.int32), A.contiguous(), pmd.P
    b = torch.as_tensor(solver.per_atom.astype(np.float32)).to(dev, dtype)
    return pmd, ident, b[None].contiguous(), one


def _pa_disp_twins(label, solver, at, dtype, check, timed):
    """K12pa against its plain version (``_pa_twins``' check and timed):
    compute_peratom as the computes bind the solver against
    disp_peratom_plain, then each kernel on its own inputs (the K12b
    deposit and the FFTs between them) and timed."""
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as pd

    x = at["x"].to(dtype)
    n, fs = x.shape[1], x.element_size()
    pmd, row, table, P = _disp_binding(solver, at, dtype)
    a = table[:, row.long()]
    err = check("K12pa compute_peratom", _solver_peratom(solver, x, at["typ"]),
                pd.disp_peratom_plain(pmd, x, a, P))
    c = pmd.consts(x.device, dtype)
    shim, acc = c["shim"], pmd.acc_dtype
    S = torch.fft.rfftn(pd.deposit_multi(shim, x, row, table, c["coef"])
                        .to(acc), dim=(1, 2, 3)).contiguous()
    sk = pd.disp_peratom_spectral(c, S, P)
    e1 = check("K12pa disp_peratom_spectral", (sk,),
               (pd.disp_peratom_spectral_plain(c, S, P),))
    meshes = torch.fft.irfftn(sk, s=pmd.grid, dim=(2, 3, 4)).contiguous()
    del sk
    ngrid = int(np.prod(pmd.grid))
    scale = ngrid / float(pmd.volume)
    terms = pd.peratom_terms(pmd, P, a.to(acc).sum(1))

    def gk():
        return pd.disp_peratom_gather(shim, x, row, table, meshes,
                                      c["coef"], scale, terms)

    def gp():
        return pd.disp_peratom_gather_plain(shim, x, a, meshes, scale,
                                            *terms)

    e2 = check("K12pa disp_peratom_gather", gk(), gp())
    nch, p = table.shape[0], pmd.order
    asz = torch.empty((), dtype=acc).element_size()
    npts = int(np.prod(c["G"].shape))
    timed("disp_peratom_spectral",
          lambda: pd.disp_peratom_spectral(c, S, P),
          lambda: pd.disp_peratom_spectral_plain(c, S, P),
          npts * asz * (2 + 2 * nch + 14 * nch),
          npts * (OPS_PA_DISP_PT + nch * (4 * nch + OPS_PA_DISP_CH)),
          max(err, e1), f" ({nch} channels, half spectrum "
          f"{tuple(c['G'].shape)})")
    live = int((a != 0).sum())
    charged = int((a != 0).any(0).sum())
    timed("disp_peratom_gather", gk, gp,
          n * (3 * fs + 4) + nch * ngrid * 7 * asz + 7 * n * asz,
          charged * (OPS_WEIGHTS(p) + p ** 3 * OPS_PA_WEIGHT_PT
                     + 2 * nch * nch + 4 * nch + 8)
          + live * (p ** 3 * OPS_PA_MAC_PT + OPS_PA_DISP_GATHER_CH),
          max(err, e2), f" ({nch} channels, mesh {pmd.grid}, order {p}, "
          f"{live} (atom, channel) pairs of non-zero charge, {charged} "
          f"atoms with one)")


def _f64_slot_solver(solver, st64):
    """The cell engine's solver with f64 sums, on the same mesh and
    tables, and the Coulomb self and background terms from the charges of
    the f64 slot state ``st64`` (the deck's f32 charges widened), so that
    its elong and the per-slot shares sum the same charges."""
    import copy
    import dataclasses

    from lammps_buck_intel_tpu_torch.models.kspace import CellPPPMDisp

    s64 = copy.copy(solver)
    s64._consts, s64._B = {}, {}
    if isinstance(solver, CellPPPMDisp):
        s64.pmd = dataclasses.replace(solver.pmd, acc_dtype=torch.float64,
                                      _consts={})
        s64.pm = s64.pmd.shim()
    else:
        q = st64.q[st64.aid < solver.n_atoms]
        s64.pm = dataclasses.replace(solver.pm, acc_dtype=torch.float64,
                                     _consts={}, qsum=float(q.sum()),
                                     qsqsum=float((q * q).sum()))
    return s64


def _f64_slots(st):
    """The slot state with positions and charges widened to f64."""
    return st._replace(**{f: getattr(st, f).double()
                          for f in ("x", "y", "z", "q")})


def _k18_against_f64(label, solver, st):
    """K18 slots (Coulomb) in f32 on a state where f32 loses digits in any
    summation order (the ideal crystal: the per-atom diagonal k-space
    virials nearly cancel): the kernel's and the f32 plain version's
    distances to the f64 plain solve on the same positions, printed with
    the kernel's distance to the plain version; the kernel's at most
    PA_SLOT_F64_RATIO times the plain version's."""
    st64 = _f64_slots(st)
    ref = _f64_slot_solver(solver, st64).compute_peratom_slots(st64,
                                                               plain=True)
    kern = solver.compute_peratom_slots(st)
    plain = solver.compute_peratom_slots(st, plain=True)
    d_kern, d_plain = _pa_err(kern, ref), _pa_err(plain, ref)
    print(f"[K18 slots] {label} f32 against the f64 plain solve: kernel "
          f"{d_kern:.3e}, plain {d_plain:.3e} (the kernel within "
          f"{PA_SLOT_F64_RATIO}x the plain version's); kernel vs plain "
          f"{_pa_err(kern, plain):.3e}")
    if not d_kern <= PA_SLOT_F64_RATIO * d_plain:
        raise AssertionError(
            f"{label}: K18 slots are {d_kern:.3e} from the f64 solve, more "
            f"than {PA_SLOT_F64_RATIO}x the plain version's {d_plain:.3e}")
    del st64, ref, kern, plain
    torch.cuda.empty_cache()


def _pa_slots(label, solver, st, time_it: bool) -> dict:
    """K18 slots on an engine's slot state: counts set to 0 just before
    ``compute_peratom_slots`` and read just after (every kernel of the
    slot form launched), against its plain version on the card (PA_TOL),
    exactly 0 on empty slots; the pins on an f64 copy of the solver and
    the state (the shares' sums against compute_slots' elong and virial,
    PA_SLOT_PIN; for the Coulomb form also the miss of the full-spectrum
    Nyquist rule of ``pppm.compute_peratom`` on the same slots, printed);
    with ``time_it`` the slot gather kernel timed beside its plain version
    and its bound."""
    from lammps_buck_intel_tpu_torch.models.kspace import CellPPPMDisp
    from lammps_buck_intel_tpu_torch.models.kspace import pppm as tp
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as pd

    disp = isinstance(solver, CellPPPMDisp)
    n, flt = solver.n_atoms, st.x.dtype
    key = "disp_peratom_slots" if disp else "pppm_peratom_slots"
    dep = ("pppm_deposit_cells" if pppm_cells.takes_bricks(
        solver.bricks, st.x.shape[0], st.x.element_size())
        else "pppm_deposit")
    need = (dep, "disp_peratom_spectral" if disp
            else "pppm_peratom_spectral", key)
    ops.reset_launches()
    ek, vk = solver.compute_peratom_slots(st)
    torch.cuda.synchronize()
    ran = {k: ops.LAUNCHES[k] for k in need}
    if min(ran.values()) <= 0:
        raise AssertionError(f"{label}: K18 slots launched {ran}")
    ep, vp = solver.compute_peratom_slots(st, plain=True)
    err = _pa_err((ek, vk), (ep, vp))
    empty = st.aid >= n
    print(f"[K18 slots] {label} {'dispersion' if disp else 'Coulomb'} "
          f"{str(flt)[6:]}, {st.x.shape[0]} slots ({int(empty.sum())} "
          f"empty): kernel vs plain max rel {err:.3e} (tol {PA_TOL[flt]}); "
          f"launches {ran}")
    if not err <= PA_TOL[flt]:
        raise AssertionError(f"{label}: K18 slots disagree with plain")
    if ek[empty].any() or vk[empty].any():
        raise AssertionError(f"{label}: K18 slots not 0 on empty slots")
    # the pins in f64
    st64 = _f64_slots(st)
    s64 = _f64_slot_solver(solver, st64)
    _, _, _, el, vir = s64.compute_slots(st64, True, True)

    def miss(e, v):
        me = abs(float(e.sum() - el)) / abs(float(el))
        mv = (v.sum(0) - vir) / vir.abs().max()
        return me, mv, (f"sum eatom - elong rel {me:.3e}; sum vatom - "
                        f"virial, of its largest: "
                        + " ".join(f"{u:.3e}" for u in mv.tolist()))

    me, mv, text = miss(*s64.compute_peratom_slots(st64))
    print(f"[K18 slots] {label} f64 pins: {text}")
    if not (me <= PA_SLOT_PIN[0] and float(mv.abs().max()) <= PA_SLOT_PIN[1]):
        raise AssertionError(f"{label}: K18 slots do not pin")
    if not disp:
        # the full-spectrum rule on the same slots and meshes: printed
        pm = s64.pm
        c = pm.consts(st64.x.device, torch.float64)
        rhat = torch.fft.rfftn(pppm_cells.deposit(pm, st64, n, c)).contiguous()
        meshes = torch.fft.irfftn(tp.peratom_spectral(pm, c, rhat, True),
                                  s=pm.grid, dim=(1, 2, 3)).contiguous()
        print(f"[K18 slots] {label} f64, the full-spectrum Nyquist rule: "
              + miss(*tp.peratom_gather(pm, st64, meshes, c, n))[2])
        del rhat, meshes
    del s64, st64
    out = dict(launches=ran[key], max_abs_err=err)
    if not time_it:
        return out
    # the slot gather alone, on the meshes of this state
    ns = st.x.shape[0]
    fs, p = st.x.element_size(), solver.pm.order
    live = int((~empty).sum())
    if disp:
        pmd = solver.pmd
        c = pmd.consts(st.x.device, flt)
        acc = pmd.acc_dtype
        b = solver._slot_b(st)
        S = torch.fft.rfftn(pppm_cells.deposit(solver.pm, st._replace(q=b),
                                               n, c).to(acc)).contiguous()
        meshes = torch.fft.irfftn(pd.disp_peratom_spectral(c, S[None],
                                                           pmd.P),
                                  s=pmd.grid, dim=(2, 3, 4)).contiguous()
        ngrid = int(np.prod(pmd.grid))
        scale = ngrid / float(pmd.volume)
        terms = pd.peratom_terms(pmd, pmd.P, torch.full(
            (1,), solver._bsum, dtype=acc, device=st.x.device))
        x = torch.stack([st.x, st.y, st.z])
        table = solver._b_table(st.x.device, flt)[None, :]

        def kern():
            return pd.disp_peratom_gather(solver.pm, x, st.typ, table,
                                          meshes, c["coef"], scale, terms,
                                          st.aid, n)

        def plain():
            return pd.disp_peratom_gather_plain(solver.pm, x, b[None],
                                                meshes, scale, *terms)

        nops = live * (OPS_WEIGHTS(p) + p ** 3 * OPS_PA_GATHER_PT
                       + OPS_PA_DISP_GATHER_CH + 14)
    else:
        pm = solver.pm
        c = pm.consts(st.x.device, flt)
        acc = pm.acc_dtype
        rhat = torch.fft.rfftn(pppm_cells.deposit(pm, st, n, c).to(acc)
                               ).contiguous()
        meshes = torch.fft.irfftn(tp.peratom_spectral(pm, c, rhat, False),
                                  s=pm.grid, dim=(1, 2, 3)).contiguous()
        ngrid = int(np.prod(pm.grid))
        scale = ngrid / float(pm.volume)

        def kern():
            return pppm_ops.peratom_gather(pm, st, meshes, c["coef"], scale,
                                           n)

        def plain():
            return tp.peratom_gather_plain(pm, st, meshes, scale)

        nops = live * (OPS_WEIGHTS(p) + p ** 3 * OPS_PA_GATHER_PT
                       + OPS_PA_GATHER_ATOM)
    # a live slot reads x, y, z and aid, with q (Coulomb) or its type row
    # (dispersion); an empty one only aid
    asz = torch.empty((), dtype=acc).element_size()
    nbytes = (live * (3 * fs + 8 if disp else 4 * fs + 4)
              + (ns - live) * 4 + 7 * ngrid * asz + 7 * ns * asz)
    ms, dev_ms = cuda_ms(kern), device_ms(kern)
    plain_ms = cuda_ms(plain, reps=2)
    whole_ms = cuda_ms(lambda: solver.compute_peratom_slots(st), reps=3)
    b_ms, b_by = bound(nbytes, nops)
    print(f"[K18 slots time] {label} f32: slot gather {ms:.4f} ms (device "
          f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}; {nops:.4g} operations, {int(nbytes):,} bytes; {ns} "
          f"slots, {live} atoms, mesh {solver.pm.grid}, order {p}); the "
          f"whole slot form {whole_ms:.4f} ms; no one PyTorch call does "
          f"this work")
    out.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=b_ms, bound_by=b_by, whole_ms=whole_ms)
    return out


def _disp_miss(label, sim):
    """The dispersion solver's per-atom virial sums against its own global
    virial at the deck's mesh, on an f64 copy of the solver and the
    positions (the JAX convention the port keeps: printed)."""
    import dataclasses

    from lammps_buck_intel_tpu_torch import computes
    from lammps_buck_intel_tpu_torch.models.kspace import (BoundKSpace,
                                                           CellPPPMDisp)
    from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as pd

    at = sim.atoms_on_device()
    f64 = torch.float64
    for s in computes._solvers(sim.kspace):
        if not isinstance(s, (BoundKSpace, CellPPPMDisp)):
            continue
        pmd, row, table, P = _disp_binding(s, at, f64)
        p64 = dataclasses.replace(pmd, acc_dtype=f64, _consts={})
        x = at["x"].double()
        e, v = pd.disp_peratom(p64, x, row, table, P)
        g = p64.compute_rows(x, row, table, P)
        me = abs(float(e.sum() - g.elong)) / abs(float(g.elong))
        mv = (v.sum(0) - g.virial) / g.virial.abs().max()
        print(f"[peratom disp] {label}: mesh {pmd.grid}, order "
              f"{pmd.order}, {table.shape[0]} channels: f64 sum eatom - "
              f"elong rel {me:.3e}; sum vatom - virial, of its largest: "
              + " ".join(f"{u:.3e}" for u in mv.tolist()))
        del p64, e, v, g
    torch.cuda.empty_cache()


def phase_peratom_disp_record(rec: dict):
    """The three dispersion cases of tests/goldens/torch_peratom_disp.json
    (examples/peratom_cases.py DISP_CASES: cristobalite_buck_long.yaml on
    the jittered copy, hexane_gen.yaml and hexane_gen_arith.yaml on the
    4x4x4 cut-out) built in f64 on the card: every per-atom kernel against
    its plain version (1e-12: K9d, K10pa, K12pa; K18 slots on the hexane
    cell engine with its pins); the f64 functions (pair, the k-space sum,
    the dispersion solver alone) against the JAX package's record within
    1e-9; pe_atom and stress_atom against the JAX computes at
    PA_COMPUTE_TOL; sum pe against the thermo row and, on silica, the
    pressure identity."""
    from lammps_buck_intel_tpu_torch import computes
    from lammps_buck_intel_tpu_torch.models.kspace import (BoundKSpace,
                                                           CellPPPMDisp)

    rp = _peratom_cases()
    f64 = torch.float64
    worst = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        jpath = os.path.join(tmp, "data.cristobalite_jitter")
        hpath = os.path.join(tmp, "data.hexane_cut")
        rp.write_jitter(jpath)
        rp.write_hexane_cut(hpath)
        for name in rp.DISP_CASES:
            g = rec[name]
            sim = build_simulation(
                jax_deck(rp.case_config(name, jpath, hpath)), device="cuda")
            if type(sim).__name__ != g["engine"]:
                raise AssertionError(f"{name}: engine {type(sim).__name__}")
            row = sim.thermo()
            _pa_twins(name, sim, f64, time_it=False)
            at = sim.atoms_on_device()
            idx = np.asarray(g["sample"])
            got = dict(zip(("pair_e", "pair_v"),
                           computes._pair_peratom(sim, at, f64)))
            got.update(zip(("kspace_e", "kspace_v"),
                           computes._kspace_peratom(sim, at, f64, False)))
            for s in computes._solvers(sim.kspace):
                if isinstance(s, (BoundKSpace, CellPPPMDisp)):
                    got.update(zip(("disp_e", "disp_v"), _solver_peratom(
                        s, at["x"], at["typ"])))
            for key, a in got.items():
                worst = max(worst, _pa_close(name, key, a, g["f64"][key],
                                             idx, (PA_RECORD_TOL,) * 2))
            cache = {}
            pe = computes.pe_atom(sim, cache=cache)
            st = computes.stress_atom(sim, cache=cache)
            st_half = rp.half_spectrum_stress(sim, st, cache)
            for key, a in (("pe", pe), ("stress", st_half)):
                _pa_close(name, key, a, g[key], idx, PA_COMPUTE_TOL)
            _pa_pins(name, sim, row, st, pe, 2e-5)
            if isinstance(sim.kspace, CellPPPMDisp):
                _pa_slots(name, sim.kspace, sim.state, time_it=False)
            del sim
    print(f"[peratom disp] the f64 per-atom functions on the card within "
          f"{worst:.3e} of the JAX package's record (tol {PA_RECORD_TOL})")
    torch.cuda.empty_cache()
    return worst


def phase_dump_disp(base: dict):
    """The three pppm/disp dump decks unedited (``_dump_deck``: every
    kernel of DISP_DUMP_PATH launched, each frame's sum c_pe within 5e-4
    of thermo, the pressure identity on the buck/long deck; the rigid
    hexane decks' constraint virial is global only), each followed by its
    per-atom kernels against their plain versions in f32 at the deck's
    last state, timed there, and the dispersion per-atom virial's miss at
    the deck's mesh in f64; K18 slots (dispersion) on hexane_gen_dump's
    last slot state."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, need in DISP_DUMP_PATH.items():
            r = _dump_deck(name, base[name], need, tmp)
            sim = r.pop("sim")
            r["times"] = _pa_twins(name, sim, torch.float32, time_it=True)
            _disp_miss(name, sim)
            if name == "hexane_gen_dump.yaml":
                r["slots"] = _pa_slots(name, sim.kspace, sim.state,
                                       time_it=True)
            out[name] = r
            del sim
            torch.cuda.empty_cache()
    return out


# ---- the rest of the Coulomb k-space: pppm diff ad (K10 ad spectral, K10
# ad gather), kspace_modify slab (K10 slab), Ewald on the cell engine and
# under fix npt (K11 traced) ----

REST_AD = ("pppm_deposit", "pppm_ad_spectral", "pppm_gather_ad")
# kspace_modify mesh on cristobalite_pppm_nlist.yaml
REST_GRID = (120, 128, 96)
REST_REC = "torch_kspace_rest.json"
# f64 on the card against the JAX package's f64 record of the shrunk
# decks (examples/kspace_rest_cases.py): the CPU parity tolerance of
# tests/test_torch_pppm_ad.py and tests/test_torch_ewald_npt.py
REST_RECORD_TOL = 1e-9
# the NPT decks conserve no energy that thermo prints, so their f32 runs
# are held to f64 rows of the same run, |etotal_f32 - etotal_f64| / N at
# every row within REST_NPT_F32_TOL eV: at the record's size the JAX
# package's f64 record, at full width the port's f64 run on the card
# (itself held to that record at REST_RECORD_TOL at the record's size)
# over the record's steps.  The limit is 10x the largest deviation of the
# sound f32 runs at the record's size, 6.83e-6 eV an atom (H100 80GB
# HBM3, 700 W)
REST_NPT_F32_TOL = 7e-5
# per atom and ad gather point: two multiply-adds along z, T0 += wz u and
# T1 += dz u (the three forces then need only the p^2 (a, b) rows:
# _rest_ops_ad)
OPS_GATHER_AD_PT = 4
# per atom of K10 slab: the sums q z, q z z (4), the force (5)
OPS_SLAB_ATOM = 9
# e_slab of a neutral system is (2 pi / V) qqrd2e M^2 with M = sum q z a
# sum of terms that cancel (a slab with no dipole: M about 1e-7 of sum
# |q z| at cristobalite_slab.yaml's last state on the card), so M carries the
# rounding of sum |q z|, and the kernel's and plain version's orders of
# summation part there, in f64 as in f32.  At such a state the kernel is
# held to the plain version and to the f64 plain version on the scale of
# those terms (fz and e_slab as if M were sum |q z|), the scale on which
# a sum's rounding is bounded; the charged copy (REST_SLAB_DQ) holds them
# at TOL of the values.  Elsewhere (_slab_energy_check) the f32 energy is
# held to the f64 value, within twice the plain version's distance or the
# energy rule


def _slab_energy_check(label, ek, ep, e64, etol):
    dk, dp = abs(float(ek) - float(e64)), abs(float(ep) - float(e64))
    print(f"[rest] {label} e_slab: kernel {float(ek):.8g}, plain "
          f"{float(ep):.8g}, f64 {float(e64):.10g}; kernel {dk:.3e} and plain "
          f"{dp:.3e} from f64")
    if not dk <= max(2.0 * dp, etol * abs(float(e64))):
        raise AssertionError(f"K10 slab {label}: energy off")
# a charged copy for K10 slab's Q terms (-Q z_i in fz, -Q M2 - Q^2 zprd^2
# / 12 in e_slab): every live charge shifted by REST_SLAB_DQ, so Q = N
# REST_SLAB_DQ and M - Q z_i no longer cancels
REST_SLAB_DQ = 0.05


def _slab_charged(label, pm, z, q, live, box=None):
    """K10 slab against slab_correction_plain at TOL on ``z`` with the
    charges ``q`` shifted by REST_SLAB_DQ where ``live`` (Q != 0); ``box``:
    (boxL, V, zprd) for the form with the box on the card."""
    from lammps_buck_intel_tpu_torch.models.kspace.pppm import \
        slab_correction_plain

    qc = (q + REST_SLAB_DQ * live.to(q.dtype)).contiguous()
    pmc = dataclasses.replace(pm, qsum=float(qc.double().sum()), _consts={})
    fzk = torch.zeros(z.shape[0], dtype=pm.acc_dtype, device=z.device)
    boxL, V, zprd = box if box is not None else (None, None, None)
    ek = pppm_ops.slab(pmc, z, qc, fzk, True, boxL)
    ep, fzp = slab_correction_plain(pmc, z, qc, True, V, zprd)
    ftol, etol = TOL[z.dtype]
    label = f"{label} Q = {pmc.qsum:.6g}"
    _rest_compare(label, "pppm_slab", fzk, fzp, ftol)
    e_err = scalar_rel(ek, ep)
    print(f"[rest] {label} e_slab: kernel {float(ek):.10g}, plain "
          f"{float(ep):.10g}, rel {e_err:.3e} (tol {etol})")
    if not e_err <= etol:
        raise AssertionError(f"K10 slab {label}: energy off")


# per k vector of K11 traced: k (6), |k|^2 (5), the volume (2), ug (5,
# exp counted as one), pref (3), the six virial factors (18)
OPS_EWALD_TRACED_K = 39


def _rest_ops_ad(p: int, nterms: int) -> int:
    """Operations of the K10 ad gather per atom beyond its points: the
    weights (OPS_WEIGHTS, wx wy included) and derivative weights, per (a,
    b) row the two other weight products (dx wy, wx dy) and the three
    multiply-adds with T0, T0 and T1, the sine series of the self force
    (about 5 an axis and term), the scaling."""
    return (OPS_WEIGHTS(p) + 3 * p * 2 * (p - 2) + 2 * p * p + 6 * p * p
            + 3 * 5 * nterms + 12)


def _rest_compare(label, name, k, p, tol, out=None):
    err = rel_err(k, p)
    print(f"[rest] {label} {name}: max|d|/max|ref| {err:.3e} (tol {tol})")
    if not err <= tol:
        raise AssertionError(f"{name} {label} disagrees with its plain "
                             "version")
    if out is not None:
        out.setdefault(name, {})["max_abs_err"] = float((k - p).abs().max())


def _rest_cell_ad(out):
    """K10 ad spectral and K10 ad gather on the cell engine at
    cristobalite_pppm_ad.yaml's mesh (105x112x77 half spectrum 39, 337,920
    slots), atoms drifted up to skin/2 out of their cells, f32 and f64;
    timed in f32 (ad spectral force-only, as on all but thermo steps, its
    library call G * rho_hat)."""
    cfg = load_deck("cristobalite_pppm_ad.yaml")
    for prec in ("double", "single"):
        sim, st = jittered_state(cfg, prec)
        skin = sim.neighbor.skin
        rng = np.random.default_rng(SEED + 5)
        for p in (st.x, st.y, st.z):
            p += torch.as_tensor(rng.uniform(-0.5 * skin, 0.5 * skin,
                                             p.shape[0])).to(p)
        solver, flt, acc = sim.kspace, st.x.dtype, sim.precision.acc
        pm, n = solver.pm, sim.n_atoms
        c = solver.consts(st.x.device, flt, acc)
        ftol, etol = TOL[flt]
        label = f"cristobalite_pppm_ad/{prec}"
        res = out if prec == "single" else {}
        mesh = pppm_cells.deposit_plain(pm, st)
        rhat = torch.fft.rfftn(mesh.to(acc)).contiguous()
        for ev in (False, True):
            pk, esk, vsk = pppm_ops.spectral(c, rhat, ev, ad=True)
            pp, esp, vsp = pppm_cells.spectral_plain(c, rhat, ev, ev, True)
            _rest_compare(label, "pppm_ad_spectral", torch.view_as_real(pk),
                          torch.view_as_real(pp), ftol, res)
            if ev:
                e_err, v_err = scalar_rel(esk, esp), rel_err(vsk, vsp)
                print(f"[rest] {label} ad spectral e/v: energy sum rel "
                      f"{e_err:.3e}, virial rel {v_err:.3e} (tol {etol})")
                if not (e_err <= etol and v_err <= etol):
                    raise AssertionError(f"K10 ad spectral {label}: energy "
                                         "or virial off")
        ngrid = int(np.prod(pm.grid))
        u = (torch.fft.irfftn(pp, s=pm.grid) * (ngrid / float(pm.volume))
             ).to(flt).contiguous()
        fk = torch.stack(pppm_ops.gather_ad(pm, st, u, n, acc, c["coef"],
                                            c["dcoef"], c["sf"]))
        fp = torch.stack(pppm_cells.gather_ad_plain(pm, st, u, acc, c["sf"]))
        _rest_compare(label, "pppm_gather_ad", fk, fp, ftol, res)
        if float(fk[:, st.aid >= n].abs().max()) != 0.0:
            raise AssertionError(f"{label}: an empty slot got an ad force")
        if prec == "single":
            ns, fs = st.x.shape[0], st.x.element_size()
            accs = torch.empty((), dtype=acc).element_size()
            npts = int(np.prod(c["G"].shape))
            G = c["G"]
            b_sp = bound(npts * accs * (2 + 1 + 2), npts * 2)
            b_ga = bound(ns * plane_bytes(st.x, st.y, st.z, st.q, st.aid)
                         + ngrid * fs + 3 * ns * accs,
                         n * (_rest_ops_ad(pm.order, c["sf"].shape[1])
                              + pm.order ** 3 * OPS_GATHER_AD_PT))
            rows = {
                "pppm_ad_spectral": (
                    lambda: pppm_ops.spectral(c, rhat, False, ad=True),
                    lambda: pppm_cells.spectral_plain(c, rhat, False, False,
                                                      True),
                    lambda: torch.mul(G, rhat), b_sp),
                "pppm_gather_ad": (
                    lambda: pppm_ops.gather_ad(pm, st, u, n, acc, c["coef"],
                                               c["dcoef"], c["sf"]),
                    lambda: pppm_cells.gather_ad_plain(pm, st, u, acc,
                                                       c["sf"]),
                    None, b_ga),
            }
            for name, (kern, plain, lib, (b_ms, b_by)) in rows.items():
                ms, dev_ms = cuda_ms(kern), device_ms(kern)
                plain_ms = cuda_ms(plain, reps=3)
                lib_ms = cuda_ms(lib) if lib is not None else None
                out[name].update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=b_ms,
                                 bound_by=b_by)
                print(f"[rest] {name} f32 at {n} atoms / {ns} slots, mesh "
                      f"{pm.grid}: kernel {ms:.4f} ms (device {dev_ms:.4f}),"
                      f" plain {plain_ms:.4f} ms, library "
                      f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, "
                      f"bound {b_ms:.5f} ms ({b_by})")
            # the ik stages of the same state, for the step's comparison
            ik_ms = cuda_ms(lambda: pppm_ops.spectral(c, rhat, False))
            e3 = torch.fft.irfftn(pppm_ops.spectral(c, rhat, False)[0],
                                  s=pm.grid, dim=(1, 2, 3)).to(
                                      flt).contiguous()
            g_ms = cuda_ms(lambda: pppm_ops.gather(pm, st, e3, n, acc,
                                                   c["coef"]))
            ifft1 = cuda_ms(lambda: torch.fft.irfftn(pp, s=pm.grid))
            ehat = pppm_ops.spectral(c, rhat, False)[0]
            ifft3 = cuda_ms(lambda: torch.fft.irfftn(ehat, s=pm.grid,
                                                     dim=(1, 2, 3)))
            print(f"[rest] the same state through ik: spectral {ik_ms:.4f} "
                  f"ms, gather {g_ms:.4f} ms, irfftn of three spectra "
                  f"{ifft3:.4f} ms against one {ifft1:.4f} ms")
        del sim, st, solver
        torch.cuda.empty_cache()


def _rest_traced(out):
    """K10 ad gather and K10 slab with the box on the card (TracedPPPM's
    forms) at rhodo_npt_ad.yaml's 31,104 atoms, the box stretched by (1.01,
    0.99, 1.02), f32 and f64: the ad gather of the block's potential mesh
    against its plain version, the slab kernel (a slab factor 3 solver of
    the same atoms, and a charged copy of them) against
    slab_correction_plain with the extended volume of boxL; the whole
    compute_traced against the CPU's plain run in f64."""
    from lammps_buck_intel_tpu_torch.models.kspace.pppm import \
        slab_correction_plain
    from lammps_buck_intel_tpu_torch.models.kspace.pppm_npt import TracedPPPM

    cfg = load_deck("rhodo_npt_ad.yaml")
    for prec in ("double", "single"):
        cfg["precision"] = prec
        sim = build_simulation(cfg, device="cuda")
        tp, flt, acc = sim.kspace, sim.precision.flt, sim.precision.acc
        ftol, etol = TOL[flt]
        label = f"rhodo_npt_ad/{prec}"
        boxL = sim.state.boxL * torch.tensor([1.01, 0.99, 1.02]).to(
            sim.state.boxL)
        x, q = sim.state.x, sim.q
        kc = tp.tables(boxL)
        c = tp.consts(x.device, flt)
        box = (tp._center, boxL)
        planes = pppm_cells.AtomPlanes(x[0], x[1], x[2], q, torch.arange(
            x.shape[1], dtype=torch.int32, device=x.device))
        mesh = pppm_cells.deposit_plain(tp.pm, planes, box)
        rhat = torch.fft.rfftn(mesh.to(acc)).contiguous()
        u = torch.fft.irfftn(kc["G_half"] * rhat, s=tp.grid).to(
            flt).contiguous()
        n = x.shape[1]
        fk = torch.stack(pppm_ops.gather_ad(tp.pm, planes, u, n, acc,
                                            c["coef"], c["dcoef"], kc["sf"],
                                            box))
        fp = torch.stack(pppm_cells.gather_ad_plain(tp.pm, planes, u, acc,
                                                    kc["sf"], box))
        _rest_compare(label, "pppm_gather_ad (box on the card)", fk, fp,
                      ftol)
        pm3 = dataclasses.replace(tp.pm, slab=3.0, _consts={})
        fzk = torch.zeros(n, dtype=acc, device=x.device)
        ek = pppm_ops.slab(pm3, x[2], q, fzk, True, boxL)
        L = boxL.to(acc) * torch.tensor([1.0, 1.0, 3.0]).to(boxL.device, acc)
        ep, fzp = slab_correction_plain(pm3, x[2], q, True, L[0] * L[1] * L[2],
                                        L[2])
        _rest_compare(label, "pppm_slab (box on the card)", fzk, fzp, ftol)
        p64 = dataclasses.replace(pm3, acc_dtype=torch.float64, _consts={})
        L64 = L.double()
        e64, _ = slab_correction_plain(p64, x[2].double(), q.double(), True,
                                       L64[0] * L64[1] * L64[2], L64[2])
        _slab_energy_check(label, ek, ep, e64, etol)
        _slab_charged(label + " (box on the card)", pm3, x[2], q,
                      torch.ones_like(q, dtype=torch.bool),
                      (boxL, L[0] * L[1] * L[2], L[2]))
        if prec == "single":
            from lammps_buck_intel_tpu_torch.models.kspace.pppm_npt import \
                sf_refit

            Lk = tp.kspace_lengths(boxL)
            sf_ms = cuda_ms(lambda: sf_refit(kc["G"], Lk, tp.grid, c))
            tg_ms = cuda_ms(lambda: tp.tables(boxL))
            out["sf_refit"] = dict(ms=sf_ms, tables_ms=tg_ms)
            print(f"[rest] {label}: the self-force re-fit (torch.tensordot "
                  f"and two products on the {tp.grid} G) {sf_ms:.4f} ms of "
                  f"the block's tables {tg_ms:.4f} ms")
        if prec == "double":
            tcpu = TracedPPPM(tp.pm, tp._center)
            rk = tp.compute_traced(x, q, boxL, kc=kc)
            rp = tcpu.compute_traced(x.cpu(), q.cpu(), boxL.cpu())
            _rest_compare(label, "compute_traced (kernels vs CPU plain)",
                          torch.stack(rk.f).cpu(), torch.stack(rp.f), 1e-11)
        del sim, tp, x, q, planes
        torch.cuda.empty_cache()


def _rest_ewald(out):
    """K11 traced at cristobalite_ewald_npt.yaml's K = 31,248 and 11,520
    atoms (jittered by up to 0.1 A, the box stretched by (1.01, 0.99,
    1.02)): its tables against traced_tables_plain, and compute_traced (K11
    traced, K11a, K11b) against ewald_compute_traced_plain on the card, f64
    and f32; K11 traced timed in f32."""
    from lammps_buck_intel_tpu_torch.models.kspace import ewald as tewald
    from lammps_buck_intel_tpu_torch.ops import ewald as ewald_ops

    cfg = load_deck("cristobalite_ewald_npt.yaml")
    for prec in ("double", "single"):
        cfg["precision"] = prec
        sim = build_simulation(cfg, device="cuda")
        ew, flt, acc = sim.kspace, sim.precision.flt, sim.precision.acc
        rng = np.random.default_rng(SEED + 7)
        x = sim.state.x + torch.as_tensor(rng.uniform(
            -0.1, 0.1, tuple(sim.state.x.shape))).to(sim.state.x)
        q = sim.q
        boxL = sim.state.boxL * torch.tensor([1.01, 0.99, 1.02]).to(
            sim.state.boxL)
        ftol, etol = EWALD_TOL[flt]
        label = f"cristobalite_ewald_npt/{prec}"
        m = ew.m_rows(x.device, flt)
        tk = ewald_ops.ewald_traced(m, boxL, ew.g_ewald, acc)
        tp = tewald.traced_tables_plain(m, boxL, ew.g_ewald, acc)
        worst = 0.0
        for k in ("kv_rows", "ug", "ug_acc", "vfac"):
            _rest_compare(label, f"ewald_traced {k}", tk[k], tp[k],
                          1e-5 if flt == torch.float32 else 1e-12)
            worst = max(worst, float((tk[k] - tp[k]).abs().max()))
        if prec == "single":
            out["ewald_traced"] = {"max_abs_err": worst}
        rk = ew.compute_traced(x, q, boxL)
        rp = tewald.ewald_compute_traced_plain(ew, x, q, boxL)
        _rest_compare(label, "compute_traced forces", torch.stack(rk.f),
                      torch.stack(rp.f), ftol)
        e_err, v_err = scalar_rel(rk.elong, rp.elong), rel_err(rk.virial,
                                                               rp.virial)
        print(f"[rest] {label} compute_traced: elong rel {e_err:.3e}, "
              f"virial rel {v_err:.3e} (tol {etol})")
        if not (e_err <= etol and v_err <= etol):
            raise AssertionError(f"K11 traced {label}: energy or virial off")
        if prec == "single":
            K = m.shape[1]
            fs = m.element_size()
            accs = torch.empty((), dtype=acc).element_size()
            b_ms, b_by = bound(K * (3 * fs + 4 * fs + 7 * accs) + 3 * fs,
                               K * OPS_EWALD_TRACED_K)
            def fn():
                return ewald_ops.ewald_traced(m, boxL, ew.g_ewald, acc)
            ms, dev_ms = cuda_ms(fn), device_ms(fn)
            plain_ms = cuda_ms(lambda: tewald.traced_tables_plain(
                m, boxL, ew.g_ewald, acc), reps=3)
            out["ewald_traced"].update(ms=ms, device_ms=dev_ms,
                                       plain_ms=plain_ms, library_ms=None,
                                       bound_ms=b_ms, bound_by=b_by)
            print(f"[rest] ewald_traced f32 at K {K}: kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f}), plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by})")
        del sim, ew, x, q
        torch.cuda.empty_cache()


def phase_rest_kernels():
    """The four kernels of this path against their plain versions on the
    card, f32 and f64, at the decks' shapes (K10 slab at the slab deck's
    in ``phase_rest_decks``)."""
    out = {}
    _rest_cell_ad(out)
    _rest_traced(out)
    _rest_ewald(out)
    return out


def phase_rest_record(rec: dict):
    """The six shrunk decks (examples/kspace_rest_cases.py) in f64 on the
    card against the JAX package's record (tests/goldens/
    torch_kspace_rest.json) at REST_RECORD_TOL: the engine and solver,
    step-0 forces, every row, final positions and images; and each NPT
    case in f32 at the same size against the record's rows (REST comment
    above)."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import kspace_rest_cases as kc

    with tempfile.TemporaryDirectory() as tmp:
        for name, r in rec["cases"].items():
            _, _, _, steps, every = kc.CASES[name]
            ops.reset_launches()
            sim = build_simulation(jax_deck(kc.deck_cfg(name, tmp)),
                                   device="cuda")
            ks = sim.kspace
            pm = getattr(ks, "pm", ks)
            if (type(sim).__name__ != r["engine"]
                    or type(ks).__name__ != r["kspace"]
                    or abs(pm.g_ewald - r["g_ewald"]) > 1e-12 * r["g_ewald"]
                    or ("grid" in r and list(pm.grid) != r["grid"])
                    or ("n_k" in r and pm.kvecs.shape[0] != r["n_k"])):
                raise AssertionError(f"[rest record] {name}: engine or "
                                     "solver differs from the record")
            pick = np.asarray(r["atoms"])
            f0 = sim.get_atoms()["f"][pick]
            rows = sim.run(steps, thermo_every=every, log=False)
            at = sim.get_atoms()
            ref_f = np.asarray(r["f0"])
            L = float(np.max(sim.box.lengths))
            errs = {"f0": float(np.abs(f0 - ref_f).max()
                                / np.abs(ref_f).max()),
                    "x_end": float(np.abs(at["x"][pick] - np.asarray(
                        r["x_end"])).max()) / L}
            for row, ref in zip(rows, r["rows"], strict=True):
                for k, v in ref.items():
                    if k != "step" and (v != 0.0 or row[k] != 0.0):
                        errs[f"{k}@{ref['step']}"] = scalar_rel(row[k], v)
            images = bool(np.array_equal(at["image"][pick],
                                         np.asarray(r["image_end"])))
            print(f"[rest record] {name} f64, {sim.n_atoms} atoms "
                  f"({r['engine']}, {r['kspace']}): worst row "
                  f"{max(v for k, v in errs.items() if '@' in k):.3e}, "
                  f"f0 {errs['f0']:.3e}, x_end {errs['x_end']:.3e}, images "
                  f"equal {images}; launches "
                  f"{ {k: v for k, v in ops.LAUNCHES.items() if v} }")
            bad = {k: v for k, v in errs.items() if not v <= REST_RECORD_TOL}
            if bad or not images:
                raise AssertionError(f"[rest record] {name} disagrees with "
                                     f"the JAX record: {bad}")
            del sim
            if r["engine"] == "NPTSimulation":
                sim = build_simulation(
                    jax_deck(kc.deck_cfg(name, tmp, "single")), device="cuda")
                rows = sim.run(steps, thermo_every=every, log=False)
                n = sim.n_atoms
                dev = [abs(row["etotal"] - ref["etotal"]) / n
                       for row, ref in zip(rows, r["rows"], strict=True)]
                print(f"[rest record] {name} f32 against the f64 record: "
                      f"|d etotal| / N per row {np.round(dev, 8).tolist()} "
                      f"(gate {REST_NPT_F32_TOL}; the record's drift "
                      f"{r['drift']:.4e})")
                if not max(dev) <= REST_NPT_F32_TOL:
                    raise AssertionError(f"[rest record] {name}: the f32 run "
                                         "strays from the f64 record")
                del sim
            torch.cuda.empty_cache()


def _rest_run(name, need, step0=None, gate=None, engine=None, thermo=None,
              cfg=None):
    """A deck unedited (or ``cfg``, the deck edited) through
    build_simulation and run on the card in f32 as run_deck calls them,
    launch counts set to 0 just before and read just after: the engine,
    every kernel of ``need`` launched, finite rows, step 0 under the
    _STEP0_FIELDS rule against ``step0``, the drift max |etotal - e0| / N
    under ``gate`` (where given).  Returns the launches, ms/step, the
    step-0 row, the drift and the engine."""
    if cfg is None:
        cfg = load_deck(name)
    if thermo is not None:
        cfg["thermo"] = thermo
    ops.reset_launches()
    t0 = time.perf_counter()
    sim = build_simulation(cfg, device="cuda")
    setup_s = time.perf_counter() - t0
    steps = int(cfg["run"])
    rows = sim.run(steps, thermo_every=int(cfg["thermo"]), log=False)
    ran = dict(ops.LAUNCHES)
    n = sim.n_atoms
    missing = [k for k in need if ran[k] <= 0]
    if (missing or rows[-1]["step"] != steps
            or (engine is not None and type(sim).__name__ != engine)):
        raise AssertionError(f"{name}: {type(sim).__name__}, {n} atoms, "
                             f"{rows[-1]['step']} steps, kernels not "
                             f"launched {missing}")
    row = rows[0]
    if step0 is not None:
        step0_check(name, row, step0, n)
    for r in rows:
        for k in ("temp", "epair", "etotal", "press"):
            if not np.isfinite(r[k]):
                raise AssertionError(f"{name}: non-finite {k}")
    drift = max(abs(r["etotal"] - row["etotal"]) for r in rows) / n
    wall = sim.timings["run"]
    ks = sim.kspace
    pm = getattr(ks, "pm", ks)
    solver = (f"mesh {pm.grid} diff {pm.diff} slab {pm.slab}"
              if hasattr(pm, "grid") else f"K {pm.kvecs.shape[0]}")
    print(f"[rest deck] {name}: {type(sim).__name__} + {type(ks).__name__} "
          f"({solver}), {n} atoms x {steps} steps in {wall:.3f} s -> "
          f"{n * steps / wall:,.0f} atom-steps/s, {1e3 * wall / steps:.4f} "
          f"ms/step (thermo every {cfg['thermo']}; set-up {setup_s:.1f} s); "
          f"rows " + ", ".join(
              f"{r['step']}: T {r['temp']:.2f} E {r['etotal']:.8g} P "
              f"{r['press']:.5g}" for r in rows)
          + f"; drift {drift:.4e}/atom (gate {gate}); launches {ran}")
    if step0 is not None:
        print(f"[rest deck] {name}: step 0 temp {row['temp']:.6g} elong "
              f"{row['elong']:.8g} etotal {row['etotal']:.8g} press "
              f"{row['press']:.6g} (record {step0['temp']:.6g}, "
              f"{step0['elong']:.8g}, {step0['etotal']:.8g}, "
              f"{step0['press']:.6g})")
    if gate is not None and not drift <= gate:
        raise AssertionError(f"{name}: drift {drift:.3e}/atom > gate {gate}")
    return dict(launches=ran, ms_step=1e3 * wall / steps, row=row,
                drift=drift, sim=sim)


def _rest_slab_kernel(sim, out):
    """K10 slab against slab_correction_plain at the slab deck's last slot
    state (259,200 atoms in 337,920+ slots; empty slots carry q = 0), f32
    as the run left it and f64 on the same positions, neutral and with
    every live charge shifted by REST_SLAB_DQ; timed in f32."""
    from lammps_buck_intel_tpu_torch.models.kspace.pppm import \
        slab_correction_plain

    pm, st = sim.kspace, sim.state
    p64 = dataclasses.replace(pm, acc_dtype=torch.float64, _consts={})
    e64, f64 = slab_correction_plain(p64, st.z.double(), st.q.double(), True)
    # the sizes fz and e_slab would have if M = sum q z did not cancel
    qz = st.q.double() * st.z.double()
    s_qz, m64 = float(qz.abs().sum()), float(qz.sum())
    efact = 2.0 * math.pi * float(pm.qqrd2e) / float(pm.volume)
    f_scale = 2.0 * efact * float(st.q.abs().max()) * s_qz
    e_scale = efact * s_qz * s_qz
    for dt in (torch.float64, torch.float32):
        z, q = st.z.to(dt), st.q.to(dt)
        pmd = dataclasses.replace(pm, acc_dtype=dt, _consts={})
        fzk = torch.zeros(z.shape[0], dtype=dt, device=z.device)
        ek = pppm_ops.slab(pmd, z, q, fzk, True)
        ep, fzp = slab_correction_plain(pmd, z, q, True)
        ftol, etol = TOL[dt]
        label = f"cristobalite_slab {sim.n_atoms} atoms/{dt}"
        fd = float((fzk - fzp).abs().max()) / f_scale
        ed = abs(float(ek) - float(ep)) / e_scale
        fd64 = float((fzk.double() - f64).abs().max()) / f_scale
        ed64 = abs(float(ek) - float(e64)) / e_scale
        print(f"[rest] {label} pppm_slab on the scale of the terms of M "
              f"(M {m64:.6g}, sum |q z| {s_qz:.6g}): kernel against plain, "
              f"forces "
              f"{fd:.3e}, e_slab {ed:.3e}; against f64 plain {fd64:.3e}, "
              f"{ed64:.3e} (tol {ftol}, {etol}); of max|fz| against plain "
              f"{rel_err(fzk, fzp):.3e}, against f64 "
              f"{rel_err(fzk.double(), f64):.3e}")
        if not (max(fd, fd64) <= ftol and max(ed, ed64) <= etol):
            raise AssertionError(f"K10 slab {label}: forces or energy off")
        if dt == torch.float32:
            out.setdefault("pppm_slab", {})["max_abs_err"] = float(
                (fzk - fzp).abs().max())
        print(f"[rest] {label}: max |fz| {float(fzp.abs().max()):.4g}")
        _slab_charged(label, pmd, z, q, st.aid < sim.n_atoms)
    z, q = st.z, st.q
    ns, fs = z.shape[0], z.element_size()
    fz = torch.zeros(ns, dtype=pm.acc_dtype, device=z.device)
    accs = fz.element_size()
    b_ms, b_by = bound(ns * (2 * fs + 2 * accs), ns * OPS_SLAB_ATOM)
    fn = lambda: pppm_ops.slab(pm, z, q, fz, True)  # noqa: E731
    ms, dev_ms = cuda_ms(fn), device_ms(fn)
    plain_ms = cuda_ms(lambda: slab_correction_plain(pm, z, q, True), reps=3)
    out["pppm_slab"].update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"[rest] pppm_slab f32 at {ns} slots: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by})")


def _rest_npt_full(name, steps, every):
    """An NPT deck at full width on the card in f64 and in f32 over the
    record's ``steps`` (rows every ``every``): |etotal_f32 - etotal_f64| /
    N at every row within REST_NPT_F32_TOL.  Returns the largest."""
    rows = {}
    for prec in ("double", "single"):
        cfg = load_deck(name)
        cfg.update(precision=prec, run=steps, thermo=every)
        sim = build_simulation(cfg, device="cuda")
        rows[prec] = sim.run(steps, thermo_every=every, log=False)
        n = sim.n_atoms
        del sim
        torch.cuda.empty_cache()
    dev = [abs(a["etotal"] - b["etotal"]) / n
           for a, b in zip(rows["single"], rows["double"], strict=True)]
    print(f"[rest deck] {name} at {n} atoms, f32 against f64 on the card "
          f"over {steps} steps: |d etotal| / N per row "
          f"{np.round(dev, 8).tolist()} (gate {REST_NPT_F32_TOL})")
    if not max(dev) <= REST_NPT_F32_TOL:
        raise AssertionError(f"{name}: the f32 run strays from the f64 run")
    return max(dev)


def phase_rest_decks(rec, golden, nlist_rec, ewald_rec, npt_rec, times,
                     out):
    """The six decks unedited on the card in f32 through build_simulation
    and run, beside the decks they vary earlier in this call (``times``:
    ms/step of cristobalite_pppm.yaml, cristobalite_pppm_nlist.yaml,
    cristobalite_ewald.yaml and rhodo_npt.yaml x6x6x4)."""
    from lammps_buck_intel_tpu_torch.models.kspace import CellPPPM

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import kspace_rest_cases as kc

    silica_gate = load_golden("long_silica_pppm.json")["drift_gate"]
    pair = ("cellpair", "rebin_incremental", "verlet_kick_drift",
            "verlet_kick", "verlet_ke")
    res = {}
    # cristobalite_pppm_ad.yaml: the cell engine, the record's mesh
    r = _rest_run("cristobalite_pppm_ad.yaml",
                  pair + ("pppm_deposit_cells",) + REST_AD[1:], golden["row"],
                  silica_gate, "CellPairSimulation", thermo=50)
    sim = r.pop("sim")
    if not isinstance(sim.kspace, CellPPPM) or sim.kspace.pm.grid != tuple(
            golden["pppm_grid"]):
        raise AssertionError("cristobalite_pppm_ad.yaml: not CellPPPM on the "
                             "record's mesh")
    recip_check("cristobalite_pppm_ad.yaml", r["row"],
                sim.kspace.pm.elong_self, golden)
    res["ad_cell"] = r
    del sim
    torch.cuda.empty_cache()
    # the list engine's twin: the generic mesh of cristobalite_pppm_nlist
    r = _rest_run("cristobalite_pppm_ad_nlist.yaml",
                  NLIST_PATH + REST_AD + ("nlist_build",), golden["row"],
                  silica_gate, "Simulation", thermo=50)
    sim = r.pop("sim")
    full = nlist_rec["full"]["cristobalite_pppm_nlist"]
    if list(sim.kspace.grid) != full["pppm_grid"]:
        raise AssertionError("cristobalite_pppm_ad_nlist.yaml: mesh differs")
    recip_check("cristobalite_pppm_ad_nlist.yaml", r["row"],
                sim.kspace.elong_self, golden)
    res["ad_nlist"] = r
    del sim
    torch.cuda.empty_cache()
    # kspace_modify mesh: cristobalite_pppm_nlist.yaml on the mesh
    # 120x128x96 for 10 steps
    cfg = load_deck("cristobalite_pppm_nlist.yaml")
    cfg["kspace_style"]["grid"] = list(REST_GRID)
    cfg.update(run=10, thermo=5)
    r = _rest_run("cristobalite_pppm_nlist.yaml grid 120x128x96",
                  NLIST_PATH + NLIST_PPPM + ("nlist_build",), golden["row"],
                  silica_gate, "Simulation", cfg=cfg)
    sim = r.pop("sim")
    if tuple(sim.kspace.grid) != REST_GRID:
        raise AssertionError(f"kspace_modify mesh: the solver's mesh is "
                             f"{sim.kspace.grid}, not {REST_GRID}")
    recip_check("cristobalite_pppm_nlist.yaml grid 120x128x96", r["row"],
                sim.kspace.elong_self, golden)
    res["grid"] = r
    del sim
    torch.cuda.empty_cache()
    # cristobalite_slab.yaml: the generic z-extended PPPM on the cell
    # engine's slot positions, step 0 against the record scaled to 30
    # copies, the drift gated at twice the record's f64 drift at one copy
    sf = rec["slab_full"]
    slab_gate = 2.0 * sf["drift"]
    r = _rest_run("cristobalite_slab.yaml",
                  pair + ("pppm_deposit", "pppm_spectral", "pppm_gather",
                          "pppm_slab"), sf["row"], slab_gate,
                  "CellPairSimulation")
    sim = r.pop("sim")
    print(f"[rest deck] cristobalite_slab.yaml: mesh {sim.kspace.grid} "
          f"(record at one copy {sf['grid']}), drift gate {slab_gate:.4e} = "
          f"2 x the JAX f64 run of one copy ({sf['recorded_atoms']} atoms)")
    _rest_slab_kernel(sim, out)
    res["slab"] = r
    del sim
    torch.cuda.empty_cache()
    # cristobalite_ewald_cell.yaml: Ewald on the slot positions
    r0 = ewald_rec["ewald_step0"]
    r = _rest_run("cristobalite_ewald_cell.yaml",
                  pair + ("ewald_sk", "ewald_force"), r0["row"], silica_gate,
                  "CellPairSimulation")
    sim = r.pop("sim")
    recip_check("cristobalite_ewald_cell.yaml", r["row"],
                sim.kspace.elong_self, r0)
    res["ewald_cell"] = r
    del sim
    torch.cuda.empty_cache()
    # cristobalite_ewald_npt.yaml: the NPT engine with K11 traced; step 0
    # is the NVE deck's row (the same state and energies)
    r = _rest_run("cristobalite_ewald_npt.yaml",
                  ("nlist_build", "nlist_pair", "ewald_traced", "ewald_sk",
                   "ewald_force", "npt_ke3", "npt_vscale_kick",
                   "npt_drift_dilate"), r0["row"], None, "NPTSimulation")
    sim = r.pop("sim")
    res["ewald_npt"] = r
    del sim
    torch.cuda.empty_cache()
    res["ewald_npt"]["f32_dev"] = _rest_npt_full(
        "cristobalite_ewald_npt.yaml", *kc.CASES["ewald_npt"][3:])
    # rhodo_npt_ad.yaml: step 0 against long_rhodo_npt.json (ad and ik
    # share the energy), then x6x6x4 timed beside rhodo_npt.yaml's
    npt_ad = NPT_KERNELS + REST_AD + BONDED_KERNELS + NPT_SHAKE + (
        "verlet_kick", "verlet_ke", "nhc_scale")
    r = _rest_run("rhodo_npt_ad.yaml", npt_ad,
                  load_golden("long_rhodo_npt.json")["rows"][0], None,
                  "NPTSimulation")
    res["rhodo_npt_ad"] = r
    r.pop("sim")
    torch.cuda.empty_cache()
    r["f32_dev"] = _rest_npt_full("rhodo_npt_ad.yaml",
                                  *kc.CASES["rhodo_npt_ad"][3:])
    cfg = load_deck("rhodo_npt_ad.yaml")
    cfg["replicate"] = list(BIG_REPLICATE)
    ops.reset_launches()
    sim = build_simulation(cfg, device="cuda")
    rows = sim.run(int(cfg["run"]), thermo_every=int(cfg["thermo"]),
                   log=False)
    ran = dict(ops.LAUNCHES)
    full = npt_rec["full"]["x".join(map(str, BIG_REPLICATE))]
    step0_check("rhodo_npt_ad.yaml x6x6x4", rows[0], full["rows"][0],
                sim.n_atoms)
    if any(ran[k] <= 0 for k in npt_ad) or not all(
            np.isfinite(rw["etotal"]) for rw in rows):
        raise AssertionError("rhodo_npt_ad.yaml x6x6x4: a kernel not "
                             "launched or a non-finite row")
    big_ms = 1e3 * sim.timings["run"] / int(cfg["run"])
    res["rhodo_npt_ad_big"] = dict(launches=ran, ms_step=big_ms)
    del sim
    torch.cuda.empty_cache()
    print(f"[rest deck] ms/step in this call: cristobalite_pppm_ad.yaml "
          f"{res['ad_cell']['ms_step']:.4f} against cristobalite_pppm.yaml "
          f"{times['cris']:.4f}; cristobalite_pppm_ad_nlist.yaml "
          f"{res['ad_nlist']['ms_step']:.4f} against "
          f"cristobalite_pppm_nlist.yaml {times['nlist']:.4f}; "
          f"cristobalite_ewald_cell.yaml {res['ewald_cell']['ms_step']:.4f}"
          f" against cristobalite_ewald.yaml (engine nlist) "
          f"{times['ewald']:.4f}; cristobalite_ewald_npt.yaml "
          f"{res['ewald_npt']['ms_step']:.4f}; cristobalite_slab.yaml "
          f"{res['slab']['ms_step']:.4f}; rhodo_npt_ad.yaml "
          f"{res['rhodo_npt_ad']['ms_step']:.4f} (31,104 atoms), x6x6x4 "
          f"{big_ms:.4f} against rhodo_npt.yaml x6x6x4 "
          f"{times['npt_big']:.4f}")
    return res


def _k9c_device_again() -> float:
    """K9c's device time at buck_small.yaml's 500 atoms, traced once more
    late in the call (phase 11's trace may lose its lead)."""
    from lammps_buck_intel_tpu_torch.neighbor import neighbor_list as nlm

    sim = _nlist_sim("buck_small.yaml", "single")
    x, lo, L, spec = sim.state.x, sim._lo, sim._boxL, sim.spec
    dev_ms = device_ms(lambda: nlm.build_dense(x, lo, L, spec,
                                               sim._special))
    print(f"[K9c] nlist_dense f32 at {sim.n_atoms} atoms, traced again: "
          f"device {dev_ms:.4f} ms")
    del sim
    return dev_ms


def main():
    t_start = time.perf_counter()
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
    cris = phase_deck(
        "cristobalite_pppm.yaml",
        golden, 50,
        pair + ("pppm_deposit_cells", "pppm_spectral", "pppm_gather"),
        load_golden("long_silica_pppm.json")["drift_gate"])
    launches = cris["launches"]
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
    torch.cuda.empty_cache()

    # the neighbor-list Simulation (K9c, K10): engine nlist
    k9c = phase_nlist_dense()
    phase_nlist_k10_f64()
    nlist_rec = load_golden("torch_nlist.json")
    ncris = phase_nlist_cristobalite(golden, nlist_rec, cris["ms_step"])
    nrho = phase_nlist_rhodo(shake_rec, nlist_rec, sbig,
                             rk["cellpair_ljcharmm"]["device_ms"])
    phase_nlist_record(nlist_rec)
    small = phase_buck_small()
    torch.cuda.empty_cache()

    # Ewald (K11a, K11b) and coul/cut on the neighbor-list Simulation
    k11 = phase_ewald_kernels()
    ewald_rec = load_golden("torch_ewald.json")
    phase_ewald_record(ewald_rec)
    ewd = phase_ewald_deck(ewald_rec)
    cut = phase_coul_cut(ewald_rec)
    torch.cuda.empty_cache()

    # the hexane path: lj/long + exclusion (K1), pppm/disp (K5, K12a, K8),
    # fix rigid/small (K15a-c)
    phase_hexane_kernels()
    hex_rec = load_golden("torch_disp.json")
    phase_hexane_record(hex_rec)
    hsmall, hbig, htimes = phase_hexane(hex_rec)
    torch.cuda.empty_cache()

    # long-range dispersion with long-range Coulomb and the channel mixes:
    # K1 / K9b DISP_LONG, K12b disp_deposit, K12c disp_gather
    phase_mix_kernels()
    mix_rec = load_golden("torch_disp_mix.json")
    phase_mix_record(mix_rec)
    mcell, mnlist, mhex, mtimes = phase_mix(mix_rec)
    torch.cuda.empty_cache()

    # per-atom energy and virial (K9d, K10pa, K11pa, K18b) and dump custom
    t_pa = time.perf_counter()
    phase_peratom_record(load_golden("torch_peratom.json"))
    dumps = phase_dump({"cristobalite_pppm_dump.yaml": cris["ms_step"],
                        "cristobalite_ewald_dump.yaml": ewd["ms_step"],
                        "rhodo_nve_dump.yaml": sbig["small_ms_step"]})
    dcris, dewd, drho = (dumps[k] for k in DUMP_PATH)
    print(f"[time] the per-atom phases took {time.perf_counter() - t_pa:.1f} "
          f"s; {time.perf_counter() - t_start:.1f} s since the start")
    torch.cuda.empty_cache()

    # per-atom dispersion PPPM (K12pa) on the pppm/disp dump decks and the
    # slot-order per-atom PPPM (K18 slots)
    t_pd = time.perf_counter()
    phase_peratom_disp_record(load_golden("torch_peratom_disp.json"))
    ddumps = phase_dump_disp({
        "cristobalite_buck_long_dump.yaml": mcell["ms_step"],
        "hexane_gen_dump.yaml": hsmall["ms_step"],
        "hexane_gen_arith_dump.yaml": mhex["ms_step"]})
    dbl, dhex, dhexa = (ddumps[k] for k in DISP_DUMP_PATH)
    k9c_dev = _k9c_device_again()
    if np.isnan(k9c["device_ms"]):
        k9c["device_ms"] = k9c_dev
    print(f"[time] the per-atom dispersion phases took "
          f"{time.perf_counter() - t_pd:.1f} s; "
          f"{time.perf_counter() - t_start:.1f} s since the start")
    torch.cuda.empty_cache()

    # the rest of the Coulomb k-space: pppm diff ad (K10 ad spectral, K10
    # ad gather), kspace_modify slab (K10 slab), Ewald on the cell engine
    # and under fix npt (K11 traced)
    t_rest = time.perf_counter()
    rest_rec = load_golden(REST_REC)
    krest = phase_rest_kernels()
    t_k = time.perf_counter()
    phase_rest_record(rest_rec)
    t_r = time.perf_counter()
    rest = phase_rest_decks(
        rest_rec, golden, nlist_rec, ewald_rec, npt_rec,
        dict(cris=cris["ms_step"], nlist=ncris["ms_step"],
             ewald=ewd["ms_step"], npt_big=nbig["ms_step"]), krest)
    print(f"[time] the rest of the Coulomb k-space took "
          f"{time.perf_counter() - t_rest:.1f} s (kernels {t_k - t_rest:.1f}"
          f", f64 record {t_r - t_k:.1f}, decks "
          f"{time.perf_counter() - t_r:.1f}); "
          f"{time.perf_counter() - t_start:.1f} s since the start")

    def row(name, source, replaces, launch_key, r, launches=launches):
        return dict(name=name, route="cuda", source=f"{SRC}/{source}",
                    replaces=f"lammps_buck_intel_tpu/{replaces}",
                    launches=launches[launch_key],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    device_ms=(None if np.isnan(r["device_ms"])
                               else r["device_ms"]),
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
        row("pppm_deposit_cells", "pppm.cu",
            "models/kspace/pppm_cells.py:580", "pppm_deposit_cells",
            pp["deposit_cells"]),
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
        # the neighbor-list Simulation: K9c timed at 500 atoms and launched
        # on buck_small.yaml's run of that size; K10 (the staged route through K5 / K7 /
        # K8 on the generic mesh) timed and launched on
        # cristobalite_pppm_nlist.yaml's run at 259,200 atoms
        row("nlist_dense", "nlist.cu", "neighbor/neighbor_list.py:184",
            "nlist_dense", k9c, small["launches"]),
        row("pppm_compute_generic", "pppm.cu", "models/kspace/pppm.py:570",
            "pppm_deposit", ncris["k10"], ncris["launches"]),
        # Ewald: timed on the jittered 11,520-atom crystal, launched on
        # cristobalite_ewald.yaml's run; K9b's coul/cut branch timed and
        # launched on cristobalite_coul_cut.yaml's 92,160 atoms
        row("ewald_sk", "ewald.cu", "models/kspace/ewald.py:185", "ewald_sk",
            k11["ewald_sk"], ewd["launches"]),
        row("ewald_force", "ewald.cu", "models/kspace/ewald.py:185",
            "ewald_force", k11["ewald_force"], ewd["launches"]),
        row("nlist_pair_coul_cut", "nlist.cu", "models/pair/driver.py:78",
            "nlist_pair", cut, cut["launches"]),
        # the hexane path: times at hexane_gen_big.yaml's 192,000 atoms,
        # launches of its run
        row("cellpair_forces_lj_long_exclusion", "cellpair.cu",
            "models/pair/cellpair.py:291", "cellpair",
            htimes["cellpair_lj_long"], hbig["launches"]),
        row("pppm_deposit_disp", "pppm.cu", "models/kspace/pppm_cells.py:580",
            "pppm_deposit_cells", htimes["pppm_deposit_disp"],
            hbig["launches"]),
        row("disp_spectral", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:283", "disp_spectral",
            htimes["disp_spectral"], hbig["launches"]),
        row("pppm_gather_disp", "pppm.cu", "models/kspace/pppm_cells.py:633",
            "pppm_gather", htimes["pppm_gather_disp"], hbig["launches"]),
        row("rigid_force_torque", "rigid.cu", "integrate/rigid.py:235",
            "rigid_force_torque", htimes["rigid_force_torque"],
            hbig["launches"]),
        row("rigid_update", "rigid.cu", "integrate/rigid.py:277",
            "rigid_update", htimes["rigid_update"], hbig["launches"]),
        row("rigid_virial", "rigid.cu", "integrate/rigid.py:333",
            "rigid_virial", htimes["rigid_virial"], hbig["launches"]),
        # buck/long + coul/long and the channel kernels: times at the
        # 259,200-atom silica decks' last states (2 channels) and at
        # hexane_gen_big.yaml with mix arithmetic (7 channels); launches
        # of cristobalite_buck_long.yaml (cell engine),
        # cristobalite_buck_long_nlist.yaml (list engine) and
        # hexane_gen_arith.yaml (7 channels)
        row("cellpair_forces_buck_long_coul_long", "cellpair.cu",
            "models/pair/cellpair.py:291", "cellpair",
            mtimes["k1_buck_long_long"], mcell["launches"]),
        row("nlist_pair_buck_long_coul_long", "nlist.cu",
            "models/pair/driver.py:78", "nlist_pair",
            mtimes["k9b_buck_long_long"], mnlist["launches"]),
        row("disp_deposit", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:303", "disp_deposit",
            mtimes["disp_deposit_2ch"], mcell["launches"]),
        row("disp_gather", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:405", "disp_gather",
            mtimes["disp_gather_2ch"], mcell["launches"]),
        row("disp_deposit_7_channels", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:303", "disp_deposit",
            mtimes["disp_deposit_7ch"], mhex["launches"]),
        row("disp_gather_7_channels", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:405", "disp_gather",
            mtimes["disp_gather_7ch"], mhex["launches"]),
        # the per-atom computes: times at each dump deck's last state,
        # launches of its run through run_deck (three frames)
        row("nlist_pair_peratom", "nlist.cu", "models/pair/driver.py:196",
            "nlist_pair_peratom", dcris["times"]["nlist_pair_peratom"],
            dcris["launches"]),
        row("pppm_peratom_spectral", "pppm.cu", "models/kspace/pppm.py:650",
            "pppm_peratom_spectral", dcris["times"]["pppm_peratom_spectral"],
            dcris["launches"]),
        row("pppm_peratom_gather", "pppm.cu", "models/kspace/pppm.py:650",
            "pppm_peratom_gather", dcris["times"]["pppm_peratom_gather"],
            dcris["launches"]),
        row("ewald_peratom", "ewald.cu", "models/kspace/ewald.py:261",
            "ewald_peratom", dewd["times"]["ewald_peratom"],
            dewd["launches"]),
        row("bonded_peratom", "bonded.cu", "models/bonded/harmonic.py:294",
            "bonded_peratom", drho["times"]["bonded_peratom"],
            drho["launches"]),
        # the per-atom dispersion PPPM: times at each pppm/disp dump deck's
        # last state (2 channels on the buck/long deck's 144x150x108 mesh,
        # 7 on hexane_gen_arith's), launches of its run (three frames); one
        # channel timed at hexane_gen_big.yaml's 192,000 atoms and launched
        # on hexane_gen_dump.yaml's run
        row("disp_peratom_spectral", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:427", "disp_peratom_spectral",
            dbl["times"]["disp_peratom_spectral"], dbl["launches"]),
        row("disp_peratom_gather", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:427", "disp_peratom_gather",
            dbl["times"]["disp_peratom_gather"], dbl["launches"]),
        row("disp_peratom_spectral_1_channel", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:427", "disp_peratom_spectral",
            htimes["peratom"]["disp_peratom_spectral"], dhex["launches"]),
        row("disp_peratom_gather_1_channel", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:427", "disp_peratom_gather",
            htimes["peratom"]["disp_peratom_gather"], dhex["launches"]),
        row("disp_peratom_spectral_7_channels", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:427", "disp_peratom_spectral",
            dhexa["times"]["disp_peratom_spectral"], dhexa["launches"]),
        row("disp_peratom_gather_7_channels", "pppm_disp.cu",
            "models/kspace/pppm_disp.py:427", "disp_peratom_gather",
            dhexa["times"]["disp_peratom_gather"], dhexa["launches"]),
        # K18 slots: the slot gathers timed at cristobalite_pppm_dump.yaml's
        # last slot state (Coulomb, 105x112x77) and hexane_gen_big.yaml's
        # (dispersion, 154x187x187), launches of one compute_peratom_slots
        # there (no deck calls the slot forms)
        row("pppm_peratom_slots", "pppm.cu",
            "models/kspace/pppm_cells.py:1011", "pppm_peratom_slots",
            dcris["slots"],
            {"pppm_peratom_slots": dcris["slots"]["launches"]}),
        row("disp_peratom_slots", "pppm_disp.cu",
            "models/kspace/pppm_cells.py:1062", "disp_peratom_slots",
            htimes["slots"],
            {"disp_peratom_slots": htimes["slots"]["launches"]}),
        # the rest of the Coulomb k-space: the ad kernels timed at
        # cristobalite_pppm_ad.yaml's jittered slots and launched on its
        # run, K10 slab timed and launched on cristobalite_slab.yaml's,
        # K11 traced timed at cristobalite_ewald_npt.yaml's K and launched
        # on its run
        row("pppm_ad_spectral", "pppm.cu", "models/kspace/pppm.py:717",
            "pppm_ad_spectral", krest["pppm_ad_spectral"],
            rest["ad_cell"]["launches"]),
        row("pppm_gather_ad", "pppm.cu", "models/kspace/pppm.py:717",
            "pppm_gather_ad", krest["pppm_gather_ad"],
            rest["ad_cell"]["launches"]),
        row("pppm_slab", "pppm.cu", "models/kspace/pppm.py:342",
            "pppm_slab", krest["pppm_slab"], rest["slab"]["launches"]),
        row("ewald_traced", "ewald.cu", "models/kspace/ewald.py:200",
            "ewald_traced", krest["ewald_traced"],
            rest["ewald_npt"]["launches"]),
    ]
    print(f"[K9c] torch.cdist + topk at 500 atoms: "
          f"{k9c['cdist_topk_ms']:.4f} ms; [K9b] rhodo_nve_nlist x6x6x4 "
          f"device {nrho['k9b_device_ms']:.4f} ms")
    print(f"[K9b] coul/cut at 92,160 atoms: device {cut['device_ms']:.4f} "
          f"ms, the coul/long branch on the same list "
          f"{cut['long_device_ms']:.4f} ms; cristobalite_ewald.yaml "
          f"{ewd['ms_step']:.4f} ms/step, cristobalite_coul_cut.yaml "
          f"{cut['ms_step']:.4f} ms/step")
    print(f"[hexane] hexane_gen.yaml {hsmall['ms_step']:.4f} ms/step, "
          f"hexane_gen_big.yaml {hbig['ms_step']:.4f} ms/step "
          f"({192000 / hbig['ms_step'] * 1e3:,.0f} atom-steps/s); K15 lane "
          f"widths {json.dumps(htimes['widths'])}")
    print(f"[disp mix] K1 buck/long coul none variant "
          f"{json.dumps(mtimes['k1_buck_long_none'])}; K1 buck/coul/long on "
          f"the same slots {json.dumps(mtimes['k1_buck_coul_long_same_state'])}"
          f"; K9b buck/coul/long on the same list "
          f"{json.dumps(mtimes['k9b_buck_coul_long_same_list'])}; per-channel "
          f"loops: " + ", ".join(
              f"{k} {v['loop_ms']:.4f} ms (device {v['loop_device_ms']:.4f})"
              for k, v in mtimes.items() if "loop_ms" in v))
    print(f"[K1] lj/long + coul/long on hexane_gen_big's slots: "
          f"{json.dumps(mtimes['k1_lj_long_coul_long'])}")
    for name, r in list(dumps.items()) + list(ddumps.items()):
        print(f"[dump] {name}: {r['ms_step']:.4f} ms/step without the "
              f"frames, {r['base_ms']:.4f} without dump; {r['frame_s']:.3f} "
              f"s a frame; K9d {json.dumps(r['times']['nlist_pair_peratom'])}")
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
