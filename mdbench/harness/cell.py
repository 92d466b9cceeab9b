"""One run of one cell: set-up, warm-up, the timed window, the traced
slice and the correctness check.

The program under test is ``lammps_buck_intel_tpu_torch``: its deck
builder (``run.build_simulation``), the engine's ``run`` and ``thermo``,
``get_atoms``, and for a dump the per-atom computes behind
``io.dump.write_custom``.  A production run is one ``sim.run`` over many
thermo intervals; the harness watches each thermo row go by (it wraps
``sim.thermo``) and closes the window after the first row past
``seconds``, so every interval of the window is whole and ends in one
thermo row, rebins, capacity grows and replays included.  A deck with a
``dump`` block runs as ``run.run_deck`` runs it: a frame, then ``every``
steps of ``sim.run``, and so on.
"""
from __future__ import annotations

import gc
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import checks, spec
from .layers import LayerMap
from .trace import ANNOTATION, Lost, Slice


class _Closed(Exception):
    """Raised from the thermo hook to end ``sim.run`` at a row."""


def _atoms(sim) -> dict:
    """The program's atoms, with its box (``box``) where fix npt moves
    it."""
    a = sim.get_atoms()
    out = {k: np.asarray(a[k]) for k in ("x", "v", "f", "image")}
    if "boxL" in a:
        out["box"] = np.asarray(a["boxL"], np.float64)
    return out


def run(cfg: dict, tr: dict, seed: int, seconds: float, trace: bool,
        device: str, t_start: float, limits: dict) -> SimpleNamespace:
    """What the run measured, as the metric readers read it."""
    from lammps_buck_intel_tpu_torch.run import build_simulation

    cuda = device == "cuda"
    tmp = tempfile.mkdtemp(prefix="mdbench_")
    try:
        deck = spec.deck(cfg, tr, seed, tmp)
        if cuda:
            from lammps_buck_intel_tpu_torch.ops import build

            build.load_all()
        t = time.perf_counter()
        sim = build_simulation(dict(deck), device=device)
        frontend_s = time.perf_counter() - t
        start = _atoms(sim)
        n = sim.n_atoms
        layer_of = LayerMap()
        if deck.get("dump"):
            out = _run_dump(sim, deck, tr, seconds, trace, layer_of)
        else:
            out = _run_thermo(sim, deck, tr, seconds, trace, layer_of)
        memory_peak = (torch.cuda.max_memory_allocated() if cuda else 0)
        end = _atoms(sim)
        frame = (checks.last_frame(deck["dump"]["file"], n)
                 if deck.get("dump") else None)
        sim.run(1, thermo_every=0, log=False)
        follow = _atoms(sim)
        grows = getattr(sim, "grows", None)   # the cell engine's counter
        del sim
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        numbers = checks.compare(deck, seed, start, end, out["row"], follow,
                                 frame, device)
        check_s = time.perf_counter() - t
    finally:
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    checked = checks.judge(numbers, limits)
    return SimpleNamespace(
        n_atoms=n, setup_s=out["t0"] - t_start, frontend_s=frontend_s,
        window_s=out["t1"] - out["t0"], window_steps=out["steps"],
        intervals=out["intervals"], step_ms=out["step_ms"],
        frames_s=out.get("frames_s", []), grows=grows,
        trace=out.get("trace"), deck=deck, positions=out.get("positions"),
        box=out.get("box"),
        memory_peak=memory_peak, checks=checked, check_s=check_s,
        correct=all(c["value"] <= c["limit"] for c in checked.values()))


def _run_thermo(sim, deck, tr, seconds, trace, layer_of) -> dict:
    thermo = int(tr["thermo"])
    warm = int(tr["warmup_intervals"])
    stamps, rows = [], []
    st = {"t0": None, "t1": None, "stop_at": None, "slice": None}
    orig = sim.thermo

    def open_slice(sl):
        st["slice_atoms"] = _atoms(sim)
        st["slice"], st["k0"] = sl, len(stamps)
        st["stop_at"] = len(stamps) + int(tr["trace_intervals"])
        sl.start()

    def hook():
        with torch.profiler.record_function(ANNOTATION + "thermo"):
            row = orig()
        now = time.perf_counter()
        stamps.append((sim.step_count, now))
        rows.append(row)
        if len(stamps) == warm + 1:
            st["t0"] = now
        elif st["t0"] is not None and st["t1"] is None \
                and now - st["t0"] >= seconds:
            st["t1"] = now
            if not trace:
                raise _Closed
            # the traced slice follows the window in the same run
            open_slice(Slice())
        elif st["stop_at"] is not None and len(stamps) >= st["stop_at"]:
            st["slice"].stop()
            st["stop_at"] = None
            raise _Closed
        return row

    def drive():
        try:
            sim.run(thermo * 10 ** 7, thermo_every=thermo, log=False)
        except _Closed:
            pass

    sim.thermo = hook
    try:
        drive()
        out = _window(stamps, st, warm)
        if trace:
            spin = 1_000_000
            for k in range(3):
                try:
                    out["trace"] = dict(
                        st["slice"].reduce(layer_of),
                        steps=stamps[-1][0] - stamps[st["k0"] - 1][0],
                        rows=len(stamps) - st["k0"])
                    break
                except Lost:
                    if k == 2:
                        raise
                    # a slice that lost its lead is taken again with
                    # longer spins (a new run: its first row is extra)
                    spin *= 4
                    open_slice(Slice(spin))
                    drive()
            out["positions"] = st["slice_atoms"]["x"]
            out["box"] = st["slice_atoms"].get("box")
        out["row"] = rows[-1]
    finally:
        del sim.thermo
    return out


def _window(stamps, state, warm) -> dict:
    """Steps, intervals and per-interval ms/step of the timed window."""
    w = stamps[warm:]
    k1 = next(i for i, (_, t) in enumerate(w) if t >= state["t1"])
    w = w[:k1 + 1]
    steps = w[-1][0] - w[0][0]
    step_ms = [1e3 * (b[1] - a[1]) / (b[0] - a[0])
               for a, b in zip(w[:-1], w[1:])]
    return dict(t0=state["t0"], t1=state["t1"], steps=steps,
                intervals=len(step_ms), step_ms=step_ms)


def _run_dump(sim, deck, tr, seconds, trace, layer_of) -> dict:
    from lammps_buck_intel_tpu_torch.io import dump

    dmp = deck["dump"]
    every, thermo = int(dmp["every"]), int(tr["thermo"])
    rows = []

    def frame(append=True):
        with torch.profiler.record_function(ANNOTATION + "frame"):
            t = time.perf_counter()
            dump.write_custom(dmp["file"], sim, dmp["columns"], append=append)
            return time.perf_counter() - t

    def cycle():
        rows.extend(sim.run(every, thermo_every=thermo, log=False))
        return frame()

    # warm-up: the first frame (a new file), one cycle (an appended frame)
    frame(False)
    cycle()
    t0 = time.perf_counter()
    frames, cycles = [], 0
    while True:
        frames.append(cycle())
        cycles += 1
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    out = dict(t0=t0, t1=t1, steps=cycles * every, intervals=cycles,
               step_ms=[], frames_s=frames, row=rows[-1])
    if trace:
        a = _atoms(sim)
        out["positions"], out["box"] = a["x"], a.get("box")
        spin = 1_000_000
        for k in range(3):
            sl = Slice(spin)
            sl.start()
            cycle()
            sl.stop()
            try:
                out["trace"] = dict(sl.reduce(layer_of), steps=every,
                                    rows=every // thermo + 1)
                break
            except Lost:
                if k == 2:
                    raise
                spin *= 4
        out["row"] = rows[-1]
    return out
