"""The correctness check: the program's outputs against the plain
reference (``mdbench/reference``), each as one number beside its limit.

The reference reads the deck and the seed and works out the atoms, the
velocities, the pair style, the k-space splitting and the topology
itself.  An MD trajectory decorrelates within a few hundred steps, so it
cannot follow the window; it checks the start and the end of it:

- ``start_x``, ``start_v``: the program's atoms after set-up against the
  reference's build of them (replicated positions in A, seeded velocities
  over their rms);
- ``force_max``, ``force_rms``: the program's force on each atom at the
  end of the window against the reference's at the same positions: the
  worst atom over the rms force, and the rms error over the deck's PPPM
  accuracy times the force between two unit charges 1 A apart (LAMMPS'
  definition of ``kspace_style pppm`` accuracy);
- ``energy``: the thermo row's potential energy against the reference's,
  per atom; ``temp``: its temperature against the reference's from the
  program's velocities; ``press``: its pressure against the reference's
  (decks without constraints), over the kinetic pressure;
- ``follow_x``, ``follow_v``: one more step of the program from that
  state against one velocity-Verlet step of the reference (fix nve decks);
- ``pe_atom``, ``stress_atom``: a dump frame's c_pe and c_stress against
  the reference's per-atom energy and stress at the frame's state, the
  worst atom over the rms.

Under fix npt the program's box at the window's end comes with its atoms
(``box``): the window-end numbers are worked out in that box, with the
splittings of the set-up box (``Reference.in_box``); the start numbers
stay in the deck's box.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference import constraints, system
from ..reference.model import Reference
from ..reference.neighbors import minimg

HUGE = 1e300


def last_frame(path: str, n: int) -> np.ndarray:
    """The (n, ncol) rows of the last frame of a lammpstrj file."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        tail = min(size, 400 * n + 4096)
        f.seek(size - tail)
        text = f.read().decode()
    head = text.rindex("ITEM: ATOMS")
    body = text[text.index("\n", head) + 1:]
    return np.asarray(body.split(), np.float64).reshape(n, -1)


def _start(ref: Reference, d: dict, dt):
    """The reference's atoms after set-up: the built positions and
    velocities, put on the constraints for a deck with fix shake."""
    x0, v0 = ref.tensor(d["x"]).to(dt), ref.tensor(d["v"]).to(dt)
    if ref.constraints is not None:
        i, j, r0 = ref.constraints
        x0, v0 = constraints.settle(x0, v0, i, j, r0.to(dt), ref.minv.to(dt),
                                    ref.Lt.to(dt))
    return x0, v0


def _numbers(ref: Reference, d, start, end, row, follow, frame, dt):
    """The compared numbers, the reference side in f64 and the program's
    side in ``start``/``end``/``row``/``follow``/``frame`` (host arrays),
    or, with ``dt`` lower than f64, the reference itself in dt (the
    control)."""
    control = dt != torch.float64
    L, n = ref.Lt, ref.n
    out = {}
    x0, v0 = _start(ref, d, torch.float64)
    if control:
        xs, vs = _start(ref, d, dt)
    else:
        xs, vs = ref.tensor(start["x"]), ref.tensor(start["v"])
    vrms = float(v0.pow(2).sum(1).mean().sqrt())
    out["start_x"] = float(minimg(xs.double() - x0, L).abs().max())
    out["start_v"] = _over(float((vs.double() - v0).abs().max()), vrms)
    ref = ref.in_box(end.get("box"))
    L = ref.Lt
    x, v = ref.tensor(end["x"]), ref.tensor(end["v"])
    r = ref.forces(x, peratom=frame is not None)
    if control:
        rc = ref.as_dtype(dt).forces(x.to(dt), peratom=frame is not None)
        fp = rc["f"].double()
        e_p = rc["epot"]
        vc = v.to(dt)
        t_p, _ = ref.as_dtype(dt).kinetic(vc, ref.dof)
        p_p = ref.as_dtype(dt).pressure(vc, rc["vir"])
    else:
        fp = ref.tensor(end["f"])
        e_p = row["epair"] + row["emol"]
        t_p, p_p = row["temp"], row["press"]
    df = (fp - r["f"]).norm(dim=1)
    out["force_max"] = _over(float(df.max()), float(
        r["f"].norm(dim=1).pow(2).mean().sqrt()))
    out["force_rms"] = _over(float(df.pow(2).mean().sqrt()),
                             ref.accuracy * ref.units["qqrd2e"])
    out["energy"] = abs(e_p - r["epot"]) / n
    t_ref, _ = ref.kinetic(v, ref.dof)
    out["temp"] = _over(abs(t_p - t_ref), t_ref)
    if ref.constraints is None:
        out["press"] = _over(abs(p_p - ref.pressure(v, r["vir"])),
                             ref.pressure(v, 0.0))
    if ref.nve:
        x1, v1, _ = ref.verlet_step(x, v, r["f"], ref.timestep)
        if control:
            rl = ref.as_dtype(dt)
            xf, vf, _ = rl.verlet_step(x.to(dt), v.to(dt), rc["f"],
                                       ref.timestep)
        else:
            xf, vf = ref.tensor(follow["x"]), ref.tensor(follow["v"])
        out["follow_x"] = float(minimg(xf.double() - x1, L).abs().max())
        out["follow_v"] = _over(float((vf.double() - v1).abs().max()), vrms)
    if frame is not None:
        pe_ref, st_ref = ref.peratom(r, v)
        if control:
            pe_p, st_p = ref.as_dtype(dt).peratom(rc, v.to(dt))
            pe_p, st_p = pe_p.double(), st_p.double()
        else:
            cols = ref.tensor(frame)
            pe_p, st_p = cols[:, 5], cols[:, 6:12]
        out["pe_atom"] = _over(float((pe_p - pe_ref).abs().max()),
                               float(pe_ref.pow(2).mean().sqrt()))
        out["stress_atom"] = _over(float((st_p - st_ref).abs().max()),
                                   float(st_ref.pow(2).mean().sqrt()))
    return out


def compare(deck: dict, seed: int, start, end, row, follow, frame,
            device) -> dict:
    d = system.build(deck, seed)
    ref = Reference(deck, d, device)
    with torch.no_grad():
        return _numbers(ref, d, start, end, row, follow, frame,
                        torch.float64)


def control(deck: dict, seed: int, end, device, dtype) -> dict:
    """The control: the reference computed in ``dtype`` in the program's
    place, on the program's end-of-window positions and velocities."""
    d = system.build(deck, seed)
    ref = Reference(deck, d, device)
    with torch.no_grad():
        return _numbers(ref, d, None, end, None, None,
                        True if deck.get("dump") else None, dtype)


def _over(a: float, b: float) -> float:
    """a / b, with a zero or non-finite scale read as the largest gap."""
    r = a / b if b > 0 else (0.0 if a == 0 else HUGE)
    return r if np.isfinite(r) else HUGE


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {value, limit}} for every number (a non-finite reading as
    HUGE, so that it fails and the result line stays JSON); a number
    without a limit gets limit 0 and fails."""
    lim = limits.get("limits", {})
    return {k: {"value": float(v) if np.isfinite(v) else HUGE,
                "limit": float(lim.get(k, 0.0))}
            for k, v in numbers.items()}
