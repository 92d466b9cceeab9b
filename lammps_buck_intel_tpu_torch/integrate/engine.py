"""What the port's three integrator engines share: the set-up around the
step, the run loop, the thermo row's arithmetic and its readback.

``CellPairSimulation`` (``cellpair_verlet.py``), ``Simulation``
(``verlet.py``) and ``NPTSimulation`` (``npt.py``) subclass ``Engine``.
Each keeps its own step (``_block``) and force (``_forces``), and supplies
around them only what differs:

- ``_thermo_device(state)``: the row's tensors on the device, 0-d
  scalars and 1-D vectors (``_thermo_row`` and what the engine adds),
  ``overflow`` among them;
- ``_overflow_error()``, and ``_flags`` / ``_check_row`` where an engine
  guards more than the overflow flag (NPT: the box shrink);
- ``_advance(total, cadence)`` where a block takes more than the ramp
  target (NPT: its ramps per block);
- ``_replayable``, ``_snapshot`` and ``_rollback``: the errors of a
  segment that the run rolls back and replays, and how (the cell engine's
  capacity overflow: back to the segment start, grow, replay);
- ``_log_row(row)`` for another log line.

``run`` emits a row at its start, at each multiple of ``thermo_every``
and at its end, and calls ``self.thermo()`` through the attribute, so
that a hook set on the instance sees every row and may end the run by
raising.  A run with thermo off reads the guarded flags once at its end:
a run never returns with dropped pairs.  ``atoms_on_device`` here is the
list engines' (the cell engine gathers its slots); ``get_atoms`` is its
host copy for all three.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.precision import single
from ..utils import trace
from . import shake as shk


@dataclasses.dataclass
class NeighborPolicy:
    """``neighbor <skin> bin`` + ``neigh_modify`` knobs."""

    skin: float
    every: int = 1
    delay: int = 0
    check: bool = True


class Engine:
    """The set-up every engine shares: units, precision and timestep, the
    half-step factors, the bonded terms, the SHAKE tables, the degrees of
    freedom 3N - 3 - Nc - ``constraints`` (the rigid bodies') and the
    thermostat filled with them; the device is that of ``system``."""

    # errors of a segment that the run rolls back (``_snapshot`` taken at
    # the segment's start, ``_rollback``) and replays
    _replayable: tuple = ()
    # the rows fall on multiples of thermo_every counted from the run's
    # first step (the NPT engine), not from step 0
    _rows_from_run_start = False

    def __init__(self, system, pair, units, precision, dt, neighbor, bonded,
                 shake, thermostat, constraints: int = 0):
        self.units = units
        self.precision = precision or single()
        self.dt = units.dt if dt is None else dt
        self.pair = pair
        self.bonded = bonded if (bonded is not None
                                 and bonded.has_terms) else None
        self.neighbor = neighbor or NeighborPolicy(skin=units.skin)
        self.device = system.x.device
        self.n_atoms = n = system.n_atoms
        self.dtf = float(0.5 * self.dt * units.ftm2v)
        self.dtv = float(self.dt)
        self.shake = shake
        # the tables, and the corrected bond vectors of the last SHAKE
        # solve (the thermo row's shake.unconverged reads them)
        self._shake_t = self._shake_rn = None
        if shake is not None:
            self._shake_t = shk.shake_tables(shake, self.device,
                                             self.precision.flt)
        self.dof = max(3 * n - 3 - (shake.n_constraints if shake else 0)
                       - constraints, 1)
        self.thermostat = None
        if thermostat is not None:
            self.thermostat = dataclasses.replace(
                thermostat, dof=self.dof, boltz=units.boltz,
                mvv2e=units.mvv2e, dt=self.dt)
        self._tchain = thermostat.tchain if thermostat is not None else 0
        self.step_count = 0
        self._run_total = self._run_done = 0
        self._t_now = 0.0       # thermostat target of the current segment
        self.timings = {"run": 0.0, "setup": 0.0}

    def _atom_order(self, system, topology) -> dict:
        """The list engines' atom-order tables: types, charges, atom ids,
        the f64 masses the snapshots carry, the special-bond partner
        table, and with SHAKE the identity slot-of-atom map.  Returns the
        state's (3, N) planes x, v, image and f, the overflow flag and
        the thermostat chain."""
        dev, n, flt = self.device, self.n_atoms, self.precision.flt
        self.typ = system.type.to(device=dev, dtype=torch.int32).contiguous()
        self.q = system.q.to(device=dev, dtype=flt).contiguous()
        self._aid = torch.arange(n, dtype=torch.int32, device=dev)
        self._mass64 = system.mass.to(dev, torch.float64)
        self._special = None
        if topology is not None and topology.has_special:
            self._special = tuple(
                torch.as_tensor(np.asarray(a, np.int32)).to(dev).contiguous()
                for a in (topology.special_idx, topology.special_code))
        self._inv = None
        if self.shake is not None:
            self._inv = torch.arange(n + 1, dtype=torch.int32, device=dev)

        def planes(a, dtype):
            return a.to(device=dev, dtype=dtype).t().contiguous()

        return dict(
            x=planes(system.x, flt), v=planes(system.v, flt),
            image=planes(system.image, torch.int32),
            f=torch.zeros((3, n), dtype=flt, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            therm=torch.zeros((2, self._tchain), dtype=flt, device=dev))

    # ---------- thermo ----------

    def _thermo_row(self, sum_mv2, vir, volume, evdwl, ecoul, elong, emol,
                    **more) -> dict:
        """The row's tensors every engine has: temp, ke and press from
        sum_mv2 (the sum of m v^2 in energy units), the (6,) virial vir
        and the volume; the energies with epair and etotal; then
        ``more``."""
        u = self.units
        ke = 0.5 * sum_mv2
        epair = evdwl + ecoul + elong
        vir_trace = vir[0] + vir[1] + vir[2]
        return dict(
            temp=sum_mv2 / (self.dof * u.boltz), evdwl=evdwl, ecoul=ecoul,
            elong=elong, emol=emol, epair=epair, ke=ke,
            etotal=epair + emol + ke,
            press=(sum_mv2 + vir_trace) / (3.0 * volume) * u.nktv2p, **more)

    def thermo(self) -> dict:
        trace.count("thermo_row")
        with trace.span("thermo"):
            row = self._thermo_device(self.state)
            if self.shake is not None:
                row["shake_unconverged"] = shk.unconverged(
                    self._shake_t, self._shake_rn, self.shake.tol)
            with trace.span("readback"):
                return self._readback(row)

    def _to_host(self, row: dict) -> dict:
        """The row on the host in one device -> host transfer: a float for
        each 0-d tensor, an array of its own length for each 1-D one."""
        scalars = [k for k, v in row.items() if v.dim() == 0]
        vectors = [k for k, v in row.items() if v.dim() == 1]
        host = trace.to_host(torch.cat(
            [torch.stack([row[k].to(torch.float64) for k in scalars])]
            + [row[k].to(torch.float64) for k in vectors])).numpy()
        out = {k: float(v) for k, v in zip(scalars, host)}
        off = len(scalars)
        for k in vectors:
            out[k] = host[off:off + row[k].shape[0]]
            off += row[k].shape[0]
        out["step"] = self.step_count
        out["overflow"] = bool(out["overflow"])
        return out

    def _readback(self, row: dict) -> dict:
        """The row on the host (``_to_host``), then the guards."""
        out = self._to_host(row)
        # overflow first: the pairs or atoms it dropped are what makes a
        # row non-finite, and the cell engine rolls them back
        self._check_row(out)
        if not all(np.isfinite(out[k]) for k in ("etotal", "temp", "press")):
            raise RuntimeError(
                f"non-finite thermodynamics at step {out['step']} "
                f"(etotal={out['etotal']}, temp={out['temp']}, "
                f"press={out['press']}): simulation diverged — reduce the "
                "timestep or check overlapping atoms / force-field "
                "coefficients")
        # a row the run keeps: the clusters of a segment a guard throws
        # away are not counted
        shk.count_unconverged(out)
        return out

    def _check_row(self, out: dict):
        if out["overflow"]:
            raise self._overflow_error()

    def _flags(self) -> dict:
        """The state's tensors that ``_check_row`` guards."""
        return dict(overflow=self.state.overflow)

    def _log_row(self, row: dict):
        if not getattr(self, "_printed_header", False):
            self._printed_header = True
            print(f"{'Step':>8} {'Temp':>12} {'E_pair':>14} "
                  f"{'E_long':>14} {'TotEng':>14} {'Press':>14}")
        print(f"{row['step']:>8d} {row['temp']:>12.6g} "
              f"{row['epair']:>14.8g} {row['elong']:>14.8g} "
              f"{row['etotal']:>14.8g} {row['press']:>14.6g}")

    # ---------- IO ----------

    def get_atoms(self) -> dict:
        """Atom-ordered snapshot on the host: x, v, f and image (N, 3),
        typ and q (N,)."""
        a = self.atoms_on_device()
        out = {k: a[k].t().contiguous().cpu().numpy()
               for k in ("x", "v", "f", "image")}
        return dict(out, typ=a["typ"].cpu().numpy(), q=a["q"].cpu().numpy())

    def atoms_on_device(self) -> dict:
        """Atom-order snapshot on the device, read by the per-atom computes
        and the dump writers: x, v, f (3, N) flt planes and image (3, N)
        int32 (copies: the run updates the state in place), typ (N,)
        int32, q (N,) flt, mass (N,) f64, special: the (N, S) int32
        (partner ids, codes) of the special bonds or None, mol: the (N,)
        int32 molecule ids of the same-molecule exclusion or None."""
        st = self.state
        out = {k: getattr(st, k).clone() for k in ("x", "v", "f", "image")}
        return dict(out, typ=self.typ, q=self.q,
                    mass=self._mass64[self.typ.long()],
                    special=self._special, mol=None)

    # ---------- planning ----------

    def _cadence(self, vmax: Optional[float]) -> int:
        """Block length, the JAX package's: ``every`` under check no;
        under check yes the bound 2 vmax dt steps <= skin with a 1.5x
        headroom on vmax (it is sampled at the previous thermo row), at
        most 100."""
        nb = self.neighbor
        if not nb.check or vmax is None or vmax <= 0:
            return max(1, nb.every)
        safe = int(nb.skin / (2.0 * 1.5 * vmax * self.dt))
        return max(1, min(max(safe, 1), 100))

    def _vmax_now(self) -> float:
        """Device max |v| (empty slots carry v = 0), sampled at run()
        entry when check=true and no thermo row will supply vmax."""
        return float(trace.to_host(
            torch.sqrt(self._kinetic(self.state)[:, 1].max())))

    def _t_target(self, ahead: int = 0) -> float:
        """Thermostat target: the ramp t_start -> t_stop over the run,
        evaluated at the end of the segment about to be advanced."""
        cfg = self.thermostat
        if cfg is None:
            return 0.0
        if self._run_total <= 0 or cfg.t_start == cfg.t_stop:
            return cfg.t_start
        frac = min(max((self._run_done + ahead) / self._run_total, 0.0), 1.0)
        return cfg.t_start + (cfg.t_stop - cfg.t_start) * frac

    def _advance(self, total: int, cadence: int):
        """Run ``total`` steps as n full blocks of ``cadence`` + one tail,
        all at the ramp target of the segment's end."""
        self._t_now = self._t_target(ahead=total)
        n_full, rem = divmod(total, cadence)
        for _ in range(n_full):
            self.state = self._block(self.state, cadence)
        if rem:
            self.state = self._block(self.state, rem)

    def _snapshot(self):
        return None

    # ---------- main loop ----------

    def run(self, nsteps: int, thermo_every: int = 0, log: bool = True):
        """Advance nsteps; returns the thermo rows."""
        rows = []
        vmax = None

        def emit():
            nonlocal vmax
            row = self.thermo()
            vmax = row.pop("vmax", None)
            rows.append(row)
            if log:
                self._log_row(row)

        t0 = time.perf_counter()
        with trace.span("run"):
            self._run_total, self._run_done = nsteps, 0
            origin = self.step_count if self._rows_from_run_start else 0
            if thermo_every:
                emit()
            elif self.neighbor.check:
                # no thermo row will supply vmax: sample it once, so the
                # displacement bound applies (else an 'every 1 check yes'
                # deck would rebuild every step)
                vmax = self._vmax_now()
            end = self.step_count + nsteps
            replays = 0
            while self.step_count < end:
                target = end
                if thermo_every:
                    target = min(end, origin + ((self.step_count - origin)
                                                // thermo_every + 1)
                                 * thermo_every)
                with trace.span("segment"):
                    snap = self._snapshot()
                    self._advance(target - self.step_count,
                                  self._cadence(vmax))
                    self._run_done += target - self.step_count
                    self.step_count = target
                try:
                    # a row at each multiple and at the end; with thermo
                    # off the one segment ends the run
                    if thermo_every:
                        emit()
                    else:
                        self._check_row(self._to_host(self._flags()))
                except self._replayable:
                    replays += 1
                    if replays > 4:
                        raise
                    self._rollback(snap)
            trace.synchronize(self.device)
        self.timings["run"] += time.perf_counter() - t0
        return rows
