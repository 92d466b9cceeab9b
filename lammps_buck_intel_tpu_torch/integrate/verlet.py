"""Neighbor-list run loop on a static box: the ``Simulation`` engine.

Counterpart of ``lammps_buck_intel_tpu.integrate.verlet`` (``MDState``,
``Forces``, ``NeighborPolicy``, ``Simulation`` without rigid bodies and
without compensated precision), the JAX package's default engine: the
deck runner builds it for ``engine: nlist`` (or no ``engine:`` key) and
when the cell engine finds the box too small.

A block of ``cadence`` steps wraps the positions into the box (image flags
counted), builds the neighbor list once (``neighbor_list.build``: the
binned build, or the dense build for N <= 512 or fewer than 3 cells per
axis) and runs the steps on it, in the order of the JAX ``one_step``:

  1. the thermostat half step (``nve.kinetic``, ``nvt.nhc_scale``);
  2. SHAKE's reference bond vectors (``shake_ref``), the first half kick
     and the drift (``nve.kick_drift``), SHAKE (``shake_positions``);
  3. forces on the block's list: the list pair pass (csrc/nlist.cu),
     ``PPPM.compute`` on the generic mesh of the box or ``Ewald.compute``
     (csrc/ewald.cu), the bonded terms with the CHARMM 1-4 energies
     tallied into evdwl and ecoul;
  4. the force sum and the second half kick (``nve.kick``), RATTLE
     (``rattle_velocities``), the thermostat half step.

The cadence is the JAX package's: ``every`` under ``check no``; under
``check yes`` the displacement bound int(skin / (3 vmax dt)), capped at 100,
with vmax taken at the previous thermo row.  A segment between thermo rows
runs as n full blocks of the cadence and one tail block, the JAX
package's blocks, so the wraps and list builds fall on the same steps.  A
thermo row wraps a copy of the positions, builds its own list and runs an
eflag + vflag pass; its overflow flag joins the row's, and with SHAKE the
constraint virial on the total force (``shake_virial``) joins the
pressure.  The sticky overflow flag raises at thermo rows and at the end
of a run.

Positions, velocities and forces are (3, N) atom-order planes, updated in
place; the box is held on the device as constant (3,) tensors that the
kernels read, as the NPT engine reads its variable one.  Degrees of
freedom 3N - 3 - Nc.  ``rigid=`` and ``exclude_intra=`` raise naming
ROADMAP queue 1 item 13(c) (rigid bodies run on the cell engine).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.box import wrap
from ..core.precision import Precision, single
from ..core.state import System, Topology
from ..core.units import LJ, Units
from ..models.bonded import compute_bonded
from ..models.pair import driver
from ..models.pair.styles import PairStyle
from ..neighbor import neighbor_list as nlm
from ..utils import trace
from . import nve
from . import shake as shk
from .nvt import NVTConfig, nhc_scale


@dataclasses.dataclass
class NeighborPolicy:
    """``neighbor <skin> bin`` + ``neigh_modify`` knobs."""

    skin: float
    every: int = 1
    delay: int = 0
    check: bool = True


class MDState(NamedTuple):
    x: torch.Tensor          # (3, N) flt positions (wrapped at block starts)
    v: torch.Tensor          # (3, N) flt
    image: torch.Tensor      # (3, N) int32
    f: torch.Tensor          # (3, N) flt force of the last evaluation
    overflow: torch.Tensor   # () bool, any neighbor overflow so far
    therm: torch.Tensor      # (2, M) Nose-Hoover chain ((2, 0) under NVE)


class Forces(NamedTuple):
    """One force evaluation.  The JAX package's ``f`` is kept as two sets
    of acc planes, which the second half kick sums: ``fa`` the pair and
    bonded forces, ``fb`` the k-space forces (None without k-space)."""

    fa: tuple
    fb: Optional[tuple]
    evdwl: torch.Tensor
    ecoul: torch.Tensor
    elong: torch.Tensor
    ebond: torch.Tensor
    eangle: torch.Tensor
    virial: torch.Tensor
    emol_extra: torch.Tensor   # dihedral + improper energies


# engine features of the JAX package not ported yet -> ROADMAP queue 1
_UNPORTED = {
    "rigid": "item 13(c) (rigid bodies on the list engine; the cell "
             "engine runs them)",
    "exclude_intra": "item 13(c) (molecule exclusion on the list engine; "
                     "the cell engine runs it)",
}


class Simulation:
    """Single-device MD on a neighbor list: pair (+ k-space, + bonded)
    forces and velocity Verlet; the device is that of ``system``.

    kspace: None or a static-box solver with ``compute(x, q, eflag,
    vflag)`` (``models.kspace.PPPM``, ``models.kspace.Ewald``, a
    ``BoundKSpace`` of the dispersion PPPM or a ``CombinedKSpace`` of
    both PPPMs); topology: the special-bond partner
    table; bonded: the bonded terms; thermostat: Nose-Hoover chain NVT
    (dof 3N - 3 - Nc, filled here with the units and the timestep); shake:
    SHAKE/RATTLE constraints.  The list's capacity and build come from
    ``neighbor_list.make_spec``."""

    def __init__(
        self,
        system: System,
        pair: PairStyle,
        topology: Optional[Topology] = None,
        kspace=None,
        bonded=None,
        units: Units = LJ,
        precision: Optional[Precision] = None,
        dt: Optional[float] = None,
        neighbor: Optional[NeighborPolicy] = None,
        thermostat: Optional[NVTConfig] = None,
        shake: Optional[shk.ShakeConstraints] = None,
        **unported,
    ):
        for key, value in unported.items():
            if key not in _UNPORTED:
                raise TypeError(f"unexpected argument {key!r}")
            if value:
                raise NotImplementedError(
                    f"Simulation {key}: ROADMAP queue 1 {_UNPORTED[key]}")
        if system.box.is_triclinic:
            raise NotImplementedError(
                "the neighbor-list engine on a triclinic box is not ported: "
                "ROADMAP queue 1 item 14")
        self.units = units
        self.precision = precision or single()
        self.dt = units.dt if dt is None else dt
        self.pair = pair
        self.kspace = kspace
        self.bonded = bonded if (bonded is not None
                                 and bonded.has_terms) else None
        self.topology = topology
        self.neighbor = neighbor or NeighborPolicy(skin=units.skin)
        self.box = system.box
        self.device = dev = system.x.device
        n = system.n_atoms
        self.n_atoms = n
        flt, acc = self.precision.flt, self.precision.acc

        L = np.asarray(self.box.lengths, np.float64)
        # the box on the device once: the steps never copy from the host
        self._lo = torch.as_tensor(np.asarray(self.box.lo, np.float64)).to(
            dev, flt)
        self._boxL = torch.as_tensor(L).to(dev, flt)
        cutneigh = float(np.sqrt(pair.cutsq_max)) + self.neighbor.skin
        self.spec = nlm.make_spec(n, L, cutneigh)

        self.typ = system.type.to(device=dev, dtype=torch.int32).contiguous()
        self.q = system.q.to(device=dev, dtype=flt).contiguous()
        self._aid = torch.arange(n, dtype=torch.int32, device=dev)
        self._special = None
        if topology is not None and topology.has_special:
            self._special = (
                torch.as_tensor(np.asarray(topology.special_idx, np.int32)
                                ).to(dev).contiguous(),
                torch.as_tensor(np.asarray(topology.special_code, np.int32)
                                ).to(dev).contiguous())
        # per-TYPE 1/mass, computed in f64 and rounded once to flt, and the
        # mass the kinetic sums use (the cell engine's tables)
        self._minv_t = (1.0 / system.mass.to(dev, torch.float64)).to(flt)
        self._mass_t = 1.0 / self._minv_t
        self._mass64 = system.mass.to(dev, torch.float64)
        self.dtf = float(0.5 * self.dt * units.ftm2v)
        self.dtv = float(self.dt)

        self.shake = shake
        # the tables, and the corrected bond vectors of the last SHAKE
        # solve (the thermo row's shake.unconverged reads them)
        self._shake_t = self._shake_rn = None
        self._inv = None
        if shake is not None:
            cl = shk.make_clusters(shake)
            if cl.width > shk.MAX_C:
                raise NotImplementedError(
                    f"fix shake: a cluster of {cl.width} constraints; the "
                    f"constraint kernels (K13) take at most {shk.MAX_C}")
            self._shake_t = cl.tables_on(dev, flt)
            self._inv = torch.arange(n + 1, dtype=torch.int32, device=dev)
        self.dof = max(3 * n - 3 - (shake.n_constraints if shake else 0), 1)
        self.thermostat = None
        tchain = 0
        if thermostat is not None:
            self.thermostat = dataclasses.replace(
                thermostat, dof=self.dof, boltz=units.boltz,
                mvv2e=units.mvv2e, dt=self.dt)
            tchain = thermostat.tchain

        def planes(a, dtype):
            return a.to(device=dev, dtype=dtype).t().contiguous()

        st = MDState(
            x=planes(system.x, flt), v=planes(system.v, flt),
            image=planes(system.image, torch.int32),
            f=torch.zeros((3, n), dtype=flt, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            therm=torch.zeros((2, tchain), dtype=flt, device=dev))
        self.step_count = 0
        self._run_total = self._run_done = 0
        self.timings = {"run": 0.0, "setup": 0.0}

        t0 = time.perf_counter()
        # one host round trip at set-up: size the capacities
        x0, _ = wrap(st.x, st.image, self._lo, self._boxL)
        _, self.spec = nlm.build_with_retry(x0, self._lo, self._boxL,
                                            self.spec, self._special)
        if shake is not None:
            # settle onto the constraints (x_old = x_new, dt = 1; the
            # velocities stay), then project the velocities
            t, inv = self._shake_t, self._inv
            xs, vs = tuple(st.x.unbind(0)), tuple(st.v.unbind(0))
            ro = shk.shake_ref(t, xs, inv, self._boxL)
            self._shake_rn = shk.shake_positions(t, ro, xs, None, inv,
                                                 self._boxL, 1.0, shake.iters)
            shk.rattle_velocities(t, vs, inv, self._boxL, xs=xs)
        self.state = self._init_force(st)
        self.timings["setup"] += time.perf_counter() - t0

    # ---------- force evaluation ----------

    def _build(self, x):
        return nlm.build(x, self._lo, self._boxL, self.spec, self._special)

    def _forces(self, x, nlist, eflag: bool, vflag: bool) -> Forces:
        acc = self.precision.acc
        with trace.span("pair"):
            pr = driver.compute_pair(
                self.pair, x, self.typ, self.q, self._boxL, nlist,
                eflag=eflag, acc_dtype=acc,
                use_special=self._special is not None)
        fa, virial = (pr.fx, pr.fy, pr.fz), pr.virial
        zero = torch.zeros((), dtype=acc, device=self.device)
        evdwl, ecoul = pr.evdwl, pr.ecoul
        elong = ebond = eangle = emol_extra = zero
        fb = None
        if self.kspace is not None:
            with trace.span("kspace"):
                kr = self.kspace.compute(x, self.q, eflag=eflag, vflag=vflag)
            fb, elong = kr.f, kr.elong
            virial = virial + kr.virial
        if self.bonded is not None:
            with trace.span("bonded"):
                br = compute_bonded(self.bonded, tuple(x.unbind(0)),
                                    self._boxL, eflag=eflag, acc_dtype=acc,
                                    out=fa)
            ebond, eangle = br.ebond, br.eangle
            emol_extra = br.edihed + br.eimp
            # CHARMM 1-4 terms tally into the pair energies
            evdwl = evdwl + br.e14_lj
            ecoul = ecoul + br.e14_coul
            virial = virial + br.virial
        return Forces(fa=fa, fb=fb, evdwl=evdwl, ecoul=ecoul, elong=elong,
                      ebond=ebond, eangle=eangle, virial=virial,
                      emol_extra=emol_extra)

    def _kick(self, st: MDState, fr: Forces, dtf: float, ke: bool):
        """f = (flt)(fa + fb) into st.f, then v += dtf / m f; with ke the
        kinetic partials of the kicked velocities."""
        return nve.kick(tuple(st.v.unbind(0)), tuple(st.f.unbind(0)), fr.fa,
                        fr.fb, self.typ, self._aid, self._minv_t,
                        self._mass_t, self.n_atoms, dtf, self.precision.acc,
                        ke)

    def _kinetic(self, v) -> torch.Tensor:
        return nve.kinetic(tuple(v.unbind(0)), self.typ, self._aid,
                           self._mass_t, self.n_atoms, self.precision.acc)

    def _wrap_build(self, st: MDState):
        """Wrap into the box, build the list: (state, list)."""
        x, image = wrap(st.x, st.image, self._lo, self._boxL)
        nl = self._build(x)
        return st._replace(x=x, image=image,
                           overflow=st.overflow | nl.overflow), nl

    def _init_force(self, st: MDState) -> MDState:
        st, nl = self._wrap_build(st)
        fr = self._forces(st.x, nl, eflag=False, vflag=False)
        self._kick(st, fr, 0.0, False)   # the force sum and cast alone
        return st

    # ---------- stepping ----------

    def _block(self, st: MDState, nsteps: int, t_target: float) -> MDState:
        """Wrap, rebuild, then nsteps velocity-Verlet steps on the list."""
        trace.count("step", nsteps)
        with trace.span("block"):
            trace.count("neighbor_build")
            with trace.span("neighbor"):
                st, nl = self._wrap_build(st)
            xs, vs = tuple(st.x.unbind(0)), tuple(st.v.unbind(0))
            fs = tuple(st.f.unbind(0))
            cfg, sc, t = self.thermostat, self.shake, self._shake_t
            inv, L = self._inv, self._boxL
            therm = st.therm
            for _ in range(nsteps):
                with trace.span("integrate"):
                    if cfg is not None:
                        therm = nhc_scale(cfg, therm, vs,
                                          self._kinetic(st.v), t_target)
                    if sc is not None:
                        ro = shk.shake_ref(t, xs, inv, L)
                    nve.kick_drift(xs, vs, fs, self.typ, self._aid,
                                   self._minv_t, self.n_atoms, self.dtf,
                                   self.dtv)
                    if sc is not None:
                        rn = shk.shake_positions(t, ro, xs, vs, inv, L,
                                                 self.dtv, sc.iters)
                fr = self._forces(st.x, nl, eflag=False, vflag=False)
                with trace.span("integrate"):
                    partial = self._kick(st, fr, self.dtf,
                                         cfg is not None and sc is None)
                    if sc is not None:
                        shk.rattle_velocities(t, vs, inv, L, r=rn)
                        if cfg is not None:
                            # the chain sees the projected velocities
                            partial = self._kinetic(st.v)
                    if cfg is not None:
                        therm = nhc_scale(cfg, therm, vs, partial, t_target)
            if sc is not None and nsteps:
                self._shake_rn = rn
            return st._replace(therm=therm)

    # ---------- thermo ----------

    def _thermo_device(self, st: MDState) -> dict:
        trace.count("neighbor_build")
        with trace.span("neighbor"):
            x, _ = wrap(st.x, st.image, self._lo, self._boxL)
            nl = self._build(x)
        fr = self._forces(x, nl, eflag=True, vflag=True)
        u = self.units
        kin = self._kinetic(st.v)
        sum_mv2 = kin[:, 0].sum() * u.mvv2e
        temp = sum_mv2 / (self.dof * u.boltz)
        ke = 0.5 * sum_mv2
        virial = fr.virial
        if self.shake is not None:
            # the constraint virial on the TOTAL force (the fix_shake.cpp
            # pressure tally)
            virial = virial + shk.shake_virial(
                self._shake_t, tuple(x.unbind(0)), tuple(st.v.unbind(0)),
                fr.fa, fr.fb, self._inv, self._boxL, u.ftm2v,
                self.precision.acc)
        vir_trace = virial[0] + virial[1] + virial[2]
        press = (sum_mv2 + vir_trace) / (3.0 * self.box.volume) * u.nktv2p
        epair = fr.evdwl + fr.ecoul + fr.elong
        emol = fr.ebond + fr.eangle + fr.emol_extra
        row = dict(
            temp=temp, evdwl=fr.evdwl, ecoul=fr.ecoul, elong=fr.elong,
            ebond=fr.ebond, eangle=fr.eangle, emol=emol, epair=epair, ke=ke,
            etotal=epair + emol + ke, press=press,
            overflow=st.overflow | nl.overflow,
            vmax=torch.sqrt(kin[:, 1].max()), virial=virial)
        if self.shake is not None:
            row["shake_unconverged"] = shk.unconverged(
                self._shake_t, self._shake_rn, self.shake.tol)
        return row

    @staticmethod
    def _overflow_error() -> RuntimeError:
        return RuntimeError(
            "neighbor list overflow detected during run; reduce the "
            "rebuild interval (neigh_modify every / check yes)")

    def thermo(self) -> dict:
        """One device -> host transfer for the whole row."""
        trace.count("thermo_row")
        with trace.span("thermo"):
            row = self._thermo_device(self.state)
            with trace.span("readback"):
                return self._readback(row)

    def _readback(self, row: dict) -> dict:
        virial = row.pop("virial")
        keys = list(row)
        host = trace.to_host(torch.cat([
            torch.stack([row[k].to(torch.float64) for k in keys]),
            virial.to(torch.float64)])).numpy()
        out = {k: float(v) for k, v in zip(keys, host[:len(keys)])}
        out["virial"] = host[len(keys):]
        out["step"] = self.step_count
        out["overflow"] = bool(out["overflow"])
        if not np.isfinite(out["etotal"]) or not np.isfinite(out["temp"]):
            raise RuntimeError(
                f"non-finite thermodynamics at step {out['step']} "
                f"(etotal={out['etotal']}, temp={out['temp']}): "
                "simulation diverged — reduce the timestep or check "
                "overlapping atoms / force-field coefficients")
        if out["overflow"]:
            raise self._overflow_error()
        # a row the run keeps: none that a guard above throws away
        shk.count_unconverged(out)
        return out

    # ---------- IO ----------

    def get_atoms(self) -> dict:
        """Atom-ordered snapshot (host numpy copies: the run updates the
        state in place)."""
        st = self.state
        out = {k: np.array(getattr(st, k).t().cpu().numpy())
               for k in ("x", "v", "f", "image")}
        out["typ"] = np.array(self.typ.cpu().numpy())
        out["q"] = np.array(self.q.cpu().numpy())
        return out

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
        """Block length: ``every`` under check no; under check yes the
        bound 2 vmax dt steps <= skin with a 1.5x headroom on vmax (it is
        sampled at the previous thermo row), at most 100."""
        nb = self.neighbor
        if not nb.check or vmax is None or vmax <= 0:
            return max(1, nb.every)
        safe = int(nb.skin / (2.0 * 1.5 * vmax * self.dt))
        return max(1, min(max(safe, 1), 100))

    def _t_target(self, ahead: int = 0) -> float:
        """Thermostat target: the ramp t_start -> t_stop over the run at
        the end of the segment about to be advanced, rounded through flt
        as the JAX package passes it."""
        cfg = self.thermostat
        if cfg is None:
            return 0.0
        if self._run_total <= 0 or cfg.t_start == cfg.t_stop:
            tt = cfg.t_start
        else:
            frac = min(max((self._run_done + ahead) / self._run_total, 0.0),
                       1.0)
            tt = cfg.t_start + (cfg.t_stop - cfg.t_start) * frac
        return float(torch.tensor(tt, dtype=self.precision.flt))

    def _advance(self, total: int, cadence: int):
        """Run ``total`` steps as n full blocks of ``cadence`` + one tail."""
        tt = self._t_target(ahead=total)
        n_full, rem = divmod(total, cadence)
        for _ in range(n_full):
            self.state = self._block(self.state, cadence, tt)
        if rem:
            self.state = self._block(self.state, rem, tt)

    def _vmax_now(self) -> float:
        return float(trace.to_host(
            torch.sqrt(self._kinetic(self.state.v)[:, 1].max())))

    # ---------- main loop ----------

    def run(self, nsteps: int, thermo_every: int = 0, log: bool = True):
        """Advance nsteps; returns the thermo rows."""
        rows = []
        vmax = None

        def emit():
            nonlocal vmax
            row = self.thermo()
            vmax = row.pop("vmax")
            rows.append(row)
            if log:
                if not getattr(self, "_printed_header", False):
                    self._printed_header = True
                    print(f"{'Step':>8} {'Temp':>12} {'E_pair':>14} "
                          f"{'E_long':>14} {'TotEng':>14} {'Press':>14}")
                print(f"{row['step']:>8d} {row['temp']:>12.6g} "
                      f"{row['epair']:>14.8g} {row['elong']:>14.8g} "
                      f"{row['etotal']:>14.8g} {row['press']:>14.6g}")

        t0 = time.perf_counter()
        with trace.span("run"):
            self._run_total, self._run_done = nsteps, 0
            if thermo_every:
                emit()
            elif self.neighbor.check:
                # no thermo row will supply vmax: sample it once, so the
                # displacement bound applies (else an 'every 1 check yes'
                # deck would rebuild every step)
                vmax = self._vmax_now()
            end = self.step_count + nsteps
            while self.step_count < end:
                target = end
                if thermo_every:
                    target = min(end, ((self.step_count // thermo_every)
                                       + 1) * thermo_every)
                with trace.span("segment"):
                    self._advance(target - self.step_count,
                                  self._cadence(vmax))
                    self._run_done += target - self.step_count
                    self.step_count = target
                if thermo_every and self.step_count % thermo_every == 0:
                    emit()
            if thermo_every and (not rows
                                 or rows[-1]["step"] != self.step_count):
                emit()
            elif bool(trace.to_host(self.state.overflow)):
                # a run never returns with dropped pairs, thermo or not
                raise self._overflow_error()
            trace.synchronize(self.device)
        self.timings["run"] += time.perf_counter() - t0
        return rows
