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

The cadence, the blocks of a segment, the run loop and the readback are
``engine.Engine``'s: the JAX package's blocks, so the wraps and list
builds fall on the same steps.  A thermo row wraps a copy of the
positions, builds its own list and runs an eflag + vflag pass; its
overflow flag joins the row's, and with SHAKE the constraint virial on the
total force (``shake_virial``) joins the pressure.

Positions, velocities and forces are (3, N) atom-order planes, updated in
place; the box is held on the device as constant (3,) tensors that the
kernels read, as the NPT engine reads its variable one.  Degrees of
freedom 3N - 3 - Nc.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.box import wrap
from ..core.precision import Precision
from ..core.state import System, Topology
from ..core.units import LJ, Units
from ..models.bonded import compute_bonded
from ..models.pair import driver
from ..models.pair.styles import PairStyle
from ..neighbor import neighbor_list as nlm
from ..utils import trace
from . import nve
from . import shake as shk
from .engine import Engine, NeighborPolicy
from .nvt import NVTConfig, nhc_scale


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


class Simulation(Engine):
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
    ):
        if system.box.is_triclinic:
            raise NotImplementedError(
                "the neighbor-list engine on a triclinic box is not ported: "
                "ROADMAP queue 1 item 14")
        super().__init__(system, pair, units, precision, dt, neighbor,
                         bonded, shake, thermostat)
        self.kspace = kspace
        self.box = system.box
        dev, n, flt = self.device, self.n_atoms, self.precision.flt

        L = np.asarray(self.box.lengths, np.float64)
        # the box on the device once: the steps never copy from the host
        self._lo = torch.as_tensor(np.asarray(self.box.lo, np.float64)).to(
            dev, flt)
        self._boxL = torch.as_tensor(L).to(dev, flt)
        cutneigh = float(np.sqrt(pair.cutsq_max)) + self.neighbor.skin
        self.spec = nlm.make_spec(n, L, cutneigh)

        st = MDState(**self._atom_order(system, topology))
        # per-TYPE 1/mass, computed in f64 and rounded once to flt, and the
        # mass the kinetic sums use (the cell engine's tables)
        self._minv_t = (1.0 / system.mass.to(dev, torch.float64)).to(flt)
        self._mass_t = 1.0 / self._minv_t

        t0 = time.perf_counter()
        # one host round trip at set-up: size the capacities
        x0, _ = wrap(st.x, st.image, self._lo, self._boxL)
        _, self.spec = nlm.build_with_retry(x0, self._lo, self._boxL,
                                            self.spec, self._special)
        if shake is not None:
            self._shake_rn = shk.settle(
                self._shake_t, shake, tuple(st.x.unbind(0)),
                tuple(st.v.unbind(0)), self._inv, self._boxL)
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

    def _kinetic(self, st: MDState) -> torch.Tensor:
        return nve.kinetic(tuple(st.v.unbind(0)), self.typ, self._aid,
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

    def _block(self, st: MDState, nsteps: int) -> MDState:
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
            therm, t_target = st.therm, self._t_now
            for _ in range(nsteps):
                with trace.span("integrate"):
                    if cfg is not None:
                        therm = nhc_scale(cfg, therm, vs,
                                          self._kinetic(st), t_target)
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
                            partial = self._kinetic(st)
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
        virial = fr.virial
        if self.shake is not None:
            # the constraint virial on the TOTAL force (the fix_shake.cpp
            # pressure tally)
            virial = virial + shk.shake_virial(
                self._shake_t, tuple(x.unbind(0)), tuple(st.v.unbind(0)),
                fr.fa, fr.fb, self._inv, self._boxL, u.ftm2v,
                self.precision.acc)
        kin = self._kinetic(st)
        return self._thermo_row(
            kin[:, 0].sum() * u.mvv2e, virial, self.box.volume, fr.evdwl,
            fr.ecoul, fr.elong, fr.ebond + fr.eangle + fr.emol_extra,
            ebond=fr.ebond, eangle=fr.eangle,
            overflow=st.overflow | nl.overflow,
            vmax=torch.sqrt(kin[:, 1].max()), virial=virial)

    @staticmethod
    def _overflow_error() -> RuntimeError:
        return RuntimeError(
            "neighbor list overflow detected during run; reduce the "
            "rebuild interval (neigh_modify every / check yes)")

    def _t_target(self, ahead: int = 0) -> float:
        """The ramp target rounded through flt, as the JAX package passes
        it."""
        return float(torch.tensor(super()._t_target(ahead),
                                  dtype=self.precision.flt))
