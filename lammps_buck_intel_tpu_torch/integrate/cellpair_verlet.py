"""Cell-pair engine runner: NVE, NVT and rigid bodies over the sorted
slot layout.

Counterpart of ``lammps_buck_intel_tpu.integrate.cellpair_verlet``
(``CellPairSimulation``).
Each block rebins once, then runs velocity-Verlet steps whose force is
the cell-pair kernel plus, with a ``kspace`` (``models.kspace.CellPPPM``),
the PPPM force plus, with ``bonded``, the bonded kernels' forces; a
``thermostat`` brackets each step with two Nose-Hoover chain half steps.
The updates themselves are the integrator kernels (``nve.kick_drift``,
``nve.kick``, ``nve.kinetic``, ``nvt.nhc_scale``): two launches a step
under NVE, five under NVT.

SHAKE/RATTLE (``shake``, ``integrate.shake``).  The drift updates the
positions in place, so each step first stores the reference bond vectors
(``shake_ref``); after the drift ``shake_positions`` puts the positions
back on the constraints and corrects v, and after the second kick
``rattle_velocities`` projects v with SHAKE's corrected bond vectors.
Under NVT the second chain half step must see the projected velocities:
the kick then returns no kinetic partials, and a ``kinetic`` pass after
RATTLE feeds the chain (five integrator and constraint launches a step
under NVE, nine under NVT).  At set-up the positions are settled onto the
constraints and the velocities projected before the first force.  Thermo
counts 3N - 3 - Nc degrees of freedom and adds the constraint virial on
the total force.
PyTorch runs eagerly: a block is a Python loop of launches on one stream,
and the host waits for the device only at thermo rows, at a run's end and
where the check cadence needs vmax.

Molecular decks.  ``topology`` gives the 1-2/1-3/1-4 partner table, kept
on the device in atom order: the pair kernel reads a slot's row through
its atom id, so no rebin has to gather it.  The bonded term tables and
the constraint clusters hold atom indices too; after each rebin one
scatter rebuilds the slot-of-atom map (``_inv_map``) that the bonded and
constraint kernels look their atoms up in.

Rigid bodies (``rigid``, fix rigid/small: ``integrate.rigid``).  Every
pair of one molecule is excluded (the slot mol plane, gathered once a
rebin; ``exclude_intra`` alone does the same without bodies).  At set-up
the bodies are built from the atoms, the velocities projected onto rigid
motion and the atoms placed from the bodies.  A block rebins once, then
sets the per-slot wrap offsets off = x - (X + d) (the kernel K15b's
offsets form), so that the positions the bodies give stay continuous with
the binned planes; each step is the initial update (the half kick of V
and L, the drift of X, the Richardson rotation, the slot positions; K15b),
the forces, the body force and torque (K15a, which also stores the
atoms' flt forces in the slot planes) and the final half kick (K15b; on
the block's last step it writes the slot velocities).  The force and
torque of the step's end start the next step.  Thermo counts 3N - 3 - Nc
degrees of freedom and adds the rigid constraint virial (K15a, K15c) on
the total force.  Rigid with SHAKE raises (as in the JAX package), rigid
under fix nvt is ROADMAP queue 1 item 13(c).

The state is updated in place (the CUDA rebin and the NVE updates write
into the slot planes), so the overflow rollback keeps a CLONE of the
segment-start state (and of the body state), and thermo rebins a clone:
neither may alias planes the run goes on to modify.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.precision import Precision
from ..core.state import System, Topology
from ..core.units import LJ, Units
from ..models.bonded import BondedStyle, compute_bonded
from ..models.pair.cellpair import (compute_cellpair, make_special_table,
                                    slot_mol_gather)
from ..models.pair.styles import PairStyle
from ..neighbor import cell_slots as cs
from ..utils import trace
from . import nve
from . import rigid as rgd
from . import shake as shk
from .engine import Engine, NeighborPolicy
from .nvt import NVTConfig, nhc_scale


class CellOverflowError(RuntimeError):
    """A rebin dropped atoms: per-cell occupancy exceeded the capacity.

    ``run`` catches this at segment boundaries, rolls the state back to
    the segment start, grows the capacity, rebins and replays."""


class CellPairSimulation(Engine):
    """MD runner on the slot layout; the device is that of ``system``.

    kspace: None, or a function of this engine's cell grid that returns
    the k-space solver (a ``CellPPPM`` or ``CellPPPMDisp``, whose
    ``compute_slots`` reads the slot planes, a ``BoundKSpace`` or
    ``CombinedKSpace``, whose ``compute_slot`` gathers atom-order inputs
    through the slots' atom ids and hands the slot charges to a Coulomb
    PPPM, or a ``PPPM`` or ``Ewald``, whose ``compute`` takes the slot
    positions and charges): the deck runner aligns the mesh to the grid,
    which is chosen here, or returns a solver on the generic mesh of the
    box.  The initial force includes
    the solver's.  topology: the special-bond partner table for the pair
    kernel; bonded: the bonded terms; shake: the SHAKE/RATTLE constraints
    (``integrate.shake.ShakeConstraints``); thermostat: Nose-Hoover chain
    NVT (dof 3N - 3 - Nc, filled here with the units and the timestep);
    rigid: the bodies of fix rigid/small (``integrate.rigid.RigidBodies``);
    exclude_intra: skip every pair of one molecule (implied by rigid)."""

    def __init__(
        self,
        system: System,
        pair: PairStyle,
        units: Units = LJ,
        precision: Optional[Precision] = None,
        dt: Optional[float] = None,
        neighbor: Optional[NeighborPolicy] = None,
        cap: Optional[int] = None,
        kspace=None,
        topology: Optional[Topology] = None,
        bonded: Optional[BondedStyle] = None,
        thermostat: Optional[NVTConfig] = None,
        shake: Optional[shk.ShakeConstraints] = None,
        rigid: Optional[rgd.RigidBodies] = None,
        exclude_intra: bool = False,
    ):
        if rigid is not None and shake is not None:
            raise ValueError("fix rigid/small and fix shake are exclusive")
        if rigid is not None and thermostat is not None:
            raise NotImplementedError(
                "fix rigid/small under fix nvt (the chain on the bodies' "
                "velocities) is not ported: ROADMAP queue 1 item 13(c)")
        super().__init__(system, pair, units, precision, dt, neighbor,
                         bonded, shake, thermostat,
                         constraints=rigid.n_constraints if rigid else 0)
        self.kspace = None
        self.box = system.box
        n = self.n_atoms
        flt = self.precision.flt
        x_np = system.x.cpu().numpy()

        cutneigh = float(np.sqrt(pair.cutsq_max)) + self.neighbor.skin
        L = np.asarray(self.box.perp_widths)
        grid = cs.make_grid(n, L, cutneigh, cap=cap)
        if grid is None:
            raise ValueError(
                "box too small for the cell-pair engine (needs >=3 cells "
                "per axis); the deck runner falls back to the neighbor-list "
                "engine (Simulation)")
        if cap is None:
            # capacity from the OBSERVED max occupancy (+8%), and reach_z
            # by the padded-work model ncell * cap * (K * cap) of the
            # half-stencil kernel, K = 9 * reach + 5.  The JAX package
            # rounds K * cap up to 128 TPU lanes; the port does not.
            best = None
            for reach in (1, 2, 3):
                g = cs.make_grid(n, L, cutneigh, reach_z=reach)
                if g is None:
                    continue
                occ = self._occupancy(x_np, g)
                capr = max(8, ((max(int(occ * 1.08), occ + 4) + 7) // 8) * 8)
                work = g.ncell * capr * (9 * reach + 5) * capr
                if best is None or work < best[0]:
                    best = (work, reach, capr)
            _, reach, capr = best
            grid = cs.make_grid(n, L, cutneigh, cap=capr, reach_z=reach)
        self.grid = grid

        # per-TYPE 1/mass, computed in f64 and rounded once to flt, as the
        # JAX package bakes it, and the mass the kinetic sums use
        self._minv_t = (1.0 / system.mass.to(torch.float64)).to(flt)
        self._mass_t = 1.0 / self._minv_t

        self.special = None
        if topology is not None and topology.has_special:
            self.special = make_special_table(
                topology.special_idx, topology.special_code, self.device)
        # same-molecule exclusion: the padded atom-order molecule table,
        # gathered into a slot plane after each rebin
        self.rigid = rigid
        self._excl_mol = None
        if exclude_intra or rigid is not None:
            self._excl_mol = torch.cat([
                system.molecule.to(self.device, torch.int32),
                torch.full((1,), -1, dtype=torch.int32, device=self.device)])

        t0 = time.perf_counter()

        st = self._bin(system)
        if bool(st.overflow):   # one host round trip at set-up
            self.grid = cs.grow(self.grid,
                                observed_max=self._occupancy(x_np, self.grid))
            st = self._bin(system)
            if bool(st.overflow):
                raise RuntimeError("cell capacity sizing failed")
        self.body = self._d = self._rt = self._off = None
        if rigid is not None:
            st = self._rigid_init(system, rigid)
        if kspace is not None:
            self.kspace = kspace(self.grid)
        if shake is not None:
            self._shake_rn = shk.settle(
                self._shake_t, shake, (st.x, st.y, st.z),
                (st.vx, st.vy, st.vz), self._inv_map(st), self.box.lengths)
        self.state = self._init_force(st)
        self.grows = 0
        self.timings["setup"] += time.perf_counter() - t0

    def _bin(self, system: System) -> cs.SlotState:
        return cs.from_atoms(self.grid, self.box, system.x, system.v,
                             system.image, system.type, system.q,
                             dtype=self.precision.flt, tchain=self._tchain)

    def _rigid_init(self, system: System, rigid: rgd.RigidBodies):
        """The bodies' initial state from the atoms (on the host, in flt,
        the JAX package's set-up), the atoms placed from the bodies and
        their velocities projected onto rigid motion, binned anew."""
        flt = self.precision.flt
        bs = rgd.init_body_state(rigid, system.v.cpu().numpy(), dtype=flt)
        xa, d = rgd.atom_positions(rigid, bs)
        va = rgd.atom_velocities(rigid, bs, d)
        dev = self.device
        self.body = rgd.BodyState(*(t.to(dev).contiguous() for t in bs))
        self._d = d.to(dev).contiguous()
        self._rt = rigid.tables_on(dev, flt)
        return cs.from_atoms(self.grid, self.box, xa.to(dev), va.to(dev),
                             system.image, system.type, system.q,
                             dtype=flt, tchain=self._tchain)

    def _occupancy(self, x: np.ndarray, grid: cs.CellGrid) -> int:
        lo = np.asarray(self.box.lo)
        nc = np.asarray(grid.nc)
        s = (x - lo) / np.asarray(self.box.lengths)
        s = s - np.floor(s)   # wrap before binning, as the rebin does
        ci = np.clip((s * nc).astype(int), 0, nc - 1)
        cid = (ci[:, 0] * nc[1] + ci[:, 1]) * nc[2] + ci[:, 2]
        return int(np.bincount(cid, minlength=grid.ncell).max())

    # ---------- force + integrate ----------

    def _slot_mol(self, state: cs.SlotState):
        """The slot plane of molecule ids after a rebin (None without
        exclusion)."""
        if self._excl_mol is None:
            return None
        return slot_mol_gather(self._excl_mol, state.aid, self.n_atoms)

    def _forces(self, state: cs.SlotState, eflag: bool, vflag: bool,
                mol=None):
        """(pair force planes, k-space force planes or None, evdwl, ecoul,
        elong, virial); the planes are acc-typed and stay apart: the second
        kick sums them.  mol: the slot plane of ``_slot_mol``."""
        with trace.span("pair"):
            r = compute_cellpair(self.pair, self.grid, self.box, state,
                                 eflag=eflag, vflag=vflag,
                                 acc_dtype=self.precision.acc,
                                 special=self.special, slot_mol=mol)
        fk, virial = None, r.virial
        elong = torch.zeros((), dtype=self.precision.acc, device=self.device)
        if self.kspace is not None:
            with trace.span("kspace"):
                if hasattr(self.kspace, "compute_slots"):
                    *fk, elong, kvir = self.kspace.compute_slots(state, eflag,
                                                                 vflag)
                else:
                    xs = torch.stack([state.x, state.y, state.z])
                    if hasattr(self.kspace, "compute_slot"):
                        # a solver baked on atom-order inputs
                        # (``BoundKSpace``): the slot positions, the atom
                        # ids clamped to N
                        kr = self.kspace.compute_slot(
                            xs, torch.clamp(state.aid, max=self.n_atoms),
                            state.q, eflag=eflag, vflag=vflag)
                    else:
                        # a charge solver (the generic PPPM of a slab deck,
                        # an Ewald sum) on the slot positions and charges:
                        # empty slots carry q = 0 and add nothing (the JAX
                        # cellpair_verlet.py:383-391)
                        kr = self.kspace.compute(xs, state.q, eflag=eflag,
                                                 vflag=vflag)
                    fk, elong, kvir = list(kr.f), kr.elong, kr.virial
            if vflag:
                virial = virial + kvir
        return (r.fx, r.fy, r.fz), fk, r.evdwl, r.ecoul, elong, virial

    def _inv_map(self, state: cs.SlotState) -> torch.Tensor:
        """(N + 1,) int32 slot of each atom, rebuilt after a rebin; row N
        collects the empty slots."""
        ns = self.grid.nslots
        inv = torch.zeros(self.n_atoms + 1, dtype=torch.int32,
                          device=self.device)
        inv[state.aid.long()] = torch.arange(ns, dtype=torch.int32,
                                             device=self.device)
        return inv

    def _bonded_forces(self, state: cs.SlotState, inv, fs, eflag: bool):
        """Bonded forces added to the acc planes ``fs`` in place."""
        with trace.span("bonded"):
            return compute_bonded(self.bonded, (state.x, state.y, state.z),
                                  self.box, eflag=eflag,
                                  acc_dtype=self.precision.acc, inv=inv,
                                  out=fs)

    def _kick(self, state: cs.SlotState, fa, fb, dtf: float, ke: bool):
        return nve.kick((state.vx, state.vy, state.vz),
                        (state.fx, state.fy, state.fz), fa, fb, state.typ,
                        state.aid, self._minv_t, self._mass_t, self.n_atoms,
                        dtf, self.precision.acc, ke)

    def _kinetic(self, state: cs.SlotState) -> torch.Tensor:
        return nve.kinetic((state.vx, state.vy, state.vz), state.typ,
                           state.aid, self._mass_t, self.n_atoms,
                           self.precision.acc)

    def _init_force(self, state: cs.SlotState) -> cs.SlotState:
        fa, fb, *_ = self._forces(state, False, False, self._slot_mol(state))
        if self.bonded is not None:
            self._bonded_forces(state, self._inv_map(state), fa, False)
        flt = state.x.dtype
        state = state._replace(**{k: torch.empty_like(state.x, dtype=flt)
                                  for k in ("fx", "fy", "fz")})
        # dtf = 0: the force sum and cast alone, the velocities stay
        self._kick(state, fa, fb, 0.0, False)
        return state

    def _rebin(self, state: cs.SlotState) -> cs.SlotState:
        """The incremental rebin of a block or a thermo row."""
        trace.count("neighbor_build")
        with trace.span("neighbor"):
            return cs.rebin_incremental(self.grid, self.box, state)

    def _block(self, state: cs.SlotState, nsteps: int) -> cs.SlotState:
        trace.count("step", nsteps)
        with trace.span("block"):
            if self.rigid is not None:
                return self._block_rigid(state, nsteps)
            return self._block_verlet(state, nsteps)

    def _block_verlet(self, state: cs.SlotState,
                     nsteps: int) -> cs.SlotState:
        state = self._rebin(state)
        mol = self._slot_mol(state)
        xs = (state.x, state.y, state.z)
        vs = (state.vx, state.vy, state.vz)
        fs = (state.fx, state.fy, state.fz)
        sc, t, L = self.shake, self._shake_t, self.box.lengths
        inv = (self._inv_map(state)
               if self.bonded is not None or sc is not None else None)
        cfg = self.thermostat
        for _ in range(nsteps):
            with trace.span("integrate"):
                if cfg is not None:
                    state = state._replace(therm=nhc_scale(
                        cfg, state.therm, vs, self._kinetic(state),
                        self._t_now))
                if sc is not None:
                    ro = shk.shake_ref(t, xs, inv, L)
                nve.kick_drift(xs, vs, fs, state.typ, state.aid,
                               self._minv_t, self.n_atoms, self.dtf, self.dtv)
                if sc is not None:
                    rn = shk.shake_positions(t, ro, xs, vs, inv, L, self.dtv,
                                             sc.iters)
            fa, fb, *_ = self._forces(state, False, False, mol)
            if self.bonded is not None:
                self._bonded_forces(state, inv, fa, False)
            with trace.span("integrate"):
                partial = self._kick(state, fa, fb, self.dtf,
                                     cfg is not None and sc is None)
                if sc is not None:
                    shk.rattle_velocities(t, vs, inv, L, r=rn)
                    if cfg is not None:
                        # the chain sees the projected velocities
                        partial = self._kinetic(state)
                if cfg is not None:
                    state = state._replace(therm=nhc_scale(
                        cfg, state.therm, vs, partial, self._t_now))
        if sc is not None and nsteps:
            self._shake_rn = rn
        return state

    def _block_rigid(self, state: cs.SlotState,
                     nsteps: int) -> cs.SlotState:
        """fix rigid/small: rebin once, the wrap offsets, then nsteps of
        the quaternion velocity Verlet (see the module docstring)."""
        state = self._rebin(state)
        mol = self._slot_mol(state)
        inv = self._inv_map(state)
        t, bs, d = self._rt, self.body, self._d
        xs = (state.x, state.y, state.z)
        fs = (state.fx, state.fy, state.fz)
        if self._off is None or self._off[0].shape != state.x.shape:
            self._off = tuple(torch.empty_like(state.x) for _ in range(3))
        off = self._off
        rgd.rigid_update(t, bs, d, inv, xs, off, None, None, 0.0, 0.0,
                         rgd.MODE_OFFSETS)
        # the force and torque of the stored forces (those of the last
        # step) start the block
        F, T = rgd.slot_force_torque(t, d, inv, fs)
        for step in range(nsteps):
            with trace.span("integrate"):
                rgd.rigid_update(t, bs, d, inv, xs, off, F, T, self.dtv,
                                 self.dtf, rgd.MODE_INITIAL)
            fa, fb, *_ = self._forces(state, False, False, mol)
            if self.bonded is not None:
                self._bonded_forces(state, inv, fa, False)
            with trace.span("integrate"):
                F, T = rgd.slot_force_torque(t, d, inv, fa, fb, f_out=fs)
                vs = ((state.vx, state.vy, state.vz) if step == nsteps - 1
                      else None)
                rgd.rigid_update(t, bs, d, inv, vs, None, F, T, self.dtv,
                                 self.dtf, rgd.MODE_FINAL)
        return state

    # ---------- thermo ----------

    def _thermo_device(self, state: cs.SlotState) -> dict:
        st = self._rebin(state.clone())
        fs, fk, evdwl, ecoul, elong, virial = self._forces(
            st, True, True, self._slot_mol(st))
        emol = torch.zeros((), dtype=self.precision.acc, device=self.device)
        inv = (self._inv_map(st)
               if self.bonded is not None or self.shake is not None
               or self.rigid is not None else None)
        if self.bonded is not None:
            br = self._bonded_forces(st, inv, fs, True)
            emol = br.emol
            # the CHARMM 1-4 pair terms are tallied into the PAIR energies
            # (the dihedral_charmm.cpp ev_tally convention)
            evdwl = evdwl + br.e14_lj
            ecoul = ecoul + br.e14_coul
            virial = virial + br.virial
        u = self.units
        if self.rigid is not None:
            # the rigid constraint virial on the TOTAL force (pair + bonded
            # in fs, k-space in fk), the JAX package's tally
            _, T = rgd.slot_force_torque(self._rt, self._d, inv, fs, fk)
            virial = virial + rgd.slot_constraint_virial(
                self._rt, self.body, self._d, inv, fs, fk, T, u.ftm2v,
                self.precision.acc)
        if self.shake is not None:
            # the constraint virial on the TOTAL force: pair + bonded in
            # fs, k-space in fk (the fix_shake.cpp pressure tally)
            virial = virial + shk.shake_virial(
                self._shake_t, (st.x, st.y, st.z), (st.vx, st.vy, st.vz), fs,
                fk, inv, self.box.lengths, u.ftm2v, self.precision.acc)
        kin = self._kinetic(st)
        return self._thermo_row(
            kin[:, 0].sum() * u.mvv2e, virial, self.box.volume, evdwl, ecoul,
            elong, emol, overflow=st.overflow,
            vmax=torch.sqrt(kin[:, 1].max()), virial=virial)

    def _overflow_error(self) -> CellOverflowError:
        return CellOverflowError(
            "cell capacity overflow during run; increase cap")

    # ---------- IO ----------

    def atoms_on_device(self) -> dict:
        """``Engine.atoms_on_device`` gathered from the slots; mass is 1 /
        the per-type 1/m of the kick, as the JAX package reads it."""
        n = self.n_atoms
        a = cs.to_atoms(self.grid, self.state)
        typ = a["typ"].to(torch.int32)
        out = {k: a[k].t().contiguous() for k in ("x", "v", "f", "image")}
        sp = self.special
        return dict(
            out, typ=typ, q=a["q"],
            mass=(1.0 / self._minv_t.to(torch.float64))[typ.long()],
            special=None if sp is None else (sp.idx[:n], sp.code[:n]),
            mol=None if self._excl_mol is None else self._excl_mol[:n])

    # ---------- overflow rollback ----------

    _replayable = (CellOverflowError,)

    def _snapshot(self):
        """The segment start: a clone, because the blocks update the
        planes (and the bodies) in place."""
        return (self.state.clone(), self.step_count, self._run_done,
                None if self.body is None else
                (self.body.clone(), self._d.clone()))

    def _rollback(self, snap):
        """Back to the segment start, grown; the run replays the
        segment."""
        self.state, self.step_count, self._run_done, bsnap = snap
        if bsnap is not None:
            self.body, self._d = bsnap
        self._grow_capacity()

    def _grow_capacity(self):
        """Grow the per-cell capacity and rebin the current state into
        the bigger grid."""
        old = self.grid
        new = cs.grow(old)
        self.grid = new
        trace.count("neighbor_build")
        with trace.span("neighbor"):
            self.state = cs.rebin(new, self.box, self.state)
        self.grows += 1
        if bool(trace.to_host(self.state.overflow)):
            raise CellOverflowError(
                f"cell capacity overflow persists after growing "
                f"{old.cap} -> {new.cap}")
