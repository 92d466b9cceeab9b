"""Nose-Hoover NPT (``fix npt``) on a neighbor-list engine, with the box
on the card.

Counterpart of ``lammps_buck_intel_tpu.integrate.npt`` (``NPTConfig``,
``NPTState``, ``nh_omega_dot_half``, ``nh_press_vfac``, ``baro_chain_half``,
``NPTSimulation`` without rigid bodies) for orthogonal cells.  Host LAMMPS
contract: ``fix npt temp T T Tdamp iso P P Pdamp`` and the in.rhodo form
``fix npt temp 300 300 100 z 0 0 1000 mtk no pchain 0 tchain 1``, in
fix_nh.cpp's operator splitting.  One step:

  1. the barostat's own chain (pchain > 0);
  2. the thermostat half step on the full kinetic energy (``nve.kinetic``
     and ``nvt.nhc_scale``, csrc/verlet.cu);
  3. the strain-rate half step omega_dot from the per-axis m v^2
     (``npt_ke3``) and the virial diagonal;
  4. the velocity factor exp(-dt/2 omega_dot) and the half kick
     (``npt_vscale_kick``); s = exp(dt omega_dot), boxL <- boxL s; the
     reference bond vectors of SHAKE under the NEW box (``shake_ref``);
     the drift with the dilation about the fixed centre
     (``npt_drift_dilate``); SHAKE, whose constraint virial joins the
     force virial that drives the barostat;
  5. forces on the block's list with the block's G: the list pair pass
     (csrc/nlist.cu), the traced PPPM (``TracedPPPM``), the bonded terms
     (their virial every step, so the bonded kernels run their energy
     variant);
  6. the half kick with the force sum (``nve.kick``), RATTLE, the velocity
     factor, omega_dot, the thermostat, the barostat chain.

A block (``neighbor every`` steps) first wraps the positions into the
current cell (image flags counted), builds the list on that box
(``neighbor_list.build``) and rebuilds G (``TracedPPPM.tables``); within
the block the pair pass takes the minimum image under the current box.
The list is sized at set-up for a box grown by ``BOX_HEADROOM`` (cells
only get wider as the box shrinks); the sticky overflow flag and the
shrink bound are read at thermo rows and at the end of a run, where they
raise, as in the JAX package.

The box is a (3,) flt tensor on the card (``state.boxL``); every kernel of
the step reads it there, and the barostat's scalar arithmetic is 0-d and
(3,) tensor operations on the card, so no value comes to the host inside a
block.  The positions, velocities and forces are (3, N) atom-order planes,
updated in place.  Degrees of freedom 3N - 3 - Nc.

``rigid=`` (fix rigid/npt/small) raises naming ROADMAP queue 1 item 13, a
tilted cell item 14.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.box import make_box, traced_lo, wrap
from ..core.precision import Precision, single
from ..core.state import System, Topology
from ..core.units import LJ, Units
from ..models.bonded import compute_bonded
from ..models.pair import driver
from ..models.pair.styles import PairStyle
from ..neighbor import neighbor_list as nlm
from . import nve
from . import shake as shk
from .nvt import NVTConfig, nhc_scale
from .verlet import NeighborPolicy


# the static bin geometry is sized for a box this much larger than the
# initial one, so cells stay wider than cutneigh down to 1/BOX_HEADROOM of
# each initial length (the JAX package's default box_headroom)
BOX_HEADROOM = 1.10


@dataclasses.dataclass(frozen=True)
class NPTConfig:
    """fix npt parameters (the temperature half is an NVTConfig)."""

    p_start: tuple          # (3,) per-axis target at run start
    p_stop: tuple
    p_damp: float
    flags: tuple = (True, True, True)   # barostatted axes
    couple: str = "xyz"     # "xyz" (iso) | "none" (aniso / per-axis)
    mtk: bool = True
    pchain: int = 0         # barostat chain length (in.rhodo: pchain 0)

    def __post_init__(self):
        if self.pchain < 0:
            raise ValueError("pchain must be >= 0")


class NPTState(NamedTuple):
    x: torch.Tensor          # (3, N) positions (wrapped at block starts)
    v: torch.Tensor          # (3, N)
    f: torch.Tensor          # (3, N) flt force of the last evaluation
    image: torch.Tensor      # (3, N) int32
    boxL: torch.Tensor       # (3,) flt box lengths
    omega_dot: torch.Tensor  # (3,) flt strain rates
    therm: torch.Tensor      # (2, M) thermostat chain
    virial: torch.Tensor     # (6,) acc, last evaluation + constraints
    overflow: torch.Tensor   # () bool, sticky neighbor overflow
    ptherm: torch.Tensor     # (2, Mp) barostat chain


_FLAGS: dict = {}


def _flags(cfg: NPTConfig, like: torch.Tensor) -> torch.Tensor:
    """The barostatted axes as a (3,) bool tensor on like's device, made
    once: a host-to-device copy inside a step would wait for the stream."""
    key = (tuple(cfg.flags), like.device)
    t = _FLAGS.get(key)
    if t is None:
        t = _FLAGS[key] = torch.tensor(cfg.flags, dtype=torch.bool,
                                       device=like.device)
    return t


def nh_omega_dot_half(cfg: NPTConfig, u, n_atoms: int, dt: float,
                      omega_dot, mv2, vir3, V, t_target: float, p_target):
    """Half-step strain-rate update (fix_nh.cpp nh_omega_dot): mv2 (3,)
    per-axis sum m v_a^2 in energy units, vir3 the virial diagonal, V the
    volume, p_target (3,) tensor; tensor operations on the card."""
    p_cur = (mv2 + vir3) / V * u.nktv2p
    flags = _flags(cfg, omega_dot)
    if cfg.couple == "xyz":
        pavg = torch.stack([p_cur[a] for a in range(3)
                            if cfg.flags[a]]).mean()
        p_cur = torch.stack([pavg, pavg, pavg])
    nkt = (n_atoms + 1) * u.boltz * max(t_target, 1e-30)
    W = nkt * cfg.p_damp ** 2
    f_omega = (p_cur - p_target.to(p_cur.dtype)) * V / (W * u.nktv2p)
    if cfg.mtk:
        pdim = max(int(sum(cfg.flags)), 1)
        mtk1 = torch.where(flags, mv2, torch.zeros_like(mv2)).sum() \
            / (n_atoms * pdim)
        f_omega = f_omega + mtk1 / W
    f_omega = torch.where(flags, f_omega, torch.zeros_like(f_omega))
    return omega_dot + (0.5 * dt) * f_omega.to(omega_dot.dtype)


def nh_press_vfac(cfg: NPTConfig, n_atoms: int, dt: float, omega_dot):
    """nh_v_press velocity factor exp(-dt/2 (omega_dot + mtk_term2)), (3,)."""
    flags = _flags(cfg, omega_dot)
    zero = torch.zeros_like(omega_dot)
    if cfg.mtk:
        pdim = max(int(sum(cfg.flags)), 1)
        mtk2 = torch.where(flags, omega_dot, zero).sum() / (pdim * n_atoms)
    else:
        mtk2 = 0.0
    return torch.exp((-0.5 * dt) * torch.where(flags, omega_dot + mtk2, zero))


def baro_chain_half(cfg: NPTConfig, u, n_atoms: int, dt: float, omega_dot,
                    ptherm, t_target: float):
    """Half step of the barostat's Nose-Hoover chain (fix_nh.cpp
    nhc_press_integrate): a chain coupled to sum_a W omega_dot_a^2, every
    link of mass kT p_damp^2, target pdim kT.  Returns (omega_dot,
    ptherm)."""
    m = cfg.pchain
    flags = _flags(cfg, omega_dot)
    pdim = max(int(sum(cfg.flags)), 1)
    dt2, dt4, dt8 = 0.5 * dt, 0.25 * dt, 0.125 * dt
    kt = u.boltz * max(t_target, 1e-30)
    W = (n_atoms + 1) * kt * cfg.p_damp ** 2
    q = kt * cfg.p_damp ** 2
    zero = torch.zeros_like(omega_dot)
    ke2 = torch.where(flags, W * omega_dot * omega_dot, zero).sum()
    eta = ptherm[0]
    ed = list(ptherm[1].unbind(0))

    # backward sweep (tail -> head), the ladder of nvt.nhc_half
    g = [(ke2 - pdim * kt) / q]
    for k in range(1, m):
        g.append((q * ed[k - 1] * ed[k - 1] - kt) / q)
    ed[m - 1] = ed[m - 1] + g[m - 1] * dt4
    for k in range(m - 2, -1, -1):
        expf = torch.exp(-dt8 * ed[k + 1])
        ed[k] = (ed[k] * expf + g[k] * dt4) * expf

    scale = torch.exp(-dt2 * ed[0])
    od = torch.where(flags, omega_dot * scale, omega_dot)
    ke2 = ke2 * scale * scale
    eta = eta + dt2 * torch.stack(ed)

    # forward sweep with the scaled barostat kinetic energy
    g0 = (ke2 - pdim * kt) / q
    expf = torch.exp(-dt8 * ed[1]) if m > 1 else 1.0
    ed[0] = (ed[0] * expf + g0 * dt4) * expf
    for k in range(1, m - 1):
        gk = (q * ed[k - 1] * ed[k - 1] - kt) / q
        expf = torch.exp(-dt8 * ed[k + 1])
        ed[k] = (ed[k] * expf + gk * dt4) * expf
    if m > 1:
        gm = (q * ed[m - 2] * ed[m - 2] - kt) / q
        ed[m - 1] = ed[m - 1] + gm * dt4
    return od, torch.stack([eta, torch.stack(ed)])


# ---------- the per-atom passes: plain torch versions and entry points ----

def ke3_plain(vs, typ, mass_t, acc_dtype) -> torch.Tensor:
    m = mass_t[typ.long()]
    return torch.stack([((m * v) * v).to(acc_dtype).sum() for v in vs])[None]


def vscale_kick_plain(vs, fs, typ, minv_t, vfac, dtf: float):
    dtfm = None if fs is None else dtf * minv_t[typ.long()]
    for a, v in enumerate(vs):
        v.mul_(vfac[a])
        if fs is not None:
            v.add_(dtfm * fs[a])


def drift_dilate_plain(xs, vs, s, center, dtv: float):
    for a, (x, v) in enumerate(zip(xs, vs)):
        c = float(center[a])
        x.copy_(c + ((x + dtv * v) - c) * s[a])


def _route(plane, name: str):
    if plane.is_cuda:
        from ..ops import npt as npt_ops

        return getattr(npt_ops, name)
    if plane.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {plane.device}")
    return globals()[f"{name}_plain"]


def ke3(vs, typ, mass_t, acc_dtype) -> torch.Tensor:
    """(rows, 3) acc partials, column sums sum m v_a^2 (no mvv2e)."""
    return _route(vs[0], "ke3")(vs, typ, mass_t, acc_dtype)


def vscale_kick(vs, fs, typ, minv_t, vfac, dtf: float):
    """v_a <- v_a vfac_a, then + (dtf / m) f_a unless fs is None; in place."""
    _route(vs[0], "vscale_kick")(vs, fs, typ, minv_t, vfac, dtf)


def drift_dilate(xs, vs, s, center, dtv: float):
    """x_a <- c_a + ((x_a + dtv v_a) - c_a) s_a; in place."""
    _route(vs[0], "drift_dilate")(xs, vs, s, center, dtv)


class NPTSimulation:
    """Variable-cell MD on a neighbor-list engine; the device is that of
    ``system``.  The box stays centred on its initial centre and dilates
    per axis.  kspace: a ``pppm_npt.TracedPPPM`` or None; shake: SHAKE/
    RATTLE constraints whose virial joins the barostat's pressure every
    step (in.rhodo's shake + npt)."""

    def __init__(
        self,
        system: System,
        pair: PairStyle,
        npt: NPTConfig,
        thermostat: NVTConfig,
        kspace=None,
        bonded=None,
        units: Units = LJ,
        precision: Optional[Precision] = None,
        dt: Optional[float] = None,
        neighbor: Optional[NeighborPolicy] = None,
        shake: Optional[shk.ShakeConstraints] = None,
        topology: Optional[Topology] = None,
        rigid=None,
    ):
        if rigid is not None:
            raise NotImplementedError(
                "fix rigid/npt/small (rigid bodies under the barostat) is not "
                "ported: ROADMAP queue 1 item 13")
        if system.box.is_triclinic:
            raise NotImplementedError(
                "fix npt on a triclinic cell is not ported: ROADMAP queue 1 "
                "item 14")
        self.units = units
        self.precision = precision or single()
        self.dt = units.dt if dt is None else dt
        self.pair = pair
        self.kspace = kspace
        self.bonded = bonded if (bonded is not None
                                 and bonded.has_terms) else None
        self.neighbor = neighbor or NeighborPolicy(skin=units.skin)
        self.npt = npt
        self.topology = topology
        self.device = dev = system.x.device
        n = system.n_atoms
        self.n_atoms = n
        flt, acc = self.precision.flt, self.precision.acc

        box0 = system.box
        L0 = np.asarray(box0.lengths, np.float64)
        self._center = np.asarray(box0.lo, np.float64) + 0.5 * L0
        # on the card once: the steps never copy from the host
        self._center_t = torch.as_tensor(self._center).to(dev, flt)
        self._p_ends = (None, None)     # (config, its (p_start, p_stop))
        self._L0 = L0
        # the bin geometry is sized for a box grown by BOX_HEADROOM and stays
        # static (cells only get wider as the box shrinks), validated at
        # rebuilds by the overflow flag and the shrink bound
        cutneigh = float(np.sqrt(pair.cutsq_max)) + self.neighbor.skin
        self.spec = nlm.make_spec(n, L0, cutneigh * BOX_HEADROOM)

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
        # per-type mass and 1/mass in flt, as the JAX NPT runner bakes them
        self._mass_t = system.mass.to(device=dev, dtype=flt).contiguous()
        self._minv_t = (1.0 / self._mass_t).contiguous()
        self.dtf = float(0.5 * self.dt * units.ftm2v)
        self.dtv = float(self.dt)

        self.shake = shake
        self._shake_t = None
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
        self.thermostat = dataclasses.replace(
            thermostat, dof=self.dof, boltz=units.boltz, mvv2e=units.mvv2e,
            dt=self.dt)
        tchain = self.thermostat.tchain

        def planes(a, dtype):
            return a.to(device=dev, dtype=dtype).t().contiguous()

        st = NPTState(
            x=planes(system.x, flt), v=planes(system.v, flt),
            f=torch.zeros((3, n), dtype=flt, device=dev),
            image=planes(system.image, torch.int32),
            boxL=torch.as_tensor(L0).to(dev, flt),
            omega_dot=torch.zeros(3, dtype=flt, device=dev),
            therm=torch.zeros((2, tchain), dtype=flt, device=dev),
            virial=torch.zeros(6, dtype=acc, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            ptherm=torch.zeros((2, npt.pchain), dtype=flt, device=dev))
        if shake is not None:
            # settle onto the constraints (x_old = x_new, dt = 1; the
            # velocities stay), then project the velocities
            t, inv = self._shake_t, self._inv
            xs, vs = tuple(st.x.unbind(0)), tuple(st.v.unbind(0))
            ro = shk.shake_ref(t, xs, inv, L0)
            shk.shake_positions(t, ro, xs, None, inv, L0, 1.0, shake.iters)
            shk.rattle_velocities(t, vs, inv, L0, xs=xs)
        _, self.spec = nlm.build_with_retry(
            st.x, torch.as_tensor(np.asarray(box0.lo)).to(dev, flt),
            torch.as_tensor(L0).to(dev, flt), self.spec, self._special)
        self.state = self._init_forces(st)
        self.step_count = 0
        self.timings = {"run": 0.0}

    # ---------- forces ----------

    def _build_nl(self, x, boxL):
        return nlm.build(x, traced_lo(self._center_t, boxL), boxL, self.spec,
                         self._special)

    def _kspace_kc(self, boxL):
        return None if self.kspace is None else self.kspace.tables(boxL)

    def _forces(self, x, boxL, nl, kc, eflag: bool = False):
        """(fa, fb, virial, energies): fa the acc planes of pair + bonded
        forces, fb the k-space planes or None, the (6,) virial; with eflag
        energies = (evdwl, ecoul, elong, emol), the CHARMM 1-4 pair terms
        in evdwl and ecoul."""
        acc = self.precision.acc
        pr = driver.compute_pair(
            self.pair, x, self.typ, self.q, boxL, nl, eflag=eflag,
            acc_dtype=acc, use_special=self._special is not None)
        fa = (pr.fx, pr.fy, pr.fz)
        virial = pr.virial
        zero = torch.zeros((), dtype=acc, device=self.device)
        evdwl, ecoul, elong, emol = pr.evdwl, pr.ecoul, zero, zero
        fb = None
        if self.kspace is not None:
            kr = self.kspace.compute_traced(x, self.q, boxL, eflag=eflag,
                                            kc=kc)
            fb = kr.f
            virial = virial + kr.virial
            elong = kr.elong
        if self.bonded is not None:
            # the energy variant every step: the barostat needs the bonded
            # virial, which the force-only variant does not reduce
            br = compute_bonded(self.bonded, tuple(x.unbind(0)), boxL,
                                eflag=True, acc_dtype=acc, out=fa)
            virial = virial + br.virial
            if eflag:
                emol = br.emol
                evdwl = evdwl + br.e14_lj
                ecoul = ecoul + br.e14_coul
        energies = (evdwl, ecoul, elong, emol) if eflag else None
        return fa, fb, virial, energies

    def _kick(self, st: NPTState, fa, fb, dtf: float):
        """f = (flt)(fa + fb) into st.f, then v += dtf / m f."""
        nve.kick(tuple(st.v.unbind(0)), tuple(st.f.unbind(0)), fa, fb,
                 self.typ, self._aid, self._minv_t, self._mass_t,
                 self.n_atoms, dtf, self.precision.acc)

    def _init_forces(self, st: NPTState) -> NPTState:
        nl = self._build_nl(st.x, st.boxL)
        fa, fb, virial, _ = self._forces(st.x, st.boxL, nl,
                                         self._kspace_kc(st.boxL))
        self._kick(st, fa, fb, 0.0)   # the force sum and cast alone
        return st._replace(virial=virial, overflow=st.overflow | nl.overflow)

    # ---------- NPT step ----------

    def _mv2(self, v) -> torch.Tensor:
        """(3,) per-axis sum m v_a^2 in energy units (acc)."""
        part = ke3(tuple(v.unbind(0)), self.typ, self._mass_t,
                   self.precision.acc)
        return part.sum(0) * self.units.mvv2e

    def _volume(self, boxL):
        return (boxL[0] * boxL[1] * boxL[2]).to(self.precision.acc)

    def _press_current(self, st: NPTState):
        """Per-axis pressure (sum m v_a^2 + W_aa) / V nktv2p, mv2, V."""
        mv2 = self._mv2(st.v)
        V = self._volume(st.boxL)
        return (mv2 + st.virial[:3]) / V * self.units.nktv2p, mv2, V

    def _omega_dot_half(self, st: NPTState, t_target, p_target):
        return nh_omega_dot_half(self.npt, self.units, self.n_atoms, self.dt,
                                 st.omega_dot, self._mv2(st.v),
                                 st.virial[:3], self._volume(st.boxL),
                                 t_target, p_target)

    def _chain(self, st: NPTState, t_target) -> NPTState:
        vs = tuple(st.v.unbind(0))
        part = nve.kinetic(vs, self.typ, self._aid, self._mass_t,
                           self.n_atoms, self.precision.acc)
        return st._replace(therm=nhc_scale(self.thermostat, st.therm, vs,
                                           part, t_target))

    def _baro_chain(self, st: NPTState, t_target) -> NPTState:
        if not self.npt.pchain:
            return st
        od, pt = baro_chain_half(self.npt, self.units, self.n_atoms, self.dt,
                                 st.omega_dot, st.ptherm, t_target)
        return st._replace(omega_dot=od, ptherm=pt)

    def _one_step(self, st: NPTState, nl, kc, t_target,
                  p_target) -> NPTState:
        dtf, dtv = self.dtf, self.dtv
        xs, vs = tuple(st.x.unbind(0)), tuple(st.v.unbind(0))
        fs = tuple(st.f.unbind(0))
        st = self._baro_chain(st, t_target)
        st = self._chain(st, t_target)
        st = st._replace(omega_dot=self._omega_dot_half(st, t_target,
                                                        p_target))
        vfac = nh_press_vfac(self.npt, self.n_atoms, self.dt, st.omega_dot)
        vscale_kick(vs, fs, self.typ, self._minv_t, vfac, dtf)
        flags = _flags(self.npt, st.omega_dot)
        s = torch.exp(dtv * torch.where(flags, st.omega_dot,
                                        torch.zeros_like(st.omega_dot)))
        boxL = st.boxL * s
        vir_c = None
        if self.shake is not None:
            # reference bond vectors of the pre-drift positions under the
            # NEW box (the JAX package folds x_ref with the dilated lengths)
            ro = shk.shake_ref(self._shake_t, xs, self._inv, boxL)
        drift_dilate(xs, vs, s, self._center, dtv)
        if self.shake is not None:
            _, vir_c = shk.shake_positions(
                self._shake_t, ro, xs, vs, self._inv, boxL, dtv,
                self.shake.iters, virial_factor=1.0 / (dtv * dtf))
        fa, fb, virial, _ = self._forces(st.x, boxL, nl, kc)
        if vir_c is not None:
            virial = virial + vir_c
        st = st._replace(boxL=boxL, virial=virial)
        self._kick(st, fa, fb, dtf)
        if self.shake is not None:
            shk.rattle_velocities(self._shake_t, vs, self._inv, boxL, xs=xs)
        vscale_kick(vs, None, self.typ, self._minv_t, vfac, 0.0)
        st = st._replace(omega_dot=self._omega_dot_half(st, t_target,
                                                        p_target))
        st = self._chain(st, t_target)
        return self._baro_chain(st, t_target)

    def _block(self, st: NPTState, nsteps: int, t_target,
               p_target) -> NPTState:
        """Wrap, rebuild the list and G on the block-start box, then
        nsteps with the stale list (the skin bound)."""
        x, image = wrap(st.x, st.image, traced_lo(self._center_t, st.boxL),
                        st.boxL)
        st = st._replace(x=x, image=image)
        nl = self._build_nl(st.x, st.boxL)
        st = st._replace(overflow=st.overflow | nl.overflow)
        kc = self._kspace_kc(st.boxL)
        for _ in range(nsteps):
            st = self._one_step(st, nl, kc, t_target, p_target)
        return st

    # ---------- thermo ----------

    def _thermo_device(self, st: NPTState) -> dict:
        u = self.units
        p_cur, mv2, V = self._press_current(st)
        sum_mv2 = mv2.sum()
        temp = sum_mv2 / (self.dof * u.boltz)
        ke = 0.5 * sum_mv2
        press = (sum_mv2 + st.virial[0] + st.virial[1] + st.virial[2]) \
            / (3.0 * V) * u.nktv2p
        nl = self._build_nl(st.x, st.boxL)
        _, _, _, (evdwl, ecoul, elong, emol) = self._forces(
            st.x, st.boxL, nl, self._kspace_kc(st.boxL), eflag=True)
        epair = evdwl + ecoul + elong
        return dict(temp=temp, ke=ke, press=press, p_axis=p_cur,
                    boxL=st.boxL, vol=V, omega_dot=st.omega_dot,
                    evdwl=evdwl, ecoul=ecoul, elong=elong, emol=emol,
                    epair=epair, etotal=epair + emol + ke,
                    overflow=st.overflow | nl.overflow)

    def _guards(self, overflow: bool, boxL: np.ndarray, step: int):
        # overflow first: dropped pairs cause the non-finite dynamics
        if overflow:
            raise RuntimeError(
                "NPT neighbor overflow: per-atom neighbor count exceeded the "
                "capacity sized from the initial density; compression "
                "outgrew the spec: restart from the compressed state or "
                "raise BOX_HEADROOM")
        # the static bin geometry holds down to 1/BOX_HEADROOM shrinkage per
        # axis; past that the 27-cell stencil no longer covers cutneigh
        shrink = np.asarray(boxL, np.float64) / self._L0
        if float(shrink.min()) < 1.0 / BOX_HEADROOM - 1e-9:
            raise RuntimeError(
                f"box shrank to {shrink.min():.3f} of its initial length at "
                f"step {step}, beyond the bin-geometry bound "
                f"1/{BOX_HEADROOM}; rebuild the simulation from the "
                "compressed state")

    def thermo(self) -> dict:
        row = self._thermo_device(self.state)
        keys = [k for k, v in row.items() if v.dim() == 0]
        vecs = [k for k, v in row.items() if v.dim() == 1]
        # one device -> host transfer for the whole row
        host = torch.cat([torch.stack([row[k].to(torch.float64)
                                       for k in keys])]
                         + [row[k].to(torch.float64) for k in vecs]
                         ).cpu().numpy()
        out = {k: float(v) for k, v in zip(keys, host[:len(keys)])}
        off = len(keys)
        for k in vecs:
            out[k] = host[off:off + 3]
            off += 3
        out["step"] = self.step_count
        out["overflow"] = bool(out["overflow"])
        self._guards(out["overflow"], out["boxL"], self.step_count)
        if not np.isfinite(out["temp"]) or not np.isfinite(out["press"]):
            raise RuntimeError(f"non-finite thermo at step {out['step']}")
        return out

    # ---------- IO ----------

    def get_atoms(self) -> dict:
        """Atom-ordered snapshot (host numpy copies: the run updates the
        state in place), with the current box."""
        st = self.state
        out = {k: np.array(getattr(st, k).t().cpu().numpy())
               for k in ("x", "v", "f", "image")}
        out["boxL"] = np.array(st.boxL.cpu().numpy())
        out["typ"] = np.array(self.typ.cpu().numpy())
        out["q"] = np.array(self.q.cpu().numpy())
        return out

    @property
    def current_box(self):
        L = self.state.boxL.cpu().numpy().astype(np.float64)
        return make_box(self._center - 0.5 * L, self._center + 0.5 * L)

    @property
    def box(self):
        """Host Box at the current (dilated) lengths."""
        return self.current_box

    # ---------- main loop ----------

    def _targets(self, frac: float):
        """(t_target, p_target) of a block ending at fraction ``frac`` of
        the run, rounded through flt as the JAX package's are."""
        flt = self.precision.flt
        cfg = self.thermostat
        tt = float(torch.tensor(cfg.t_start + (cfg.t_stop - cfg.t_start)
                                * frac, dtype=flt))
        if self._p_ends[0] is not self.npt:
            self._p_ends = (self.npt, tuple(
                torch.as_tensor(np.asarray(p, np.float64)).to(self.device)
                for p in (self.npt.p_start, self.npt.p_stop)))
        p0, p1 = self._p_ends[1]
        return tt, (p0 + (p1 - p0) * frac).to(flt)

    def run(self, nsteps: int, thermo_every: int = 0, log: bool = True):
        rows = []

        def emit():
            row = self.thermo()
            rows.append(row)
            if log:
                L = row["boxL"]
                print(f"{row['step']:>8d} T={row['temp']:.4g} "
                      f"E={row['etotal']:.8g} P={row['press']:.6g} "
                      f"V={row['vol']:.6g} "
                      f"L=({L[0]:.4f},{L[1]:.4f},{L[2]:.4f})")

        t0 = time.perf_counter()
        if self.state.ptherm.shape[1] != self.npt.pchain:
            # the config was swapped: re-seed the barostat chain
            self.state = self.state._replace(ptherm=torch.zeros(
                (2, self.npt.pchain), dtype=self.precision.flt,
                device=self.device))
        if thermo_every:
            emit()
        done = 0
        cadence = max(1, self.neighbor.every)
        while done < nsteps:
            target = min(nsteps, done + (thermo_every or nsteps))
            while done < target:
                size = min(cadence, target - done)
                # segment-END ramps: t_stop / p_stop reached on the last step
                tt, pt = self._targets((done + size) / max(nsteps, 1))
                self.state = self._block(self.state, size, tt, pt)
                done += size
                self.step_count += size
            if thermo_every:
                emit()
        # the guards fire even with thermo off
        host = torch.cat([self.state.overflow.to(torch.float64)[None],
                          self.state.boxL.to(torch.float64)]).cpu().numpy()
        self._guards(bool(host[0]), host[1:], self.step_count)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["run"] += time.perf_counter() - t0
        return rows

