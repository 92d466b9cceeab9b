"""Carry parameters and state between the JAX package and the port.

Numpy arrays only, so this module never imports jax: the caller fetches
the JAX side with ``jax.device_get`` and passes plain numpy.  The tests
use it to feed identical inputs to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.state import Topology
from .integrate.npt import NPTConfig
from .integrate.rigid import BodyState, RigidBodies
from .integrate.verlet import MDState
from .integrate.shake import ShakeConstraints
from .models.bonded.harmonic import BondedStyle, make_bonded
from .models.kspace.base import BoundKSpace, CombinedKSpace
from .models.kspace.ewald import Ewald
from .models.kspace.pppm import PPPM
from .models.kspace.pppm_disp import PPPMDisp
from .models.pair.styles import PairConfig, PairStyle
from .neighbor.cell_slots import MOVE_FIELDS, SlotState


def pair_style_from_numpy(tables, special_lj, special_coul, qqrd2e: float,
                          g_ewald: float, cutsq_max: float,
                          cfg_fields: dict, inner_sq: float = 0.0,
                          denom_lj: float = 1.0, eps14=None,
                          sig14=None, g_ewald_6: float = 0.0) -> PairStyle:
    """The port's PairStyle from the JAX PairStyle's fields
    (``cfg_fields`` = name, vdw, coul, disp of its PairConfig; inner_sq to
    sig14 are lj/charmm's switching region and 1-4 parameters; g_ewald_6
    the dispersion split of the lj/long and buck/long styles)."""
    return PairStyle(
        cfg=PairConfig(**cfg_fields),
        tables=np.array(tables, np.float64),
        special_lj=np.array(special_lj, np.float64),
        special_coul=np.array(special_coul, np.float64),
        qqrd2e=float(qqrd2e), g_ewald=float(g_ewald),
        g_ewald_6=float(g_ewald_6),
        cutsq_max=float(cutsq_max), inner_sq=float(inner_sq),
        denom_lj=float(denom_lj),
        eps14=None if eps14 is None else np.array(eps14, np.float64),
        sig14=None if sig14 is None else np.array(sig14, np.float64))


def topology_from_numpy(bonds, angles, dihedrals, impropers, special_idx,
                        special_code) -> Topology:
    """The port's Topology from the JAX Topology's fields."""
    return Topology(
        bonds=np.array(bonds, np.int32), angles=np.array(angles, np.int32),
        dihedrals=np.array(dihedrals, np.int32),
        impropers=np.array(impropers, np.int32),
        special_idx=np.array(special_idx, np.int32),
        special_code=np.array(special_code, np.int8))


# the JAX package's improper takes arccos of cos phi clipped to
# +-(1 - 1e-7) and has no force where the clip holds
JAX_IMPROPER_CLIP = 1e-7


def jax_torsion_coeffs(dihedral_coeffs=None, improper_coeffs=None):
    """(dihedral, improper) coefficient tables with which the port gives
    the numbers the JAX package gives with the tables passed.

    The port takes LAMMPS' torsion angle; the JAX package's is that plus
    180 degrees (``models/bonded/charmm.py``).  So d -> d + 180 for odd n
    (charmm rows [K, n, d, w]) and chi0 -> 180 - chi0 (harmonic rows
    [K, chi0]), angles in degrees; a harmonic row gains the JAX package's
    arccos clip, ``JAX_IMPROPER_CLIP``, as its third coefficient.  A None
    or empty table stays as it is."""
    dc, ic = dihedral_coeffs, improper_coeffs
    if dc is not None and len(dc):
        dc = np.array(dc, np.float64)
        dc[:, 2] += 180.0 * (dc[:, 1].astype(np.int64) % 2)
    if ic is not None and len(ic):
        ic = np.array(ic, np.float64)[:, :2]
        ic = np.stack([ic[:, 0], 180.0 - ic[:, 1],
                       np.full(len(ic), JAX_IMPROPER_CLIP)], -1)
    return dc, ic


def jax_torsion_deck(cfg: dict) -> dict:
    """A copy of the deck whose dihedral and improper coefficients are
    mapped by ``jax_torsion_coeffs``: the port then runs the JAX
    package's physics.  The coefficients must be in the deck."""
    import copy

    cfg = copy.deepcopy(cfg)
    for kind, slot in (("dihedral", 0), ("improper", 1)):
        style = cfg.get(f"{kind}_style")
        if not style:
            continue
        if not style.get("coeffs"):
            raise ValueError(f"{kind}_style has no coeffs in the deck")
        args = [None, None]
        args[slot] = style["coeffs"]
        style["coeffs"] = jax_torsion_coeffs(*args)[slot].tolist()
    return cfg


def bonded_from_numpy(fields: dict) -> BondedStyle:
    """The port's BondedStyle that computes what the JAX BondedStyle of
    these fields (``dataclasses.asdict`` of it) computes: its dihedral and
    improper coefficients mapped by ``jax_torsion_coeffs``."""
    fields = dict(fields)
    fields["dihedral_coeffs"], fields["improper_coeffs"] = \
        jax_torsion_coeffs(fields.get("dihedral_coeffs"),
                           fields.get("improper_coeffs"))
    return make_bonded(**fields)


def shake_from_numpy(pairs, d2, invm, iters: int,
                     n_independent: int = -1) -> ShakeConstraints:
    """The port's ShakeConstraints from the JAX ShakeConstraints' fields
    (its Jacobi under-relaxation ``omega`` is read by the scatter forms
    only, which the port does not run)."""
    return ShakeConstraints(
        pairs=np.array(pairs, np.int32), d2=np.array(d2, np.float64),
        invm=np.array(invm, np.float64), iters=int(iters),
        n_independent=int(n_independent))


def npt_config_from_numpy(p_start, p_stop, p_damp: float, flags,
                          couple: str, mtk: bool, pchain: int) -> NPTConfig:
    """The port's NPTConfig from the JAX NPTConfig's fields."""
    return NPTConfig(p_start=tuple(float(v) for v in p_start),
                     p_stop=tuple(float(v) for v in p_stop),
                     p_damp=float(p_damp),
                     flags=tuple(bool(v) for v in flags), couple=str(couple),
                     mtk=bool(mtk), pchain=int(pchain))


def npt_barostat_from_numpy(sim, omega_dot, ptherm, boxL):
    """Carry the barostat of a JAX NPTState (omega_dot (3,), the barostat
    chain ptherm (2, pchain), the box lengths boxL (3,), as numpy) into the
    state of the port's NPTSimulation ``sim``, in its dtype and on its
    device."""
    st = sim.state

    def t(a):
        return torch.as_tensor(np.array(a, np.float64)).to(st.boxL)

    ptherm = t(ptherm).reshape(2, -1)
    if ptherm.shape[1] != sim.npt.pchain:
        raise ValueError(f"ptherm has {ptherm.shape[1]} links, the "
                         f"simulation's barostat chain {sim.npt.pchain}")
    sim.state = st._replace(omega_dot=t(omega_dot).reshape(3),
                            ptherm=ptherm, boxL=t(boxL).reshape(3))


def md_state_from_numpy(x, v, image, therm, device="cuda",
                        f=None) -> MDState:
    """A JAX ``MDState`` (its (N, 3) x, v, image and (2, M) therm as numpy)
    -> the port's ``Simulation.state``: (3, N) planes on ``device`` in x's
    dtype, no overflow.  f: the JAX state's force, carried the same way
    (zeros when None); assign the result to ``sim.state``."""
    dt = torch.as_tensor(np.array(x)).dtype

    def planes(a, dtype):
        return torch.as_tensor(np.array(a)).to(device, dtype).t().contiguous()

    return MDState(
        x=planes(x, dt), v=planes(v, dt),
        image=planes(image, torch.int32),
        f=(torch.zeros((3, len(x)), dtype=dt, device=device)
           if f is None else planes(f, dt)),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        therm=torch.as_tensor(np.array(therm, np.float64)).reshape(2, -1).to(
            device, dt))


def pppm_from_numpy(grid, g_ewald: float, order: int, greensfn, kx, ky, kz,
                    qsum: float, qsqsum: float, qqrd2e: float, volume: float,
                    box_lo, h, acc_dtype=torch.float64) -> PPPM:
    """The port's PPPM from the JAX PPPM's fields (orthogonal, ik)."""
    return PPPM(
        g_ewald=float(g_ewald), grid=tuple(int(v) for v in grid),
        order=int(order), greensfn=np.array(greensfn, np.float64),
        kx=np.array(kx, np.float64), ky=np.array(ky, np.float64),
        kz=np.array(kz, np.float64), qsum=float(qsum), qsqsum=float(qsqsum),
        qqrd2e=float(qqrd2e), volume=float(volume),
        box_lo=tuple(float(v) for v in box_lo),
        h=tuple(float(v) for v in h), acc_dtype=acc_dtype)


def ewald_from_numpy(g_ewald: float, kvecs, ug, mvecs, qsum: float,
                     qsqsum: float, qqrd2e: float, volume: float, kmax,
                     acc_dtype=torch.float64) -> Ewald:
    """The port's Ewald from the JAX Ewald's fields: both packages then sum
    over the same k set."""
    return Ewald(
        g_ewald=float(g_ewald), kvecs=np.array(kvecs, np.float64),
        ug=np.array(ug, np.float64),
        mvecs=None if mvecs is None else np.array(mvecs, np.int32),
        qsum=float(qsum), qsqsum=float(qsqsum), qqrd2e=float(qqrd2e),
        volume=float(volume), kmax=tuple(int(v) for v in kmax),
        acc_dtype=acc_dtype)


def pppm_disp_from_numpy(g_ewald_6: float, grid, order: int, greensfn, kx,
                         ky, kz, B, volume: float, box_lo, h, mix: str, A,
                         P, vfac, acc_dtype=torch.float64) -> PPPMDisp:
    """The port's PPPMDisp from the JAX PPPMDisp's fields (ik): both
    packages then solve on the same mesh with the same tables."""
    return PPPMDisp(
        g_ewald_6=float(g_ewald_6), grid=tuple(int(v) for v in grid),
        order=int(order), greensfn=np.array(greensfn, np.float64),
        kx=np.array(kx, np.float64), ky=np.array(ky, np.float64),
        kz=np.array(kz, np.float64), B=np.array(B, np.float64),
        volume=float(volume), box_lo=tuple(float(v) for v in box_lo),
        h=tuple(float(v) for v in h), acc_dtype=acc_dtype, mix=str(mix),
        A=np.array(A, np.float64), P=np.array(P, np.float64),
        vfac=np.array(vfac, np.float64))


def kspace_from_numpy(parts, acc_dtype=torch.float64):
    """The port's k-space solver from a JAX pppm/disp solver's parts: each
    part is ("pppm", fields of ``pppm_from_numpy``) or ("disp", fields of
    ``pppm_disp_from_numpy``, per_atom, typed) for a JAX ``BoundKSpace``
    of a PPPMDisp; one part gives that solver, several a
    ``CombinedKSpace`` of them in the same order."""
    solvers = []
    for kind, fields, *bound in parts:
        if kind == "pppm":
            solvers.append(pppm_from_numpy(**fields, acc_dtype=acc_dtype))
        elif kind == "disp":
            per_atom, typed = bound
            solvers.append(BoundKSpace(
                pppm_disp_from_numpy(**fields, acc_dtype=acc_dtype),
                np.array(per_atom), typed=bool(typed)))
        else:
            raise ValueError(f"unknown k-space part {kind!r}")
    return solvers[0] if len(solvers) == 1 else CombinedKSpace(solvers)


def rigid_from_numpy(body_of, nbody: int, mtotal, minv, iinv, r_body,
                     mass_per_atom, X0, q0, n_constraints: int, state=None,
                     dtype=torch.float64, device="cpu"):
    """The port's RigidBodies from the JAX RigidBodies' fields, and with
    ``state`` = (X, V, q, L) of a JAX BodyState (numpy) its BodyState in
    ``dtype`` on ``device``: both packages then integrate the same body
    frames.  Returns (RigidBodies, BodyState or None)."""
    rb = RigidBodies(
        body_of=np.array(body_of, np.int32), nbody=int(nbody),
        mtotal=np.array(mtotal, np.float64), minv=np.array(minv, np.float64),
        iinv=np.array(iinv, np.float64), r_body=np.array(r_body, np.float64),
        mass_per_atom=np.array(mass_per_atom, np.float64),
        X0=np.array(X0, np.float64), q0=np.array(q0, np.float64),
        n_constraints=int(n_constraints))
    bs = None
    if state is not None:
        bs = BodyState(*(torch.as_tensor(np.array(a, np.float64)).to(
            device, dtype).contiguous() for a in state))
    return rb, bs


def slot_state_from_numpy(planes: dict, device="cuda") -> SlotState:
    """A JAX SlotState (as a dict of numpy planes) -> the port's.

    Float planes keep their dtype; an empty therm (NVE) becomes None;
    comp must be None (no compensated planes in the port)."""
    if planes.get("comp") is not None:
        raise NotImplementedError("compensated slot planes are not ported")
    out = {f: torch.from_numpy(np.array(planes[f])).to(device)
           for f in MOVE_FIELDS}
    therm = planes.get("therm")
    if therm is not None and np.size(therm):
        out["therm"] = torch.from_numpy(np.array(therm)).to(device)
    for f in ("ix", "iy", "iz", "typ", "aid"):
        out[f] = out[f].to(torch.int32)
    out["overflow"] = torch.tensor(bool(planes["overflow"]), device=device)
    return SlotState(**out)


def slot_state_to_numpy(state: SlotState) -> dict:
    """The port's SlotState -> a dict of numpy planes (JAX field names)."""
    return {f: t.detach().cpu().numpy() for f, t in state._asdict().items()
            if t is not None}
