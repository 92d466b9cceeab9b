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
from .integrate.shake import ShakeConstraints
from .models.bonded.harmonic import BondedStyle, make_bonded
from .models.kspace.pppm import PPPM
from .models.pair.styles import PairConfig, PairStyle
from .neighbor.cell_slots import MOVE_FIELDS, SlotState


def pair_style_from_numpy(tables, special_lj, special_coul, qqrd2e: float,
                          g_ewald: float, cutsq_max: float,
                          cfg_fields: dict, inner_sq: float = 0.0,
                          denom_lj: float = 1.0, eps14=None,
                          sig14=None) -> PairStyle:
    """The port's PairStyle from the JAX PairStyle's fields
    (``cfg_fields`` = name, vdw, coul, disp of its PairConfig; the last
    four are lj/charmm's switching region and 1-4 parameters)."""
    return PairStyle(
        cfg=PairConfig(**cfg_fields),
        tables=np.array(tables, np.float64),
        special_lj=np.array(special_lj, np.float64),
        special_coul=np.array(special_coul, np.float64),
        qqrd2e=float(qqrd2e), g_ewald=float(g_ewald),
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


def bonded_from_numpy(fields: dict) -> BondedStyle:
    """The port's BondedStyle from the JAX BondedStyle's fields
    (``dataclasses.asdict`` of it)."""
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
