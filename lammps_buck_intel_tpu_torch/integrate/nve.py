"""Velocity-Verlet NVE updates on slot planes (the FixNVEIntel analog).

Counterpart of the NVE half of ``lammps_buck_intel_tpu.integrate.nve`` as
the cell-pair engine uses it: ``v += dtfm * f`` and ``x += dtv * v``, with
``dtfm = dtf / mass[type]`` per slot and 0 on empty slots, which freezes
them.  The updates are in place; each is a multiply and an add rounded
separately, as in the JAX package.  The two-float compensated
integration exists only for f32-only hardware and is not ported.

``kick_drift``, ``kick`` and ``kinetic`` are what the engine calls: on CUDA
planes they launch the kernels of csrc/verlet.cu through ``ops.verlet``; on
CPU planes they run the ``*_plain`` versions, the same arithmetic in torch
ops.  ``typ`` and ``aid`` are the slot planes, ``minv_t`` and ``mass_t``
the per-TYPE 1/mass and mass in the planes' dtype, ``n_atoms`` the id
from which a slot counts as empty.
"""
from __future__ import annotations

import torch


def half_kick(vs, fs, dtfm):
    """v += dtfm * f for each (v, f) plane pair, in place."""
    for v, f in zip(vs, fs):
        v.add_(dtfm * f)


def drift(xs, vs, dtv: float):
    """x += dtv * v for each (x, v) plane pair, in place."""
    for x, v in zip(xs, vs):
        x.add_(dtv * v)


def _per_slot(table, typ, aid, n_atoms: int):
    t = table[typ.long()]
    return torch.where(aid < n_atoms, t, torch.zeros_like(t))


def kick_drift_plain(xs, vs, fs, typ, aid, minv_t, n_atoms, dtf, dtv):
    half_kick(vs, fs, dtf * _per_slot(minv_t, typ, aid, n_atoms))
    drift(xs, vs, dtv)


def kinetic_plain(vs, typ, aid, mass_t, n_atoms, acc_dtype):
    v2 = vs[0] * vs[0] + vs[1] * vs[1] + vs[2] * vs[2]
    mv2 = (_per_slot(mass_t, typ, aid, n_atoms) * v2).to(acc_dtype).sum()
    vmax2 = torch.where(aid < n_atoms, v2, torch.zeros_like(v2)).max()
    return torch.stack([mv2, vmax2.to(acc_dtype)])[None]


def kick_plain(vs, fs, fa, fb, typ, aid, minv_t, mass_t, n_atoms, dtf,
               acc_dtype, ke):
    for f, a, b in zip(fs, fa, fb or (None,) * 3):
        f.copy_(a if b is None else a + b)          # acc -> flt
    half_kick(vs, fs, dtf * _per_slot(minv_t, typ, aid, n_atoms))
    return (kinetic_plain(vs, typ, aid, mass_t, n_atoms, acc_dtype)
            if ke else None)


def _route(plane, name: str):
    """The kernel wrapper on CUDA planes, the plain version on CPU ones."""
    if plane.is_cuda:
        from ..ops import verlet as verlet_ops

        return getattr(verlet_ops, name)
    if plane.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {plane.device}")
    return globals()[f"{name}_plain"]


def kick_drift(xs, vs, fs, typ, aid, minv_t, n_atoms: int, dtf: float,
               dtv: float):
    """First half of a step: v += dtf / m f, then x += dtv v, in place."""
    _route(vs[0], "kick_drift")(xs, vs, fs, typ, aid, minv_t, n_atoms, dtf,
                                dtv)


def kick(vs, fs, fa, fb, typ, aid, minv_t, mass_t, n_atoms: int, dtf: float,
         acc_dtype, ke: bool = False):
    """Second half of a step: the new force f = (flt)(fa + fb) from the
    acc-typed planes ``fa`` (pair and bonded) and ``fb`` (k-space, or
    None) is stored in ``fs`` and kicks v.  ke: also return the kinetic
    partials of the kicked velocities (see ``kinetic``), else None."""
    return _route(vs[0], "kick")(vs, fs, fa, fb, typ, aid, minv_t, mass_t,
                                 n_atoms, dtf, acc_dtype, ke)


def kinetic(vs, typ, aid, mass_t, n_atoms: int, acc_dtype) -> torch.Tensor:
    """(rows, 2) acc-typed partials over the occupied slots: column 0
    sums to sum(m v^2), the max of column 1 is max |v|^2."""
    return _route(vs[0], "kinetic")(vs, typ, aid, mass_t, n_atoms, acc_dtype)
