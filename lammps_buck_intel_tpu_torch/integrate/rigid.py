"""Quaternion rigid bodies (``fix rigid/small``).

Counterpart of ``lammps_buck_intel_tpu.integrate.rigid``: each molecule
is a rigid body integrated by velocity Verlet of its centre of mass and
a Richardson quaternion update from its angular momentum.  Conventions
(the JAX package's): q = (w, x, y, z) maps the body frame to the space
frame, ``r_body`` are the atoms' offsets in the principal frame, L is the
space-frame angular momentum, omega_body = I^-1 A(q)^T L, qdot = 0.5 q
(0, omega_body).

Host numpy: ``make_rigid_bodies`` (one body per molecule id, principal
frames, the removed degrees of freedom) and ``body_state_from_atoms``.
Plain torch, any device, atom order, the JAX expressions in their order:
the quaternion helpers, ``init_body_state``, ``atom_positions``,
``atom_velocities``, ``force_torque``, ``richardson``,
``initial_integrate_rigid(_ft)``, ``final_integrate_rigid(_ft)``,
``rotational_ke`` and ``constraint_virial``.

The cell engine's step (``CellPairSimulation`` with ``rigid``) runs three
kernels (``csrc/rigid.cu`` through ``ops.rigid``) whose plain versions,
with the same signatures, are here:

* ``slot_force_torque`` (K15a): the atoms' force f = (flt)(fa + fb) read
  from the slot planes through the atom -> slot map, optionally stored
  into the slot force planes, and per body F = sum f, T = sum d x f;
* ``rigid_update`` (K15b): per body the half kick of V and L and, in the
  initial form, the drift of X and the Richardson rotation; per atom the
  space offsets d = A(q) r_body and the slot positions X + d + off, or in
  the final form the slot velocities V + omega x d; the offsets form
  sets off = x - (X + d) once a block;
* ``slot_constraint_virial`` (K15c): the rigid constraint virial of
  thermo rows.

On CUDA tensors these launch the kernels; on CPU tensors they run the
plain versions.  The body state is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RigidBodies:
    """Static (host numpy) rigid-body structure, the JAX package's fields.

    body_of (N,) int32 atom -> body; mtotal, minv (B,); iinv (B, 3)
    inverse principal moments (0 on degenerate axes); r_body (N, 3);
    mass_per_atom (N,); X0 (B, 3), q0 (B, 4) the build-time geometry;
    n_constraints the removed degrees of freedom (3N - sum of the bodies'
    degrees of freedom)."""

    body_of: np.ndarray
    nbody: int
    mtotal: np.ndarray
    minv: np.ndarray
    iinv: np.ndarray
    r_body: np.ndarray
    mass_per_atom: np.ndarray
    X0: np.ndarray
    q0: np.ndarray
    n_constraints: int

    def tables_on(self, device, dtype) -> "RigidTables":
        """The device tables of the kernels and their plain versions."""
        bo = np.asarray(self.body_of, np.int64)
        order = np.argsort(bo, kind="stable").astype(np.int32)
        counts = np.bincount(bo, minlength=self.nbody)
        start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

        def up(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device, dt)

        return RigidTables(
            body_of=up(bo, torch.int64), order=up(order, torch.int32),
            start=up(start, torch.int32), r_body=up(self.r_body, dtype),
            mass=up(self.mass_per_atom, dtype), minv=up(self.minv, dtype),
            iinv=up(self.iinv, dtype), nbody=int(self.nbody),
            max_size=int(counts.max()) if len(counts) else 0)


class RigidTables(NamedTuple):
    """Device form of ``RigidBodies``: body_of (N,) int64; order (N,)
    int32 the atoms sorted by body and start (B + 1,) int32 (a CSR of atoms
    per body); r_body (N, 3), mass (N,), minv (B,), iinv (B, 3) in flt."""

    body_of: torch.Tensor
    order: torch.Tensor
    start: torch.Tensor
    r_body: torch.Tensor
    mass: torch.Tensor
    minv: torch.Tensor
    iinv: torch.Tensor
    nbody: int
    max_size: int


class BodyState(NamedTuple):
    X: torch.Tensor   # (B, 3) centres of mass (unwrapped)
    V: torch.Tensor   # (B, 3) centre-of-mass velocities
    q: torch.Tensor   # (B, 4) orientations
    L: torch.Tensor   # (B, 3) space-frame angular momenta

    def clone(self) -> "BodyState":
        return BodyState(*(t.clone() for t in self))


# ---------- quaternion algebra (batched (..., 4)) ----------

def _cross(a, b):
    return torch.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """A(q) v: body-frame vectors into the space frame."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_rotate_inv(q, v):
    """A(q)^T v: space-frame vectors into the body frame."""
    w = q[..., 0:1]
    u = -q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_mul_vec(q, wvec):
    """q (0, wvec), the quaternion product with a pure vector."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    rw = -torch.sum(qv * wvec, dim=-1, keepdim=True)
    rv = qw * wvec + _cross(qv, wvec)
    return torch.cat([rw, rv], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _quat_from_matrix(E: np.ndarray) -> np.ndarray:
    """Host: rotation matrix (columns = principal axes) -> (w, x, y, z)."""
    t = np.trace(E)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (E[2, 1] - E[1, 2]) / s
        y = (E[0, 2] - E[2, 0]) / s
        z = (E[1, 0] - E[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(E)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + E[i, i] - E[j, j] - E[k, k]) * 2
        vals = np.zeros(4)
        vals[1 + i] = 0.25 * s
        vals[0] = (E[k, j] - E[j, k]) / s
        vals[1 + j] = (E[j, i] + E[i, j]) / s
        vals[1 + k] = (E[k, i] + E[i, k]) / s
        w, x, y, z = vals
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


# ---------- build (host numpy) ----------

def _minimg_host(d, L_box):
    """Minimum image of (k, 3) displacements against per-axis lengths (or
    an orthogonal Box)."""
    d = np.array(d, np.float64)
    if getattr(L_box, "is_triclinic", False):
        raise NotImplementedError(
            "rigid bodies in a triclinic box are not ported: ROADMAP queue 1 "
            "item 14")
    Lb = (np.asarray(L_box.lengths, np.float64)
          if hasattr(L_box, "lengths") else np.asarray(L_box, np.float64))
    return d - np.round(d / Lb) * Lb


def make_rigid_bodies(x, molecule, mass_per_atom, L_box) -> RigidBodies:
    """``fix rigid/small molecule``: one body per molecule id.  Molecules
    that straddle the box are reassembled by the minimum image relative to
    their first atom."""
    x = np.asarray(x, np.float64)
    mol = np.asarray(molecule)
    m = np.asarray(mass_per_atom, np.float64)
    uniq, body_of = np.unique(mol, return_inverse=True)
    B = len(uniq)
    n = len(x)
    r_body = np.zeros((n, 3))
    mtot = np.zeros(B)
    iinv = np.zeros((B, 3))
    X0 = np.zeros((B, 3))
    q0 = np.zeros((B, 4))
    removed = 0
    order = np.argsort(body_of, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(body_of,
                                                        minlength=B))])
    for b in range(B):
        idx = order[bounds[b]:bounds[b + 1]]
        xb = x[idx].copy()
        xb = xb[0] + _minimg_host(xb - xb[0], L_box)
        mb = m[idx]
        M = mb.sum()
        com = (mb[:, None] * xb).sum(0) / M
        rel = xb - com
        I = np.zeros((3, 3))
        for k in range(len(idx)):
            r = rel[k]
            I += mb[k] * (np.dot(r, r) * np.eye(3) - np.outer(r, r))
        evals, E = np.linalg.eigh(I)
        if np.linalg.det(E) < 0:
            E[:, 2] = -E[:, 2]
        imax = float(evals.max()) if len(idx) > 1 else 0.0
        inv = np.zeros(3)
        ndeg = 0
        for ax in range(3):
            if imax > 0 and evals[ax] > 1e-9 * imax:
                inv[ax] = 1.0 / evals[ax]
            else:
                ndeg += 1
        mtot[b] = M
        iinv[b] = inv
        X0[b] = com
        q0[b] = _quat_from_matrix(E)
        r_body[idx] = rel @ E
        removed += 3 * len(idx) - (6 - ndeg)
    return RigidBodies(
        body_of=body_of.astype(np.int32), nbody=B, mtotal=mtot,
        minv=1.0 / mtot, iinv=iinv, r_body=r_body,
        mass_per_atom=m, X0=X0, q0=q0, n_constraints=int(removed))


def _segment_sum(values, body_of, nbody):
    out = torch.zeros((nbody,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, body_of, values)


def init_body_state(rb: RigidBodies, v, dtype=torch.float64,
                    device="cpu") -> BodyState:
    """The build-time state: X and q from the build, V and L projected
    from the atoms' velocities v (N, 3) (any non-rigid component is
    dropped, the fix rigid zeroing of internal motion)."""
    v = torch.as_tensor(np.asarray(v)).to(device, dtype)
    bo = torch.as_tensor(np.asarray(rb.body_of, np.int64)).to(device)
    mb = torch.as_tensor(rb.mass_per_atom).to(device, dtype)[:, None]
    B = rb.nbody
    V = (_segment_sum(mb * v, bo, B)
         / torch.as_tensor(rb.mtotal).to(device, dtype)[:, None])
    q = torch.as_tensor(rb.q0).to(device, dtype)
    d = quat_rotate(q[bo], torch.as_tensor(rb.r_body).to(device, dtype))
    L = _segment_sum(_cross(d, mb * (v - V[bo])), bo, B)
    return BodyState(X=torch.as_tensor(rb.X0).to(device, dtype), V=V, q=q,
                     L=L)


# ---------- the plain per-step functions (atom order) ----------

def _tab(rb, name, ref: torch.Tensor):
    """A RigidBodies / RigidTables field as a tensor like ``ref``."""
    a = getattr(rb, name)
    if isinstance(a, torch.Tensor):
        return a
    if name == "body_of":
        return torch.as_tensor(np.asarray(a, np.int64)).to(ref.device)
    return torch.as_tensor(np.asarray(a)).to(ref.device, ref.dtype)


def atom_positions(rb, bs: BodyState):
    bo = _tab(rb, "body_of", bs.X)
    d = quat_rotate(bs.q[bo], _tab(rb, "r_body", bs.X))
    return bs.X[bo] + d, d


def body_omega(rb, q, L):
    """Space-frame angular velocity from the space-frame L."""
    wb = _tab(rb, "iinv", q) * quat_rotate_inv(q, L)
    return quat_rotate(q, wb)


def atom_velocities(rb, bs: BodyState, d):
    """v_i = V_b + omega_b x d_i (d the space-frame offsets)."""
    bo = _tab(rb, "body_of", bs.X)
    om = body_omega(rb, bs.q, bs.L)
    return bs.V[bo] + _cross(om[bo], d)


def force_torque(rb, d, f):
    """Body force and torque from the atoms' forces (d the space
    offsets)."""
    bo = _tab(rb, "body_of", d)
    B = int(rb.nbody)
    f = f.to(d.dtype)
    return _segment_sum(f, bo, B), _segment_sum(_cross(d, f), bo, B)


def richardson(rb, q, L, dt: float, iters: int = 2):
    """Midpoint (Richardson) quaternion drift at constant L."""
    iinv = _tab(rb, "iinv", q)

    def qdot(qq):
        wb = iinv * quat_rotate_inv(qq, L)
        return 0.5 * quat_mul_vec(qq, wb)

    q_half = quat_normalize(q + (0.5 * dt) * qdot(q))
    for _ in range(iters):
        q_half = quat_normalize(q + (0.5 * dt) * qdot(q_half))
    return quat_normalize(q + dt * qdot(q_half))


def initial_integrate_rigid_ft(rb, bs: BodyState, F, T, dtv: float,
                               dtf: float) -> BodyState:
    """Half kick + drift from the body force and torque."""
    V = bs.V + (dtf * _tab(rb, "minv", bs.V))[:, None] * F
    L = bs.L + dtf * T
    X = bs.X + dtv * V
    q = richardson(rb, bs.q, L, dtv)
    return BodyState(X=X, V=V, q=q, L=L)


def final_integrate_rigid_ft(rb, bs: BodyState, F, T,
                             dtf: float) -> BodyState:
    V = bs.V + (dtf * _tab(rb, "minv", bs.V))[:, None] * F
    L = bs.L + dtf * T
    return bs._replace(V=V, L=L)


def initial_integrate_rigid(rb, bs: BodyState, f, d, dtv: float,
                            dtf: float) -> BodyState:
    """Half kick + drift: the V and L kicks use dtf = 0.5 dt ftm2v, X
    drifts by dtv."""
    F, T = force_torque(rb, d, f)
    return initial_integrate_rigid_ft(rb, bs, F, T, dtv, dtf)


def final_integrate_rigid(rb, bs: BodyState, f, d, dtf: float) -> BodyState:
    F, T = force_torque(rb, d, f)
    return final_integrate_rigid_ft(rb, bs, F, T, dtf)


def body_state_from_atoms(rb: RigidBodies, x, v, L_box,
                          dtype=torch.float64) -> BodyState:
    """Host: the body state from atom arrays (checkpoint resume): centre
    of mass and velocity projection, and a per-body Kabsch fit of the
    orientation against the build-time r_body."""
    x = np.asarray(x, np.float64)
    v = np.asarray(v, np.float64)
    m = rb.mass_per_atom
    B = rb.nbody
    X = np.zeros((B, 3))
    q = np.zeros((B, 4))
    V = np.zeros((B, 3))
    L = np.zeros((B, 3))
    for b in range(B):
        idx = np.nonzero(rb.body_of == b)[0]
        xb = x[idx].copy()
        xb = xb[0] + _minimg_host(xb - xb[0], L_box)
        mb = m[idx][:, None]
        M = rb.mtotal[b]
        com = (mb * xb).sum(0) / M
        rel = xb - com
        H = (mb * rb.r_body[idx]).T @ rel
        U, _, Vt = np.linalg.svd(H)
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        A = Vt.T @ D @ U.T
        X[b] = com
        q[b] = _quat_from_matrix(A)
        Vb = (mb * v[idx]).sum(0) / M
        V[b] = Vb
        L[b] = np.sum(np.cross(rel, m[idx][:, None] * (v[idx] - Vb)),
                      axis=0)

    def t(a):
        return torch.as_tensor(a).to(dtype)

    return BodyState(X=t(X), V=t(V), q=t(q), L=t(L))


def rotational_ke(rb, bs: BodyState, mvv2e: float = 1.0):
    """0.5 omega . L summed over the bodies (energy units)."""
    om = body_omega(rb, bs.q, bs.L)
    return 0.5 * mvv2e * torch.sum(om * bs.L)


def constraint_virial(rb, bs: BodyState, d, f, ftm2v: float,
                      acc_dtype=torch.float64):
    """The rigid constraint virial (6,) [xx yy zz xy xz yz]: the internal
    force holding atom i on its body, f_c = m a_rigid / ftm2v - f with
    a_rigid = alpha x d + omega x (omega x d), tallied as d_a f_c,b (the
    JAX package's contract)."""
    bo = _tab(rb, "body_of", d)
    iinv = _tab(rb, "iinv", d)
    _, T = force_torque(rb, d, f)
    Lb = quat_rotate_inv(bs.q, bs.L)
    wb = iinv * Lb
    wdotb = iinv * (ftm2v * quat_rotate_inv(bs.q, T) - _cross(wb, Lb))
    alpha = quat_rotate(bs.q, wdotb)
    om = quat_rotate(bs.q, wb)
    omi, ali = om[bo], alpha[bo]
    a = _cross(ali, d) + _cross(omi, _cross(omi, d))
    m = _tab(rb, "mass_per_atom" if isinstance(rb, RigidBodies) else "mass",
             d)[:, None]
    fc = (m / ftm2v) * a - f.to(d.dtype)
    return torch.stack([
        (d[:, a_] * fc[:, b_]).to(acc_dtype).sum()
        for a_, b_ in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])


# ---------- the engine's step on the slot planes ----------

# rigid_update modes (csrc/rigid.cu kModeOffsets, kModeInitial, kModeFinal)
MODE_OFFSETS, MODE_INITIAL, MODE_FINAL = 0, 1, 2


def _atom_force(t: RigidTables, inv, fa, fb, flt):
    """(N, 3) flt force of each atom: (flt)(fa + fb) at its slot."""
    idx = inv[:t.body_of.shape[0]].long()
    cols = []
    for a in range(3):
        v = fa[a][idx]
        if fb is not None:
            v = v + fb[a][idx]
        cols.append(v.to(flt))
    return torch.stack(cols, -1), idx


def slot_force_torque_plain(t: RigidTables, d, inv, fa, fb=None,
                            f_out=None):
    """(F, T) per body from the slot force planes fa (+ fb), read through
    inv (the (N + 1,) atom -> slot map); with f_out (three flt slot
    planes) the atoms' flt forces are stored there."""
    f, idx = _atom_force(t, inv, fa, fb, d.dtype)
    if f_out is not None:
        for a in range(3):
            f_out[a][idx] = f[:, a]
    return force_torque(t, d, f)


def slot_force_torque(t: RigidTables, d, inv, fa, fb=None, f_out=None,
                      width: Optional[int] = None):
    """K15a on CUDA tensors (``ops.rigid.force_torque``), the plain
    version on CPU ones.  width: lanes per body of the kernel (a power of
    two; default the smallest that holds the largest body, at most 32)."""
    if d.is_cuda:
        from ..ops import rigid as rigid_ops

        return rigid_ops.force_torque(t, d, inv, fa, fb, f_out, width)
    return slot_force_torque_plain(t, d, inv, fa, fb, f_out)


def rigid_update_plain(t: RigidTables, bs: BodyState, d, inv, planes, off,
                       F, T, dtv: float, dtf: float, mode: int):
    """K15b's plain version, in place.  MODE_OFFSETS: d = A(q) r_body and
    off = planes - (X + d) at the atoms' slots (planes: x, y, z).
    MODE_INITIAL: the half kick of V and L by (F, T), the drift of X, the
    Richardson rotation of q, then d and the slot positions planes = (X +
    d) + off.  MODE_FINAL: the half kick; with planes (vx, vy, vz) the
    slot velocities V + omega x d."""
    idx = inv[:t.body_of.shape[0]].long()
    if mode == MODE_INITIAL:
        new = initial_integrate_rigid_ft(t, bs, F, T, dtv, dtf)
    elif mode == MODE_FINAL:
        new = final_integrate_rigid_ft(t, bs, F, T, dtf)
    elif mode == MODE_OFFSETS:
        new = bs
    else:
        raise ValueError(f"unknown rigid_update mode {mode}")
    for old, val in zip(bs, new):
        if val is not old:
            old.copy_(val)
    if mode == MODE_FINAL:
        if planes is not None:
            v = atom_velocities(t, bs, d)
            for a in range(3):
                planes[a][idx] = v[:, a]
        return
    xa, dn = atom_positions(t, bs)
    d.copy_(dn)
    for a in range(3):
        if mode == MODE_OFFSETS:
            off[a][idx] = planes[a][idx] - xa[:, a]
        else:
            planes[a][idx] = xa[:, a] + off[a][idx]


def rigid_update(t: RigidTables, bs: BodyState, d, inv, planes, off, F, T,
                 dtv: float, dtf: float, mode: int,
                 width: Optional[int] = None):
    """K15b on CUDA tensors (``ops.rigid.update``), the plain version on
    CPU ones; see ``rigid_update_plain``."""
    if d.is_cuda:
        from ..ops import rigid as rigid_ops

        return rigid_ops.update(t, bs, d, inv, planes, off, F, T, dtv, dtf,
                                mode, width)
    return rigid_update_plain(t, bs, d, inv, planes, off, F, T, dtv, dtf,
                              mode)


def slot_constraint_virial_plain(t: RigidTables, bs: BodyState, d, inv, fa,
                                 fb, T, ftm2v: float, acc_dtype):
    """K15c's plain version: ``constraint_virial`` with the atoms' forces
    (flt)(fa + fb) read from the slot planes and the body torque T of
    ``slot_force_torque``."""
    f, _ = _atom_force(t, inv, fa, fb, d.dtype)
    bo = t.body_of
    Lb = quat_rotate_inv(bs.q, bs.L)
    wb = t.iinv * Lb
    wdotb = t.iinv * (ftm2v * quat_rotate_inv(bs.q, T) - _cross(wb, Lb))
    alpha = quat_rotate(bs.q, wdotb)
    om = quat_rotate(bs.q, wb)
    omi, ali = om[bo], alpha[bo]
    a = _cross(ali, d) + _cross(omi, _cross(omi, d))
    fc = (t.mass[:, None] / ftm2v) * a - f
    return torch.stack([
        (d[:, a_] * fc[:, b_]).to(acc_dtype).sum()
        for a_, b_ in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])


def slot_constraint_virial(t: RigidTables, bs: BodyState, d, inv, fa, fb,
                           T, ftm2v: float, acc_dtype,
                           width: Optional[int] = None):
    """K15c on CUDA tensors (``ops.rigid.virial``), the plain version on
    CPU ones."""
    if d.is_cuda:
        from ..ops import rigid as rigid_ops

        return rigid_ops.virial(t, bs, d, inv, fa, fb, T, ftm2v, acc_dtype,
                                width)
    return slot_constraint_virial_plain(t, bs, d, inv, fa, fb, T, ftm2v,
                                        acc_dtype)
