"""CHARMM bonded terms: dihedral charmm (with baked 1-4 pair terms) and
improper harmonic, in plain torch.

Counterpart of ``lammps_buck_intel_tpu.models.bonded.charmm``:
  dihedral_style charmm   E = K [1 + cos(n phi - d)]  (+ weighted 1-4 pair)
  improper_style harmonic E = K (chi - chi0)^2

The angle is LAMMPS' (dihedral_charmm.cpp, improper_harmonic.cpp): a
planar trans chain 1-2-3-4 has phi = 180 degrees, a cis chain 0.  With the
three minimum-imaged bond vectors b1 = x1 - x2, b2 = x3 - x2,
b3 = x4 - x3, n1 = b1 x b2, n2 = b2 x b3, C = n1.n2 and S = |b2| (b1.n2),
LAMMPS' normals are -n1 and n2, so its angle is phi = atan2(-S, -C).
Here the JAX package departs: it takes atan2(S, C), LAMMPS' angle plus
180 degrees.  The fixed port reproduces the JAX package's numbers when it
is given mapped coefficients, d -> d + 180 for odd n and chi0 ->
180 - chi0 (``interop.jax_torsion_coeffs``).

The JAX package differentiates the energy in the bond vectors with
``jax.grad``.  The port writes the gradient out, here and in
csrc/bonded.cu alike; the two angles differ by a constant, so
    dphi/db1 = |b2| n1 / |n1|^2,    dphi/db3 = |b2| n2 / |n2|^2,
    dphi/db2 = -[(b1.b2) dphi/db1 + (b2.b3) dphi/db3] / |b2|^2,
the last from phi's invariance under rotation and under scaling of b2.
The improper's chi is |phi|, from the same atan2, so
dchi/db = sign(sin phi) dphi/db = -sign(S) dphi/db everywhere but at a
planar improper (S = 0), the kink of |phi|, where the force is zero.  The
JAX package takes chi = arccos(cos phi clipped to +-(1 - 1e-7)) and gives
no force where the clip holds (within ~4.5e-4 rad of planar), where the
energy's slope is 2 K (180 - chi0) or 2 K chi0.  The port follows the
energy there, as the benchmark's reference does, unless an improper type
carries a third coefficient, the clip, as the mapped JAX coefficients do
(``interop.jax_torsion_coeffs``): then it takes the JAX package's chi and
clip.  The tests hold both gradients to central finite differences of the
energies, to the JAX package under the mapped coefficients, and to the
benchmark's autograd reference.

The CHARMM 1-4 terms are baked per dihedral at build time (types and
charges are static): a12 = w 4 eps14 sig14^12, a6 = w 4 eps14 sig14^6,
qq = w qqrd2e q_i q_l, evaluated on r14 = b1 - b2 - b3.  The phase d is
restricted in CHARMM files to 0/180 degrees, which makes cos(n phi - d)
independent of the sign convention of phi.
"""
from __future__ import annotations

import numpy as np
import torch


def bake_charmm_14(dihedrals, dihedral_coeffs, typ, q, eps14, sig14,
                   qqrd2e: float) -> np.ndarray:
    """Per-dihedral (Nd, 3) [a12, a6, qq] 1-4 coefficients (host numpy).

    dihedral_coeffs: (Td, 4) [K, n, d_deg, weight]; eps14/sig14: (T,)
    per-type 1-4 LJ parameters (CHARMM arithmetic mixing).  weight == 0
    rows bake to zeros (no 1-4 term)."""
    if len(dihedrals) == 0:
        return np.zeros((0, 3))
    typ, q = np.asarray(typ), np.asarray(q)
    eps14, sig14 = np.asarray(eps14), np.asarray(sig14)
    w = np.asarray(dihedral_coeffs)[dihedrals[:, 0], 3]
    ti, tl = typ[dihedrals[:, 1]], typ[dihedrals[:, 4]]
    eps = np.sqrt(eps14[ti] * eps14[tl])
    sig = 0.5 * (sig14[ti] + sig14[tl])
    s6 = sig**6
    a12 = w * 4.0 * eps * s6 * s6
    a6 = w * 4.0 * eps * s6
    qq = w * qqrd2e * q[dihedrals[:, 1]] * q[dihedrals[:, 4]]
    return np.stack([a12, a6, qq], axis=-1)


def _dot(a, b):
    return (a * b).sum(-1)


def _bond_vectors(x, L, idx):
    from .harmonic import minimg

    return (minimg(x[idx[:, 0]] - x[idx[:, 1]], L),
            minimg(x[idx[:, 2]] - x[idx[:, 1]], L),
            minimg(x[idx[:, 3]] - x[idx[:, 2]], L))


def dihedral_energy_terms(b1, b2, b3, K, mult, d_cos, a12, a6, qq):
    """Per-dihedral (edihed, e14lj, e14coul, sin(n phi)) from the bond
    vectors; ``mult`` is an integer tensor of multiplicities."""
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    b2n = torch.sqrt(torch.clamp(_dot(b2, b2), min=1e-12))
    # LAMMPS' angle: (-C, -S) of the module text
    cosval = -_dot(n1, n2)
    sinval = -_dot(torch.linalg.cross(n1, n2), b2) / b2n
    # cos(n phi), sin(n phi) by complex power of the normalised pair
    norm = torch.sqrt(torch.clamp(cosval**2 + sinval**2, min=1e-20))
    c, s = cosval / norm, sinval / norm
    cn, sn = torch.ones_like(c), torch.zeros_like(s)
    cos_n, sin_n = torch.zeros_like(c), torch.zeros_like(s)
    for k in range(1, (int(mult.max()) if len(mult) else 0) + 1):
        cn, sn = cn * c - sn * s, cn * s + sn * c
        cos_n = torch.where(mult == k, cn, cos_n)
        sin_n = torch.where(mult == k, sn, sin_n)
    edihed = K * (1.0 + cos_n * d_cos)
    r14 = b1 - b2 - b3
    rsq = torch.clamp(_dot(r14, r14), min=1e-12)
    r6inv = 1.0 / (rsq * rsq * rsq)
    e14lj = r6inv * (a12 * r6inv - a6)
    e14c = qq / torch.sqrt(rsq)
    return edihed, e14lj, e14c, sin_n


def improper_energy(b1, b2, b3, K, chi0, clip):
    """Per-improper (energy, chi - chi0, dchi/dphi): chi = |phi|, the angle
    between the planes (1,2,3) and (2,3,4), 180 degrees for a trans chain,
    E = K (chi - chi0)^2, dchi/dphi = sign(sin phi), 0 at a planar
    improper.  Where ``clip`` > 0, the JAX package's chi = arccos(cos phi
    clipped to +-(1 - clip)), and dchi/dphi = 0 where the clip holds."""
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    # LAMMPS' angle: (-C, -S) of the module text
    sinval = -torch.sqrt(_dot(b2, b2)) * _dot(b1, n2)
    cosval = -_dot(n1, n2)
    chi = torch.atan2(sinval, cosval).abs()
    side = torch.sign(sinval)
    jax = clip > 0
    if bool(jax.any()):
        nn = torch.sqrt(torch.clamp(_dot(n1, n1) * _dot(n2, n2), min=1e-20))
        craw = cosval / nn
        lo, hi = clip - 1.0, 1.0 - clip
        chi = torch.where(jax, torch.acos(torch.minimum(
            torch.maximum(craw, lo), hi)), chi)
        side = torch.where(jax & ((craw <= lo) | (craw >= hi)),
                           torch.zeros_like(side), side)
    dchi = chi - chi0
    return K * dchi * dchi, dchi, side


def phi_gradient(w, b1, b2, b3):
    """w * dphi/db_k for k = 1, 2, 3 (each (M, 3)); see the module text."""
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    b2sq = torch.clamp(_dot(b2, b2), min=1e-12)
    b2n = torch.sqrt(b2sq)
    g1 = (w * b2n / torch.clamp(_dot(n1, n1), min=1e-30))[:, None] * n1
    g3 = (w * b2n / torch.clamp(_dot(n2, n2), min=1e-30))[:, None] * n2
    g2 = (-_dot(b1, b2) / b2sq)[:, None] * g1 \
        + (-_dot(b2, b3) / b2sq)[:, None] * g3
    return g1, g2, g3


def _scatter_four(out, idx, b, g, acc_dtype):
    """f1 = -g1, f2 = g1 + g2, f3 = g3 - g2, f4 = -g3 added to ``out``;
    returns the virial -sum_k b_k (x) g_k."""
    from .harmonic import add_forces, virial6

    g1, g2, g3 = g
    add_forces(out, idx[:, 0], -g1)
    add_forces(out, idx[:, 1], g1 + g2)
    add_forces(out, idx[:, 2], g3 - g2)
    add_forces(out, idx[:, 3], -g3)
    return virial6(acc_dtype, (-b[0], g1), (-b[1], g2), (-b[2], g3))


def dihedral_charmm_forces(x, L, dihedrals, coef, mult, d14, idx, out,
                           acc_dtype=torch.float32):
    """Forces of all dihedrals added to ``out`` (three acc planes).

    x: (M, 3) positions; dihedrals: (Nd, 5) int tensor [type, atoms];
    coef: (Td, 2) [K, cos d]; mult: (Td,) multiplicities; d14: (Nd, 3) or
    None; idx: (Nd, 4) slot indices of the atoms.  Returns (edihed, e14lj,
    e14coul, virial (6,))."""
    dt = dihedrals[:, 0].long()
    K, d_cos, n_i = coef[dt, 0], coef[dt, 1], mult[dt]
    if d14 is not None:
        a12, a6, qq = d14[:, 0], d14[:, 1], d14[:, 2]
    else:
        a12 = a6 = qq = torch.zeros_like(K)
    b1, b2, b3 = _bond_vectors(x, L, idx)
    ed, elj, ec, sin_n = dihedral_energy_terms(b1, b2, b3, K, n_i, d_cos,
                                               a12, a6, qq)
    dedphi = -K * n_i.to(K.dtype) * sin_n * d_cos
    g1, g2, g3 = phi_gradient(dedphi, b1, b2, b3)
    # 1-4 pair on r14 = b1 - b2 - b3: dE/dr14 = -fpair r14
    r14 = b1 - b2 - b3
    rsq = torch.clamp(_dot(r14, r14), min=1e-12)
    r6inv = 1.0 / (rsq * rsq * rsq)
    fpair = (r6inv * (12.0 * a12 * r6inv - 6.0 * a6) + ec) / rsq
    f14 = fpair[:, None] * r14
    g1, g2, g3 = g1 - f14, g2 + f14, g3 + f14
    virial = _scatter_four(out, idx, (b1, b2, b3), (g1, g2, g3), acc_dtype)
    return (ed.to(acc_dtype).sum(), elj.to(acc_dtype).sum(),
            ec.to(acc_dtype).sum(), virial)


def improper_harmonic_forces(x, L, impropers, coef, idx, out,
                             acc_dtype=torch.float32):
    """Forces of all harmonic impropers added to ``out``; coef: (Ti, 3)
    [K, chi0 rad, clip].  Returns (eimp, virial (6,))."""
    it = impropers[:, 0].long()
    K, chi0, clip = coef[it, 0], coef[it, 1], coef[it, 2]
    b1, b2, b3 = _bond_vectors(x, L, idx)
    e, dchi, side = improper_energy(b1, b2, b3, K, chi0, clip)
    g = phi_gradient(2.0 * K * dchi * side, b1, b2, b3)
    virial = _scatter_four(out, idx, (b1, b2, b3), g, acc_dtype)
    return e.to(acc_dtype).sum(), virial
