"""The reciprocal part of the Ewald sum of the r^-6 dispersion energy
E = -sum_{i<j} C_ij / r^6, converged far past the deck's accuracy, by
smooth particle-mesh Ewald (Essmann et al., J. Chem. Phys. 103, 8577
(1995), whose smooth PME covers the r^-6 sum; in 't Veld, Ismail and
Grest, J. Chem. Phys. 127, 144711 (2007)) on a mesh finer than the deck's.

The real-space part, -C_ij exp(-a^2) (1 + a^2 + a^4 / 2) / r^6 with
a = b r, is the pair style's (``reference.pair``).  What is left is

    E_rec = 1 / (2V) sum_{m != 0} w(k) sum_ts C_ts S_t(m) S_s(-m) B(m)
    w(k)  = -(pi^(3/2) b^3 / 3) f(t),  t = k / (2 b),  k = 2 pi |m|,
    f(t)  = (1 - 2 t^2) exp(-t^2) + 2 sqrt(pi) t^3 erfc(t)

with S_t the structure factor of the atoms of type t (their unit weights
spread by cardinal B-splines of order ``order``), C_ts the deck's C6 type
matrix and B the Euler spline factors; one mesh per type, combined
through C, whatever channels a program splits C into.  The k = 0 term
w(0) / (2V) sum_ts C_ts N_t N_s and the self term b^6 / 12 sum_i C_ii
complete the energy.  The forces are the gradient of E_rec through the
splines; the virial trace is sum_m E(m) (3 + t f'(t) / f(t)) plus three
times the k = 0 term (the self term does not depend on the box).  With a
lower precision than f32 the FFTs run in f32 and their results are
rounded back, as in ``reference.ewald``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import ewald


def g6(tail: float, cut: float) -> float:
    """The splitting b of the r^-6 sum from the deck's ``force_disp_real``
    as this repository defines it: the damped real-space tail kept at the
    cutoff, relative to the bare 1 / rc^6, (1 + u^2 + u^4 / 2) exp(-u^2)
    = tail with u = b rc.  (Not LAMMPS' ``lj_rspace_error`` estimate,
    which reads the key as an absolute force.)  The left side falls from
    1 at u = 0, so the root is bracketed and bisected to the last bit."""
    def kept(u):
        return (1.0 + u * u + u ** 4 / 2.0) * math.exp(-u * u)

    lo, hi = 0.0, 1.0
    while kept(hi) > tail:
        hi *= 2.0
    while True:
        mid = 0.5 * (lo + hi)
        if mid in (lo, hi):
            return hi / cut
        if kept(mid) > tail:
            lo = mid
        else:
            hi = mid


def kernel(t: torch.Tensor) -> torch.Tensor:
    """f(t) = (1 - 2 t^2) exp(-t^2) + 2 sqrt(pi) t^3 erfc(t)."""
    return (1.0 - 2.0 * t * t) * torch.exp(-t * t) \
        + 2.0 * math.sqrt(math.pi) * t ** 3 * torch.special.erfc(t)


def kernel_slope(t: torch.Tensor) -> torch.Tensor:
    """f'(t) = -6 t exp(-t^2) + 6 sqrt(pi) t^2 erfc(t)."""
    return -6.0 * t * torch.exp(-t * t) \
        + 6.0 * math.sqrt(math.pi) * t * t * torch.special.erfc(t)


def compute(x: torch.Tensor, typ: torch.Tensor, C6, L, beta: float,
            order: int = 10, mesh=None, chunk: int = 16384):
    """(forces (N, 3), energy, virial trace) of the reciprocal r^-6 sum
    with its k = 0 and self terms, in x's dtype.  typ: (N,) 0-based types;
    C6: (T, T) the deck's dispersion coefficients (energy x length^6)."""
    dt, dev, n = x.dtype, x.device, len(x)
    low = dt not in (torch.float32, torch.float64)
    fdt = torch.float32 if low else dt
    C6 = np.asarray(C6, np.float64)
    T = len(C6)
    K = mesh or ewald.mesh_for(np.asarray(L), beta)
    M = int(np.prod(K))
    V = float(np.prod(np.asarray(L, np.float64)))
    # one mesh per type: type t's atoms spread onto points t M .. t M + M - 1
    stencil = ewald.stencil_of(x, L, K, order, offset=typ * M)
    ones = torch.ones(n, dtype=dt, device=dev)
    Q = ewald.spread(stencil, ones, T * M, chunk, fdt)
    Q = Q.reshape(T, *K).to(dt).to(fdt)
    _, m2, Bm, sym = ewald.half_spectrum(K, L, order, dev)
    t = math.pi * torch.sqrt(m2) / beta
    f = kernel(t)
    wk = -(math.pi ** 1.5 * beta ** 3 / 3.0) * f
    C = torch.where(m2 == 0, torch.zeros_like(wk), wk / V) * Bm
    FQ = torch.fft.rfftn(Q, dim=(1, 2, 3))
    Ct = torch.as_tensor(C6, device=dev)
    chi = torch.einsum("ts,s...->t...", Ct.to(FQ.dtype), FQ)
    p2 = (FQ.real.to(torch.float64) * chi.real.to(torch.float64)
          + FQ.imag.to(torch.float64) * chi.imag.to(torch.float64)).sum(0)
    Em = 0.5 * C * p2 * sym
    e_rec = float(Em.sum())
    ratio = torch.where(f > 0, t * kernel_slope(t) / torch.where(
        f > 0, f, torch.ones_like(f)), torch.zeros_like(f))
    vir = float((Em * (3.0 + ratio)).sum())
    phi = torch.fft.irfftn(chi * C.to(fdt), s=K, dim=(1, 2, 3)) * float(M)
    force = ewald.gather(stencil, phi.to(dt).reshape(-1), ones, K, L, order,
                         chunk)
    counts = np.bincount(typ.cpu().numpy(), minlength=T).astype(np.float64)
    w0 = -(math.pi ** 1.5 * beta ** 3 / 3.0)
    e0 = w0 / (2.0 * V) * float(counts @ C6 @ counts)
    e_self = beta ** 6 / 12.0 * float(np.diag(C6) @ counts)
    return force, e_rec + e0 + e_self, vir + 3.0 * e0
