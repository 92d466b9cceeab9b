"""The reciprocal part of the Ewald sum, converged far past the deck's
PPPM accuracy, by smooth particle-mesh Ewald (Essmann et al., J. Chem.
Phys. 103, 8577 (1995)) on a mesh finer than the deck's.

E_rec = 1 / (2 pi V) sum_{m != 0} exp(-pi^2 m^2 / g^2) / m^2 B(m) |F(Q)(m)|^2
with m = (m1/L1, m2/L2, m3/L3), Q the charges spread by cardinal B-splines
of order ``order`` and B the Euler spline factors.  The forces are the
gradient of E_rec through the splines; the virial trace is
sum_m E(m) (1 - 2 pi^2 m^2 / g^2).  The self energy -g / sqrt(pi) sum q^2
and, for a charged box, -pi Q^2 / (2 g^2 V) are added to the energy, all
times qqrd2e, as LAMMPS' PPPM reports them.  g is the splitting the
deck's ``kspace_style pppm`` accuracy gives (LAMMPS' closed form for the
real-space error).  With a lower precision than f32 the FFTs run in f32
and their results are rounded back.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def g_ewald(accuracy_rel: float, cutoff: float, q, volume: float,
            qqrd2e: float) -> float:
    """LAMMPS pppm.cpp: g from the real-space RMS force error
    2 q2 sqrt(1 / (N rc V)) exp(-g^2 rc^2) = accuracy, where accuracy is
    accuracy_rel times the force between two unit charges one distance
    unit apart, and q2 = sum q^2 qqrd2e."""
    q = np.asarray(q, np.float64)
    acc = accuracy_rel * qqrd2e
    q2 = float((q * q).sum()) * qqrd2e
    arg = acc * math.sqrt(len(q) * cutoff * volume) / (2.0 * q2)
    if arg >= 1.0:
        return (1.35 - 0.15 * math.log(acc)) / cutoff
    return math.sqrt(-math.log(arg)) / cutoff


def _good(n: int) -> int:
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def mesh_for(L, g: float, hg: float = 0.15) -> tuple:
    """Mesh points per axis for a spacing h with h g <= hg."""
    return tuple(_good(max(8, int(math.ceil(float(Lk) * g / hg))))
                 for Lk in L)


def bspline(w: torch.Tensor, order: int):
    """(M_p(w + j), M_p'(w + j)) for j = 0..p-1, each (N, p): the cardinal
    B-spline of order p by its two-term recursion."""
    M = torch.stack([w, 1.0 - w], -1)
    prev = M
    for k in range(3, order + 1):
        y = w[:, None] + torch.arange(k, dtype=w.dtype, device=w.device)
        a = torch.cat([M, torch.zeros_like(M[:, :1])], -1)      # M_{k-1}(y)
        b = torch.cat([torch.zeros_like(M[:, :1]), M], -1)      # M_{k-1}(y-1)
        prev = M
        M = (y * a + (k - y) * b) / (k - 1)
    a = torch.cat([prev, torch.zeros_like(prev[:, :1])], -1)
    b = torch.cat([torch.zeros_like(prev[:, :1]), prev], -1)
    return M, a - b


def _bfactor(K: int, order: int) -> np.ndarray:
    """|b(m)|^2 of the Euler exponential spline, m = 0..K-1."""
    w = np.zeros(1)
    Mk = bspline(torch.as_tensor(w, dtype=torch.float64), order)[0][0]
    Mk = Mk.numpy()                      # M_p(j), j = 0..p-1
    m = np.arange(K)
    k = np.arange(order - 1)
    den = (Mk[k + 1][None, :] * np.exp(
        2j * np.pi * m[:, None] * k[None, :] / K)).sum(1)
    return 1.0 / np.abs(den) ** 2


def stencil_of(x: torch.Tensor, L, K, order: int, offset=None):
    """``stencil(s)``: for the atoms in slice s, the spline weights and
    their derivatives per axis ((n, order) each, in x's dtype) and the flat
    indices (n, order^3) of the points they reach on a K mesh of the box
    L, each atom's shifted by ``offset`` (N,) where given."""
    dev = x.device
    Lt = torch.as_tensor(np.asarray(L, np.float64), dtype=torch.float64,
                         device=dev)
    Kt = torch.as_tensor(K, device=dev)
    # fractional mesh coordinates; the spline weights in the working dtype
    u = (x.to(torch.float64) / Lt) % 1.0 * Kt
    base = torch.floor(u).long()
    w = (u - base).to(x.dtype)
    j = torch.arange(order, device=dev)

    def stencil(s):
        wx, dx = bspline(w[s, 0], order)
        wy, dy = bspline(w[s, 1], order)
        wz, dz = bspline(w[s, 2], order)
        gx = (base[s, 0:1] - j) % K[0]
        gy = (base[s, 1:2] - j) % K[1]
        gz = (base[s, 2:3] - j) % K[2]
        idx = ((gx[:, :, None, None] * K[1] + gy[:, None, :, None]) * K[2]
               + gz[:, None, None, :]).reshape(len(gx), -1)
        if offset is not None:
            idx = idx + offset[s, None]
        return (wx, wy, wz), (dx, dy, dz), idx

    return stencil


def spread(stencil, a: torch.Tensor, size: int, chunk: int, fdt):
    """The atoms' weights a (N,) spread by their splines onto a flat mesh
    of ``size`` points, summed in fdt."""
    Q = torch.zeros(size, dtype=fdt, device=a.device)
    for s0 in range(0, len(a), chunk):
        s = slice(s0, min(len(a), s0 + chunk))
        (wx, wy, wz), _, idx = stencil(s)
        val = (a[s, None, None, None] * wx[:, :, None, None]
               * wy[:, None, :, None] * wz[:, None, None, :])
        Q.index_add_(0, idx.reshape(-1), val.reshape(-1).to(fdt))
    return Q


def half_spectrum(K, L, order: int, dev):
    """On the half spectrum of a K mesh of the box L: m per axis (in
    inverse length), m^2, the Euler spline factors B(m) and each m_z
    plane's weight (2 where the half spectrum holds m for m and -m)."""
    mx = torch.fft.fftfreq(K[0], d=1.0 / K[0], device=dev,
                           dtype=torch.float64) / float(L[0])
    my = torch.fft.fftfreq(K[1], d=1.0 / K[1], device=dev,
                           dtype=torch.float64) / float(L[1])
    mz = torch.arange(K[2] // 2 + 1, device=dev,
                      dtype=torch.float64) / float(L[2])
    m2 = mx[:, None, None] ** 2 + my[None, :, None] ** 2 \
        + mz[None, None, :] ** 2
    B = [torch.as_tensor(_bfactor(k, order), device=dev) for k in K]
    Bm = B[0][:, None, None] * B[1][None, :, None] \
        * B[2][None, None, :K[2] // 2 + 1]
    sym = torch.full((K[2] // 2 + 1,), 2.0, dtype=torch.float64, device=dev)
    sym[0] = 1.0
    if K[2] % 2 == 0:
        sym[-1] = 1.0
    return (mx, my, mz), m2, Bm, sym


def gather(stencil, phi: torch.Tensor, a: torch.Tensor, K, L, order: int,
           chunk: int) -> torch.Tensor:
    """-a_i times the gradient of the flat mesh potential phi, on a K mesh
    of the box L, at each atom: (N, 3) in phi's dtype."""
    n, dev = len(a), phi.device
    scale = (torch.as_tensor(K, device=dev) / torch.as_tensor(
        np.asarray(L, np.float64), dtype=torch.float64,
        device=dev)).to(phi.dtype)
    f = torch.empty((n, 3), dtype=phi.dtype, device=dev)
    for s0 in range(0, n, chunk):
        s = slice(s0, min(n, s0 + chunk))
        (wx, wy, wz), (dx, dy, dz), idx = stencil(s)
        ph = phi[idx].reshape(-1, order, order, order)
        fx = (dx[:, :, None, None] * wy[:, None, :, None]
              * wz[:, None, None, :] * ph).sum((1, 2, 3))
        fy = (wx[:, :, None, None] * dy[:, None, :, None]
              * wz[:, None, None, :] * ph).sum((1, 2, 3))
        fz = (wx[:, :, None, None] * wy[:, None, :, None]
              * dz[:, None, None, :] * ph).sum((1, 2, 3))
        f[s] = -a[s, None] * torch.stack([fx, fy, fz], -1) * scale
    return f


def compute(x: torch.Tensor, q: torch.Tensor, L, g: float, qqrd2e: float,
            order: int = 10, mesh=None, chunk: int = 16384,
            peratom: bool = False):
    """(forces (N, 3), energy, virial trace) of the reciprocal Ewald sum
    with the self and charged-box energies, in x's dtype; with
    ``peratom`` also each atom's energy (N,) and virial (N, 6: xx, yy, zz,
    xy, xz, yz): q_i / 2 times the potential, or the potential of the
    virial kernels E(m) [delta_ab - 2 (1 + pi^2 m^2 / g^2) m_a m_b / m^2],
    at the atom, less its self and charged-box share (LAMMPS' PPPM
    eatom and vatom)."""
    dt, dev, n = x.dtype, x.device, len(x)
    low = dt not in (torch.float32, torch.float64)
    fdt = torch.float32 if low else dt
    K = mesh or mesh_for(np.asarray(L), g)
    V = float(np.prod(np.asarray(L, np.float64)))
    stencil = stencil_of(x, L, K, order)
    Q = spread(stencil, q, int(np.prod(K)), chunk, fdt)
    Q = Q.reshape(K).to(dt).to(fdt)
    # C(m) B(m) on the half spectrum
    ms, m2, Bm, sym = half_spectrum(K, L, order, dev)
    safe = torch.where(m2 == 0, torch.ones_like(m2), m2)
    C = torch.exp(-math.pi ** 2 * safe / g ** 2) / (math.pi * V * safe)
    C = torch.where(m2 == 0, torch.zeros_like(C), C) * Bm
    FQ = torch.fft.rfftn(Q)
    p2 = FQ.real.to(torch.float64) ** 2 + FQ.imag.to(torch.float64) ** 2
    Em = 0.5 * C * p2 * sym
    e_rec = float(Em.sum())
    vir = float((Em * (1.0 - 2.0 * math.pi ** 2 * m2 / g ** 2)).sum())
    phi = torch.fft.irfftn(FQ * C.to(fdt), s=K) * float(np.prod(K))
    phi = phi.to(dt).reshape(-1)
    f = gather(stencil, phi, q, K, L, order, chunk)
    qd = q.to(torch.float64)
    e_self = -g / math.sqrt(math.pi) * float((qd * qd).sum())
    e_charged = -math.pi * float(qd.sum()) ** 2 / (2.0 * g * g * V)
    e = (e_rec + e_self + e_charged) * qqrd2e
    if not peratom:
        return f * qqrd2e, e, vir * qqrd2e
    ms = (ms[0][:, None, None], ms[1][None, :, None], ms[2][None, None, :])
    kern = 2.0 * (1.0 + math.pi ** 2 * m2 / g ** 2) / safe
    meshes = [phi]
    for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)):
        vg = (float(a == b) - kern * ms[a] * ms[b]) * C
        meshes.append((torch.fft.irfftn(FQ * vg.to(fdt), s=K)
                       * float(np.prod(K))).to(dt).reshape(-1))
    out = torch.empty((n, 7), dtype=dt, device=dev)
    for s0 in range(0, n, chunk):
        s = slice(s0, min(n, s0 + chunk))
        (wx, wy, wz), _, idx = stencil(s)
        w3 = (wx[:, :, None, None] * wy[:, None, :, None]
              * wz[:, None, None, :]).reshape(len(wx), -1)
        out[s] = torch.stack([(w3 * m[idx]).sum(1) for m in meshes], -1) \
            * (0.5 * q[s, None])
    eatom = out[:, 0] - (g / math.sqrt(math.pi) * q * q
                         + math.pi / 2.0 * q * float(qd.sum()) / (g * g * V))
    return (f * qqrd2e, e, vir * qqrd2e, eatom * qqrd2e,
            out[:, 1:] * qqrd2e)
