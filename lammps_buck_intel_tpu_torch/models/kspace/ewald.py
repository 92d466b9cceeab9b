"""Plain Ewald sum on a static orthogonal box (``kspace_style ewald``).

Counterpart of ``lammps_buck_intel_tpu.models.kspace.ewald`` (``Ewald``,
``setup_ewald``, ``_ewald_compute`` with ``sk_force_energy_virial``).  The
set-up is the JAX package's host numpy line for line: the per-axis kmax
from Petersen's error estimate on the face widths, the k sphere
|k|^2 <= gsqmx * 1.00001, the m triples in the same order, and
ug = (2 pi / V) exp(-k^2 / 4 g^2) / k^2, so the k set and ug are the
JAX package's to the bit in f64.

``Ewald.compute(x, q, eflag, vflag)`` (the neighbor-list ``Simulation``'s
k-space term, every step) takes (3, N) position planes.  On CUDA planes it
launches csrc/ewald.cu (``ops.ewald``): K11a ``ewald_sk`` forms the
structure factors S(k) = sum_i q_i exp(i k.x_i), the energy and the
virial; K11b ``ewald_force`` the forces from them, recomputing the
phases instead of keeping (N, K) arrays.  On CPU planes it runs
``ewald_compute_plain``, the JAX ``_ewald_compute`` as written ((N, K)
phase, cos and sin, torch.matmul contractions, sums in acc) over chunks
of k vectors.

``ewald_compute_peratom(ew, x, q)`` (compute pe/atom and stress/atom, at
dump cadence) gives each atom its share of the energy and the 6-virial:
S(k) from K11a, then per atom share_k = cos_ik Re_k + sin_ik Im_k
contracted against ug_k and the six ug_k vfac_c(k) (K11pa
``ewald_peratom``); on CPU planes ``ewald_compute_peratom_plain``.  The
traced-box form (``_ewald_compute_traced``, fix npt) is ROADMAP queue 1
items 10 / 14.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ...core.box import Box
from .base import rms_kspace_ewald, solve_g_ewald, two_charge_force
from .pppm import KSpaceResult

# (N, K) elements per chunk of the plain version: bounds its temporaries
_CHUNK_ELEMS = 1 << 25


@dataclasses.dataclass
class Ewald:
    """Configured Ewald solver for a fixed box and charge set (host
    numpy), with the device constants of the kernels cached per (device,
    flt).

    kvecs: (K, 3) wave vectors (the full +/- space, k != 0); ug: (K,)
    energy prefactors; mvecs: (K, 3) the integer triples behind kvecs."""

    g_ewald: float
    kvecs: np.ndarray
    ug: np.ndarray
    qsum: float
    qsqsum: float
    qqrd2e: float
    volume: float
    kmax: tuple[int, int, int]
    acc_dtype: torch.dtype = torch.float32
    mvecs: Optional[np.ndarray] = None
    _consts: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def elong_self(self) -> float:
        """Self + neutralizing-background energy corrections."""
        g = self.g_ewald
        e = -g * self.qsqsum / math.sqrt(math.pi)
        e -= math.pi / 2.0 * self.qsum**2 / (g * g * self.volume)
        return e * self.qqrd2e

    def consts(self, device, flt) -> dict:
        """Device constants, uploaded once per (device, flt): kv (K, 3)
        and its (3, K) rows and ug in flt (the phases and the force
        weights), ug in acc and the six virial factors vfac (6, K) in acc,
        1 - pref k_a k_b on the diagonal and -pref k_a k_b off it with
        pref = 2 (1/k^2 + 1/(4 g^2)), the JAX expressions in acc."""
        key = (torch.device(device), flt)
        c = self._consts.get(key)
        if c is not None:
            return c
        acc = self.acc_dtype

        def up(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device, dt)

        kv = up(self.kvecs, flt)
        ka = up(self.kvecs, acc)
        kx, ky, kz = ka[:, 0], ka[:, 1], ka[:, 2]
        ksq = kx * kx + ky * ky + kz * kz
        pref = 2.0 * (1.0 / ksq + 0.25 / self.g_ewald**2)
        vfac = torch.stack([1.0 - pref * kx * kx, 1.0 - pref * ky * ky,
                            1.0 - pref * kz * kz, -pref * kx * ky,
                            -pref * kx * kz, -pref * ky * kz]).contiguous()
        ug = up(self.ug, flt)
        c = dict(kv=kv, kv_rows=kv.t().contiguous(), ug=ug,
                 ug_acc=up(self.ug, acc), vfac=vfac,
                 # the per-atom contraction weights (7, K) in flt: ug and
                 # the six ug vfac_c
                 peratom_w=torch.cat([ug[None, :],
                                      ug[None, :] * vfac.to(flt)]))
        self._consts[key] = c
        return c

    def compute(self, x: torch.Tensor, q: torch.Tensor, eflag: bool = True,
                vflag: bool = True) -> KSpaceResult:
        """Forces (acc planes), elong (with the self and background terms)
        and the 6-virial of the charges q (N,) at the (3, N) positions x:
        the kernels on CUDA planes, ``ewald_compute_plain`` on CPU planes.
        Without eflag elong is 0, without vflag the virial."""
        if x.is_cuda:
            return ewald_compute_kernels(self, x, q, eflag, vflag)
        if x.device.type != "cpu":
            raise RuntimeError(
                f"no kernel and no plain version for device {x.device}")
        return ewald_compute_plain(self, x, q, eflag, vflag)


def setup_ewald(box: Box, q, cutoff: float, accuracy_rel: float,
                qqrd2e: float, g_ewald: Optional[float] = None,
                acc_dtype: torch.dtype = torch.float32) -> Ewald:
    """The JAX ``setup_ewald`` (host numpy, f64): g_ewald from the
    real-space error unless given, kmax per axis from Petersen's estimate
    on the face widths, then every m triple in [-kmax, kmax]^3 but 0
    (nx slowest, nz fastest) whose |k|^2 <= gsqmx."""
    if box.is_triclinic:
        raise NotImplementedError(
            "triclinic Ewald is not ported: ROADMAP queue 1 item 14")
    q = np.asarray(q, np.float64)
    natoms = len(q)
    qsum = float(q.sum())
    qsqsum = float((q * q).sum())
    volume = box.volume
    recip = 2.0 * math.pi * box.h_inv.T
    W = np.asarray(box.perp_widths, np.float64)
    q2 = qsqsum * qqrd2e
    accuracy = accuracy_rel * two_charge_force(qqrd2e)
    if g_ewald is None:
        g_ewald = solve_g_ewald(accuracy, cutoff, natoms, volume, q2)

    kmax = []
    for ax in range(3):
        km = 1
        while rms_kspace_ewald(km, W[ax], natoms, g_ewald, q2) > accuracy:
            km += 1
            if km > 200:
                raise RuntimeError("ewald kmax blew up; check accuracy/box")
        kmax.append(km)
    kxm, kym, kzm = kmax

    gsqmx = max(
        (2 * math.pi * kxm / W[0]) ** 2,
        (2 * math.pi * kym / W[1]) ** 2,
        (2 * math.pi * kzm / W[2]) ** 2,
    ) * 1.00001

    ks = []
    ms = []
    for nx in range(-kxm, kxm + 1):
        for ny in range(-kym, kym + 1):
            for nz in range(-kzm, kzm + 1):
                if nx == ny == nz == 0:
                    continue
                k = recip @ np.array([nx, ny, nz], np.float64)
                if float(k @ k) <= gsqmx:
                    ks.append(k)
                    ms.append((nx, ny, nz))
    kvecs = np.asarray(ks)
    mvecs = np.asarray(ms, np.int32)
    ksq = np.sum(kvecs**2, axis=1)
    ug = (2.0 * math.pi / volume) * np.exp(-ksq / (4.0 * g_ewald**2)) / ksq

    return Ewald(
        g_ewald=float(g_ewald), kvecs=kvecs, ug=ug, qsum=qsum,
        qsqsum=qsqsum, qqrd2e=qqrd2e, volume=volume,
        kmax=(kxm, kym, kzm), acc_dtype=acc_dtype, mvecs=mvecs)


def _energy_virial(ew: Ewald, c: dict, s_re, s_im, eflag: bool,
                   vflag: bool, dev):
    """elong and the 6-virial from the completed structure factors (acc),
    the JAX ``sk_force_energy_virial`` expressions."""
    acc = ew.acc_dtype
    sk2 = s_re * s_re + s_im * s_im
    if eflag:
        elong = (c["ug_acc"] * sk2).sum() * ew.qqrd2e + ew.elong_self
    else:
        elong = torch.zeros((), dtype=acc, device=dev)
    if vflag:
        uk = c["ug_acc"] * sk2 * float(ew.qqrd2e)
        virial = (uk[None, :] * c["vfac"]).sum(1)
    else:
        virial = torch.zeros(6, dtype=acc, device=dev)
    return elong, virial


def ewald_compute_plain(ew: Ewald, x: torch.Tensor, q: torch.Tensor,
                        eflag: bool = True,
                        vflag: bool = True) -> KSpaceResult:
    """The JAX ``_ewald_compute`` in torch ops, any device: per chunk of k
    vectors phase = x kv^T, cos and sin (N, Kc), S(k) = q . cos / q . sin
    in acc, and the force contraction sum_k (s Re - c Im) 2 ug k as the
    two matrix products s @ (2 ug Re k) - c @ (2 ug Im k) in x's dtype (the
    JAX package's (s Re - c Im) 2 ug @ kv, reassociated); then f = qqrd2e
    q f cast to acc, and elong and the virial from S(k)."""
    flt, acc, dev = x.dtype, ew.acc_dtype, x.device
    n = x.shape[1]
    c = ew.consts(dev, flt)
    kv, ug = c["kv"], c["ug"]
    K = kv.shape[0]
    xa = x.t()
    qa = q.to(acc)
    s_re = torch.empty(K, dtype=acc, device=dev)
    s_im = torch.empty(K, dtype=acc, device=dev)
    f = torch.zeros((n, 3), dtype=flt, device=dev)
    chunk = max(1, _CHUNK_ELEMS // max(n, 1))
    for k0 in range(0, K, chunk):
        k1 = min(K, k0 + chunk)
        kc = kv[k0:k1]
        phase = xa @ kc.t()
        cs, sn = torch.cos(phase), torch.sin(phase)
        re, im = qa @ cs.to(acc), qa @ sn.to(acc)
        s_re[k0:k1], s_im[k0:k1] = re, im
        w = 2.0 * ug[k0:k1, None] * kc
        f += sn @ (re.to(flt)[:, None] * w) - cs @ (im.to(flt)[:, None] * w)
    f = (float(ew.qqrd2e) * q[:, None] * f).to(acc)
    elong, virial = _energy_virial(ew, c, s_re, s_im, eflag, vflag, dev)
    return KSpaceResult(f=tuple(f.t().contiguous().unbind(0)), elong=elong,
                        virial=virial)


def ewald_compute_kernels(ew: Ewald, x: torch.Tensor, q: torch.Tensor,
                          eflag: bool = True,
                          vflag: bool = True) -> KSpaceResult:
    """``compute`` on the card: K11a (S(k), energy and virial sums) then
    K11b (forces) of csrc/ewald.cu."""
    from ...ops import ewald as ewald_ops

    c = ew.consts(x.device, x.dtype)
    xs = tuple(x.unbind(0))
    sk = ewald_ops.ewald_sk(xs, q, c, ew.qqrd2e, ew.acc_dtype)
    f = ewald_ops.ewald_force(xs, q, c, sk.wre, sk.wim, ew.qqrd2e,
                              ew.acc_dtype)
    zero = torch.zeros((), dtype=ew.acc_dtype, device=x.device)
    elong = sk.sums[0] * ew.qqrd2e + ew.elong_self if eflag else zero
    virial = (sk.sums[1:7] if vflag
              else torch.zeros(6, dtype=ew.acc_dtype, device=x.device))
    return KSpaceResult(f=f, elong=elong, virial=virial)


def _self_terms(ew: Ewald, qa: torch.Tensor) -> torch.Tensor:
    """Per-atom self and background terms, g / sqrt(pi) q^2 + pi / (2 g^2
    V) q qsum (before qqrd2e)."""
    g, V = ew.g_ewald, float(ew.volume)
    return (g / math.sqrt(math.pi) * qa * qa
            + math.pi / (2.0 * g * g * V) * qa * ew.qsum)


def ewald_compute_peratom_plain(ew: Ewald, x: torch.Tensor,
                                q: torch.Tensor):
    """The JAX ``ewald_compute_peratom`` in torch ops, any device, over
    chunks of k vectors: S(k) in acc (one pass), then per atom share =
    cos Re + sin Im (Re, Im rounded to x's dtype, as the JAX package rounds
    them) contracted against ug and the six ug vfac_c in x's dtype, the
    sums in acc."""
    flt, acc, dev = x.dtype, ew.acc_dtype, x.device
    n = x.shape[1]
    c = ew.consts(dev, flt)
    kv, w = c["kv"], c["peratom_w"]
    K = kv.shape[0]
    xa = x.t()
    qa = q.to(acc)
    chunk = max(1, _CHUNK_ELEMS // max(n, 1))
    s_re = torch.empty(K, dtype=acc, device=dev)
    s_im = torch.empty(K, dtype=acc, device=dev)
    for k0 in range(0, K, chunk):
        k1 = min(K, k0 + chunk)
        phase = xa @ kv[k0:k1].t()
        s_re[k0:k1] = qa @ torch.cos(phase).to(acc)
        s_im[k0:k1] = qa @ torch.sin(phase).to(acc)
    re, im = s_re.to(flt), s_im.to(flt)
    sums = torch.zeros((n, 7), dtype=acc, device=dev)
    for k0 in range(0, K, chunk):
        k1 = min(K, k0 + chunk)
        phase = xa @ kv[k0:k1].t()
        share = torch.cos(phase) * re[k0:k1] + torch.sin(phase) * im[k0:k1]
        sums += (share @ w[:, k0:k1].t()).to(acc)
    qq = float(ew.qqrd2e)
    eatom = (qa * sums[:, 0] - _self_terms(ew, qa)) * qq
    vatom = (qa[:, None] * sums[:, 1:]) * qq
    return eatom, vatom


def ewald_compute_peratom(ew: Ewald, x: torch.Tensor, q: torch.Tensor):
    """Per-atom k-space energy and virial of the Ewald sum (the stock
    ewald.cpp eatom / vatom contract, the JAX ``ewald_compute_peratom``):

    eatom_i = qqrd2e [q_i sum_k ug_k share_ik - g / sqrt(pi) q_i^2
                      - pi / (2 g^2 V) q_i qsum],
    vatom_i,c = qqrd2e q_i sum_k ug_k vfac_c(k) share_ik,

    share_ik = cos(k.x_i) Re S(k) + sin(k.x_i) Im S(k), so the sums equal
    elong and the global virial.  Returns (eatom (N,), vatom (N, 6)) in
    acc; x: (3, N) planes, q (N,).  CUDA planes launch K11a (S(k)) and
    K11pa, CPU planes run ``ewald_compute_peratom_plain``."""
    if x.is_cuda:
        from ...ops import ewald as ewald_ops

        c = ew.consts(x.device, x.dtype)
        xs = tuple(x.unbind(0))
        sk = ewald_ops.ewald_sk(xs, q, c, ew.qqrd2e, ew.acc_dtype)
        g, V = ew.g_ewald, float(ew.volume)
        return ewald_ops.ewald_peratom(
            xs, q, c, sk.s_re, sk.s_im, ew.qqrd2e, ew.acc_dtype,
            g / math.sqrt(math.pi), math.pi / (2.0 * g * g * V), ew.qsum)
    if x.device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {x.device}")
    return ewald_compute_peratom_plain(ew, x, q)
