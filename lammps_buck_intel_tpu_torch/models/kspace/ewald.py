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
``ewald_peratom``); on CPU planes ``ewald_compute_peratom_plain``.

``Ewald.compute_traced(x, q, boxL, ...)`` (fix npt, every step) is the
variable-cell form (the JAX ``_ewald_compute_traced``): the m triples stay
those of the set-up, and k = 2 pi m / L, ug and the virial factors follow
the box lengths boxL on the card.  On CUDA planes K11 traced
(``ops.ewald.ewald_traced``) builds those tables and K11a / K11b run on
them unchanged; on CPU planes ``ewald_compute_traced_plain`` follows the
JAX expressions and casts (S(k) rounded to x's dtype before the energy
and virial, which sum in x's dtype).  A tilted box is item 14.
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

    def m_rows(self, device, flt) -> torch.Tensor:
        """The (3, K) rows of the m triples in flt on ``device``, uploaded
        once (the JAX ``jnp.asarray(ew.mvecs, flt)``)."""
        c = self.consts(device, flt)
        if "m_rows" not in c:
            c["m_rows"] = torch.as_tensor(
                np.ascontiguousarray(np.asarray(self.mvecs, np.float64).T)
            ).to(device, flt)
        return c["m_rows"]

    def e_self_traced(self, vol: torch.Tensor) -> torch.Tensor:
        """qqrd2e times the self and background terms at the volume vol (a
        0-d tensor; the JAX ``_ewald_compute_traced`` expression)."""
        g = self.g_ewald
        e = (-g * self.qsqsum / math.sqrt(math.pi)
             - math.pi / 2.0 * self.qsum ** 2 / (g * g * vol))
        return self.qqrd2e * e

    def compute_traced(self, x: torch.Tensor, q: torch.Tensor,
                       boxL: torch.Tensor, eflag: bool = True,
                       vflag: bool = True, kc=None) -> KSpaceResult:
        """``compute`` in the box of lengths boxL (3,) on the card (fix
        npt): K11 traced, then K11a and K11b on CUDA planes,
        ``ewald_compute_traced_plain`` on CPU planes.  kc is not read (the
        tables follow the box every step, as in the JAX package)."""
        if x.is_cuda:
            return ewald_compute_traced_kernels(self, x, q, boxL, eflag,
                                                vflag)
        if x.device.type != "cpu":
            raise RuntimeError(
                f"no kernel and no plain version for device {x.device}")
        return ewald_compute_traced_plain(self, x, q, boxL, eflag, vflag)

    def at_box(self, lengths) -> "Ewald":
        """This solver (its g_ewald and m triples) on an orthogonal box of
        the given lengths, host numpy: k = 2 pi m / L, ug and the volume of
        that box (the per-atom computes under fix npt use it)."""
        L = np.asarray(lengths, np.float64)
        kvecs = 2.0 * math.pi * np.asarray(self.mvecs, np.float64) / L
        ksq = np.sum(kvecs ** 2, axis=1)
        volume = float(np.prod(L))
        ug = ((2.0 * math.pi / volume) * np.exp(-ksq / (4.0 * self.g_ewald
                                                        ** 2)) / ksq)
        return dataclasses.replace(self, kvecs=kvecs, ug=ug, volume=volume,
                                   _consts={})

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


def _plain_sk_force(kv: torch.Tensor, ug: torch.Tensor, qqrd2e: float,
                    x: torch.Tensor, q: torch.Tensor, acc):
    """S(k) (s_re, s_im in acc) and the forces (N, 3) in acc, per chunk of
    k vectors: phase = x kv^T, cos and sin (N, Kc), S(k) = q . cos / q .
    sin in acc, and sum_k (s Re - c Im) 2 ug k as s @ (2 ug Re k) - c @ (2
    ug Im k) in x's dtype (the JAX (s Re - c Im) 2 ug @ kv, reassociated),
    then qqrd2e q f cast to acc.  kv (K, 3) and ug (K,) in x's dtype."""
    flt, dev = x.dtype, x.device
    n = x.shape[1]
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
    return s_re, s_im, (float(qqrd2e) * q[:, None] * f).to(acc)


def ewald_compute_plain(ew: Ewald, x: torch.Tensor, q: torch.Tensor,
                        eflag: bool = True,
                        vflag: bool = True) -> KSpaceResult:
    """The JAX ``_ewald_compute`` in torch ops, any device
    (``_plain_sk_force``), then elong and the virial from S(k)."""
    c = ew.consts(x.device, x.dtype)
    s_re, s_im, f = _plain_sk_force(c["kv"], c["ug"], ew.qqrd2e, x, q,
                                    ew.acc_dtype)
    elong, virial = _energy_virial(ew, c, s_re, s_im, eflag, vflag,
                                   x.device)
    return KSpaceResult(f=tuple(f.t().contiguous().unbind(0)), elong=elong,
                        virial=virial)


def traced_tables_plain(m_rows: torch.Tensor, boxL: torch.Tensor,
                        g_ewald: float, acc) -> dict:
    """Plain version of K11 traced (``ops.ewald.ewald_traced``), any
    device: the JAX ``_ewald_compute_traced`` tables from the m rows (3,
    K) and the box lengths boxL (3,), in their dtype (flt): kv = 2 pi m /
    L, ksq, vol = Lx Ly Lz, ug = (2 pi / vol) exp(-ksq / 4 g^2) / ksq, pref
    = 2 (1 / ksq + 1 / (4 g^2)), vfac as in ``Ewald.consts``."""
    g2 = float(g_ewald) ** 2
    kv = (2.0 * math.pi) * m_rows / boxL[:, None]
    kx, ky, kz = kv[0], kv[1], kv[2]
    ksq = kx * kx + ky * ky + kz * kz
    vol = boxL[0] * boxL[1] * boxL[2]
    ug = (2.0 * math.pi) / vol * torch.exp(-ksq / (4.0 * g2)) / ksq
    pref = 2.0 * (1.0 / ksq + 0.25 / g2)
    vfac = torch.stack([1.0 - pref * kx * kx, 1.0 - pref * ky * ky,
                        1.0 - pref * kz * kz, -pref * kx * ky,
                        -pref * kx * kz, -pref * ky * kz])
    return dict(kv_rows=kv, ug=ug, ug_acc=ug.to(acc), vfac=vfac.to(acc))


def ewald_compute_traced_plain(ew: Ewald, x: torch.Tensor, q: torch.Tensor,
                               boxL: torch.Tensor, eflag: bool = True,
                               vflag: bool = True) -> KSpaceResult:
    """The JAX ``_ewald_compute_traced`` in torch ops, any device: the
    tables of boxL (``traced_tables_plain``), S(k) in acc rounded to x's
    dtype, the forces (``_plain_sk_force``), uk = ug |S|^2 qqrd2e in x's
    dtype, elong = sum(uk) in acc + qqrd2e (self + background at the
    traced volume), the virial sum(uk vfac_c) in acc."""
    flt, acc, dev = x.dtype, ew.acc_dtype, x.device
    L = boxL.to(flt)
    t = traced_tables_plain(ew.m_rows(dev, flt), L, ew.g_ewald, acc)
    kv = t["kv_rows"].t()
    s_re, s_im, f = _plain_sk_force(kv, t["ug"], ew.qqrd2e, x, q, acc)
    re, im = s_re.to(flt), s_im.to(flt)
    uk = t["ug"] * (re * re + im * im) * float(ew.qqrd2e)
    vol = L[0] * L[1] * L[2]
    if eflag:
        elong = (uk.to(acc).sum() + ew.e_self_traced(vol)).to(acc)
    else:
        elong = torch.zeros((), dtype=acc, device=dev)
    if vflag:
        g2 = ew.g_ewald ** 2
        kx, ky, kz = kv[:, 0], kv[:, 1], kv[:, 2]
        ksq = kx * kx + ky * ky + kz * kz
        pref = 2.0 * (1.0 / ksq + 0.25 / g2)
        virial = torch.stack([
            (uk * (1.0 - pref * kx * kx)).to(acc).sum(),
            (uk * (1.0 - pref * ky * ky)).to(acc).sum(),
            (uk * (1.0 - pref * kz * kz)).to(acc).sum(),
            (uk * (-pref * kx * ky)).to(acc).sum(),
            (uk * (-pref * kx * kz)).to(acc).sum(),
            (uk * (-pref * ky * kz)).to(acc).sum()])
    else:
        virial = torch.zeros(6, dtype=acc, device=dev)
    return KSpaceResult(f=tuple(f.t().contiguous().unbind(0)), elong=elong,
                        virial=virial)


def ewald_compute_traced_kernels(ew: Ewald, x: torch.Tensor,
                                 q: torch.Tensor, boxL: torch.Tensor,
                                 eflag: bool = True,
                                 vflag: bool = True) -> KSpaceResult:
    """``compute_traced`` on the card: K11 traced (the tables of boxL),
    then K11a and K11b of csrc/ewald.cu on them."""
    from ...ops import ewald as ewald_ops

    flt, acc = x.dtype, ew.acc_dtype
    L = boxL.to(flt)
    c = ewald_ops.ewald_traced(ew.m_rows(x.device, flt), L, ew.g_ewald, acc)
    xs = tuple(x.unbind(0))
    sk = ewald_ops.ewald_sk(xs, q, c, ew.qqrd2e, acc)
    f = ewald_ops.ewald_force(xs, q, c, sk.wre, sk.wim, ew.qqrd2e, acc)
    zero = torch.zeros((), dtype=acc, device=x.device)
    elong = ((sk.sums[0] * ew.qqrd2e
              + ew.e_self_traced(L[0] * L[1] * L[2])).to(acc)
             if eflag else zero)
    virial = (sk.sums[1:7] if vflag
              else torch.zeros(6, dtype=acc, device=x.device))
    return KSpaceResult(f=f, elong=elong, virial=virial)


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
