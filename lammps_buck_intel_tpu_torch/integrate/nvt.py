"""Nose-Hoover chain NVT thermostat (``fix nvt temp Tstart Tstop Tdamp``).

Counterpart of ``lammps_buck_intel_tpu.integrate.nvt``: fix_nh's
nhc_temp_integrate with chain length M (default 3), one Suzuki-Yoshida
step; the half-step chain update brackets the velocity-Verlet
kick-drift-kick.  The chain is a (2, M) tensor (eta, eta_dot) on the
device of the velocities.  The engine calls ``nhc_scale``: on CUDA planes
one launch of the nhc_scale kernel of csrc/verlet.cu sums the kinetic
partials, integrates the chain and scales the velocities; on CPU planes
``nhc_scale_plain`` does the same through ``nhc_half``, torch ops on 0-d
and (M,) tensors.  Neither brings a host synchronisation into the step.

The conserved quantity
    H' = KE + PE + sum_k Q_k eta_dot_k^2 / 2
         + dof kB T eta_1 + kB T sum_{k>1} eta_k
is exposed for testing (``chain_energy``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class NVTConfig:
    t_start: float
    t_stop: float
    t_damp: float
    tchain: int = 3
    dof: int = 0          # filled by the runner (3N - 3)
    boltz: float = 1.0
    mvv2e: float = 1.0
    dt: float = 0.0


class NHChain(NamedTuple):
    eta: torch.Tensor      # (M,)
    eta_dot: torch.Tensor  # (M,)


def _masses(cfg: NVTConfig, t_target: float):
    kt = cfg.boltz * t_target
    return cfg.dof * kt * cfg.t_damp**2, kt * cfg.t_damp**2


def nhc_half(cfg: NVTConfig, chain: NHChain, ke2: torch.Tensor,
             t_target: float):
    """One half step of the chain; returns (scale for v, new chain).

    ke2: 0-d tensor, sum(m v^2) * mvv2e = 2 KE in energy units (the JAX
    function takes v and the masses and sums them itself; the engine's
    velocities are three planes, so it sums them and passes the result).
    t_target: python float."""
    m = cfg.tchain
    dt2, dt4, dt8 = 0.5 * cfg.dt, 0.25 * cfg.dt, 0.125 * cfg.dt
    kt = cfg.boltz * t_target
    q1, qk = _masses(cfg, t_target)
    eta = chain.eta
    ed = list(chain.eta_dot.unbind(0))

    def g_of(k):   # force on chain link k >= 1 from link k - 1
        qprev = q1 if k == 1 else qk
        return (qprev * ed[k - 1] * ed[k - 1] - kt) / qk

    # backward sweep: update eta_dot from the tail to the head
    g = [(ke2 - cfg.dof * kt) / q1] + [g_of(k) for k in range(1, m)]
    ed[m - 1] = ed[m - 1] + g[m - 1] * dt4
    for k in range(m - 2, -1, -1):
        expf = torch.exp(-dt8 * ed[k + 1])
        ed[k] = (ed[k] * expf + g[k] * dt4) * expf

    scale = torch.exp(-dt2 * ed[0])
    ke2 = ke2 * scale * scale
    eta = eta + dt2 * torch.stack(ed)

    # forward sweep with the updated kinetic energy
    g0 = (ke2 - cfg.dof * kt) / q1
    expf = torch.exp(-dt8 * ed[1]) if m > 1 else 1.0
    ed[0] = (ed[0] * expf + g0 * dt4) * expf
    for k in range(1, m - 1):
        gk = g_of(k)
        expf = torch.exp(-dt8 * ed[k + 1])
        ed[k] = (ed[k] * expf + gk * dt4) * expf
    if m > 1:
        ed[m - 1] = ed[m - 1] + g_of(m - 1) * dt4
    return scale, NHChain(eta=eta, eta_dot=torch.stack(ed))


def nhc_scale_plain(cfg: NVTConfig, therm: torch.Tensor, vs, partial,
                    t_target: float) -> torch.Tensor:
    ke2 = partial[:, 0].sum().to(vs[0].dtype) * cfg.mvv2e
    scale, chain = nhc_half(cfg, NHChain(*therm), ke2, t_target)
    for v in vs:
        v.mul_(scale)
    return torch.stack(chain)


def nhc_scale(cfg: NVTConfig, therm: torch.Tensor, vs, partial: torch.Tensor,
              t_target: float) -> torch.Tensor:
    """One chain half step: scales the velocity planes ``vs`` in place and
    returns the new (2, M) chain.  partial: the (rows, 2) kinetic partials
    of ``vs`` (``nve.kinetic`` or ``nve.kick``), column 0 summing to
    sum(m v^2)."""
    if vs[0].is_cuda:
        from ..ops import verlet as verlet_ops

        return verlet_ops.nhc_scale(cfg, therm, vs, partial, t_target)
    if vs[0].device.type != "cpu":
        raise RuntimeError(
            f"no kernel and no plain version for device {vs[0].device}")
    return nhc_scale_plain(cfg, therm, vs, partial, t_target)


def chain_energy(cfg: NVTConfig, chain: NHChain, t_target: float):
    """Thermostat contribution to the conserved quantity H'."""
    kt = cfg.boltz * t_target
    q1, qk = _masses(cfg, t_target)
    qs = torch.full_like(chain.eta_dot, qk)
    qs[0] = q1
    e = (0.5 * qs * chain.eta_dot**2).sum()
    e = e + cfg.dof * kt * chain.eta[0]
    if cfg.tchain > 1:
        e = e + kt * chain.eta[1:].sum()
    return e
