"""The port's Nose-Hoover chain against the JAX package (CPU, f64):
``nhc_half`` (scale and chain) and ``chain_energy`` at rel 1e-12, for
chains of one and three links, over several half steps with a moving
kinetic energy and from a chain already in motion."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_buck_intel_tpu.integrate import nvt as jnvt
from lammps_buck_intel_tpu_torch.integrate import nvt as tnvt

jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("tchain", [1, 3])
def test_nhc_half_and_chain_energy_match_jax(tchain):
    kw = dict(t_start=300.0, t_stop=300.0, t_damp=50.0, tchain=tchain,
              dof=3 * 200 - 3, boltz=0.0019872067, mvv2e=2390.0573615334906,
              dt=1.0)
    jcfg, tcfg = jnvt.NVTConfig(**kw), tnvt.NVTConfig(**kw)
    rng = np.random.default_rng(tchain)
    mass = rng.choice([12.011, 1.008], size=(200, 1))
    jchain = jnvt.NHChain(eta=jnp.asarray(rng.normal(size=tchain) * 1e-2),
                          eta_dot=jnp.asarray(rng.normal(size=tchain) * 1e-3))
    tchain_ = tnvt.NHChain(eta=torch.from_numpy(np.array(jchain.eta)),
                           eta_dot=torch.from_numpy(
                               np.array(jchain.eta_dot)))
    for step in range(4):
        v = rng.normal(size=(200, 3)) * 5e-3 * (1 + step)
        t_target = 300.0 + 10.0 * step
        jscale, jchain = jnvt.nhc_half(jcfg, jchain, jnp.asarray(v),
                                       jnp.asarray(mass), t_target)
        ke2 = torch.from_numpy(mass * v * v).sum() * tcfg.mvv2e
        tscale, tchain_ = tnvt.nhc_half(tcfg, tchain_, ke2, t_target)
        assert tscale.dim() == 0 and tchain_.eta.shape == (tchain,)
        assert abs(float(tscale) - float(jscale)) <= 1e-12 * float(jscale)
        assert float(jscale) != 1.0
        for a, b in zip(jchain, tchain_):
            a = np.asarray(a)
            assert np.abs(b.numpy() - a).max() <= 1e-12 * np.abs(a).max()
        je = float(jnvt.chain_energy(jcfg, jchain, t_target))
        te = float(tnvt.chain_energy(tcfg, tchain_, t_target))
        assert abs(te - je) <= 1e-12 * abs(je)


def test_chain_starts_at_rest_in_the_slot_state():
    """``from_atoms(tchain=M)`` opens a (2, M) chain at rest in the slot
    state, a clone copies it and a rebin carries it; NVE has none."""
    from lammps_buck_intel_tpu_torch.core import make_box
    from lammps_buck_intel_tpu_torch.neighbor import cell_slots as cs

    rng = np.random.default_rng(0)
    n = 200
    box = make_box(np.zeros(3), np.full(3, 9.0))
    grid = cs.make_grid(n, box.lengths, 3.0)
    args = [torch.from_numpy(a) for a in (
        rng.uniform(0, 9, (n, 3)), rng.normal(size=(n, 3)),
        np.zeros((n, 3), np.int32), np.zeros(n, np.int32), np.zeros(n))]
    st = cs.from_atoms(grid, box, *args, dtype=torch.float64, tchain=3)
    assert st.therm.shape == (2, 3) and not st.therm.any()
    st = st._replace(therm=st.therm + 1.5)
    twin = st.clone()
    assert twin.therm.data_ptr() != st.therm.data_ptr()
    assert torch.equal(twin.therm, st.therm)
    for moved in (cs.rebin_incremental(grid, box, st),
                  cs.rebin(cs.grow(grid), box, st)):
        assert torch.equal(moved.therm, st.therm)
    assert cs.from_atoms(grid, box, *args, dtype=torch.float64).therm is None
    # carried between the packages as numpy planes: an empty chain is None
    from lammps_buck_intel_tpu_torch.interop import (slot_state_from_numpy,
                                                     slot_state_to_numpy)

    planes = slot_state_to_numpy(st)
    back = slot_state_from_numpy(planes, device="cpu")
    assert torch.equal(back.therm, st.therm) and torch.equal(back.x, st.x)
    nve = slot_state_from_numpy(dict(planes, therm=np.zeros((2, 0))),
                                device="cpu")
    assert nve.therm is None and "therm" not in slot_state_to_numpy(nve)


@pytest.mark.parametrize("tchain", [0, 1, 3])
def test_integrator_entry_points_match_jax(tchain):
    """One velocity-Verlet step through the entry points the engine calls
    (``nve.kick_drift``, ``nve.kick``, ``nve.kinetic``, ``nvt.nhc_scale``;
    on CPU planes their plain versions) on slot planes with empty slots,
    against the JAX package's ``initial_integrate`` / ``final_integrate``
    and ``nhc_half`` on the atoms, at 1e-12; tchain 0 is NVE."""
    from lammps_buck_intel_tpu.integrate import nve as jnve
    from lammps_buck_intel_tpu_torch.integrate import nve as tnve

    rng = np.random.default_rng(7 + tchain)
    n, ns, dt, ftm2v = 150, 200, 1.0, 1.0 / 48.88821291 / 48.88821291
    mass_t = np.array([12.011, 1.008, 15.9994])
    typ = rng.integers(0, 3, n)
    x, v, f0, f1a, f1b = (rng.normal(size=(n, 3)) * s
                          for s in (5.0, 5e-3, 20.0, 20.0, 3.0))
    kw = dict(t_start=300.0, t_stop=300.0, t_damp=50.0, tchain=max(tchain, 1),
              dof=3 * n - 3, boltz=0.0019872067, mvv2e=2390.0573615334906,
              dt=dt)
    jcfg, tcfg = jnvt.NVTConfig(**kw), tnvt.NVTConfig(**kw)
    m = jnp.asarray(mass_t[typ][:, None])
    p = jnve.make_nve(dt, ftm2v, mass_t[typ], dtype=jnp.float64)
    jchain = jnvt.NHChain(eta=jnp.asarray(np.zeros(kw["tchain"])),
                          eta_dot=jnp.asarray(np.full(kw["tchain"], 1e-3)))
    jx, jv = jnp.asarray(x), jnp.asarray(v)
    if tchain:
        s, jchain = jnvt.nhc_half(jcfg, jchain, jv, m, 310.0)
        jv = jv * s
    jx, jv = jnve.initial_integrate(p, jx, jv, jnp.asarray(f0))
    jv = jnve.final_integrate(p, jv, jnp.asarray(f1a + f1b))
    if tchain:
        s, jchain = jnvt.nhc_half(jcfg, jchain, jv, m, 310.0)
        jv = jv * s

    # the same atoms scattered over slot planes; the rest are empty slots
    slot = rng.permutation(ns)[:n]
    aid = torch.full((ns,), n, dtype=torch.int32)
    aid[slot] = torch.arange(n, dtype=torch.int32)
    styp = torch.zeros(ns, dtype=torch.int32)
    styp[slot] = torch.from_numpy(typ).int()

    def planes(a):
        out = torch.zeros(3, ns, dtype=torch.float64)
        out[:, slot] = torch.from_numpy(a.T.copy())
        return tuple(out)

    xs, vs, fs, fa, fb = map(planes, (x, v, f0, f1a, f1b))
    mt = torch.from_numpy(mass_t)
    minv_t, dtf = 1.0 / mt, 0.5 * dt * ftm2v
    therm = torch.zeros(2, kw["tchain"], dtype=torch.float64)
    therm[1] = 1e-3
    acc = torch.float64
    if tchain:
        therm = tnvt.nhc_scale(tcfg, therm, vs,
                               tnve.kinetic(vs, styp, aid, mt, n, acc), 310.0)
    tnve.kick_drift(xs, vs, fs, styp, aid, minv_t, n, dtf, dt)
    part = tnve.kick(vs, fs, fa, fb, styp, aid, minv_t, mt, n, dtf, acc,
                     ke=bool(tchain))
    assert (part is None) == (tchain == 0)
    if tchain:
        therm = tnvt.nhc_scale(tcfg, therm, vs, part, 310.0)
    for got, ref in ((xs, jx), (vs, jv), (fs, f1a + f1b)):
        ref = np.asarray(ref)
        got = torch.stack(got)[:, slot].numpy().T
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    empty = aid >= n
    assert not any(bool(t[empty].any()) for t in xs + vs)
    kin = tnve.kinetic(vs, styp, aid, mt, n, acc)
    jv = np.asarray(jv)
    assert abs(float(kin[:, 0].sum()) - (mass_t[typ] * (jv * jv).sum(1)).sum()) \
        <= 1e-12 * float(kin[:, 0].sum())
    assert abs(float(kin[:, 1].max()) - (jv * jv).sum(1).max()) <= 1e-15
    if tchain:
        ref = np.stack([np.asarray(jchain.eta), np.asarray(jchain.eta_dot)])
        assert np.abs(therm.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
