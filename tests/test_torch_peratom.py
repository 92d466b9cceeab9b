"""Per-atom energies and virials of the port (compute pe/atom, compute
stress/atom and the four per-atom functions) against the JAX package
(CPU).

The JAX values come from tools/record_peratom.py
(tests/goldens/torch_peratom.json): four cases (examples/peratom_cases.py)
built in f64 with run 0 by the JAX deck runner, which the port builds
through its own ``build_simulation`` on the same inputs (silica_pppm and
silica_ewald on a jittered copy of examples/data.cristobalite, 1,440
atoms, on the neighbor-list engine; rhodo_class.yaml, 1,728 atoms, on the
cell engine with SHAKE, specials and the bonded terms; one copy of
rhodo_npt.yaml for the NPT engine's TracedPPPM).

(a) ``compute_pair_peratom``, ``pppm.compute_peratom`` (with the JAX
    package's half-spectrum convention, ``nyquist=False``),
    ``ewald_compute_peratom`` and ``compute_bonded_peratom`` in f64 on the
    port's snapshot against the record's JAX results: column sums and 64
    sampled atoms within 1e-10 of their magnitude.
(b) The pin identities in f64, within 1e-12: each function's sums equal
    the global tallies of its solver (the pair pass, ``PPPM.compute`` /
    ``Ewald.compute``, ``compute_bonded``); with ``nyquist`` (the port's
    default) the PPPM virial sums pin exactly, and only the off-diagonal
    components move.
(c) ``computes.pe_atom`` / ``stress_atom`` (f32 pair and k-space passes,
    as the JAX package's; stress with its k-space shares swapped for the
    JAX package's half-spectrum ones, ``peratom_cases.half_spectrum_stress``)
    against the JAX computes: sums within 2e-5, sampled atoms within 1e-4
    of the largest sample; the port's stress differs from it off the
    diagonal alone; and against the
    port's own thermo row: sum pe = epair + emol (2e-5 of |total|), and on
    the silica cases press = -trace(sum stress) / (3 V) (2e-4 max(|press|,
    1); SHAKE's virial is global only, so the rhodo cases have no pressure
    identity).
(d) The dispersion k-space (BoundKSpace typed and per-atom,
    CombinedKSpace) dispatches and gives the JAX numbers, an unbound
    PPPMDisp raises; the same-molecule list filter keeps the JAX build's
    pairs.
"""
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.models.kspace import setup_pppm as jsetup_pppm
from lammps_buck_intel_tpu.models.kspace.base import BoundKSpace as JBound
from lammps_buck_intel_tpu.models.kspace.base import (
    CombinedKSpace as JCombined)

from lammps_buck_intel_tpu_torch import computes
from lammps_buck_intel_tpu_torch.core import make_box
from lammps_buck_intel_tpu_torch.interop import jax_torsion_deck
from lammps_buck_intel_tpu_torch.models.bonded import (compute_bonded,
                                                       compute_bonded_peratom)
from lammps_buck_intel_tpu_torch.models.kspace import pppm as tpppm
from lammps_buck_intel_tpu_torch.models.kspace import setup_pppm
from lammps_buck_intel_tpu_torch.models.kspace.base import (BoundKSpace,
                                                            CombinedKSpace)
from lammps_buck_intel_tpu_torch.models.pair import driver
from lammps_buck_intel_tpu_torch.neighbor import neighbor_list as tnl
from lammps_buck_intel_tpu_torch.run import build_simulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import peratom_cases as rec  # noqa: E402
from test_torch_peratom_disp import B  # noqa: E402
from test_torch_peratom_disp import _disp_system as disp_system  # noqa: E402
from test_torch_peratom_disp import _rel as rel  # noqa: E402
from test_torch_peratom_disp import _solvers as disp_solvers  # noqa: E402

with open(os.path.join(ROOT, "tests", "goldens", "torch_peratom.json")) as f:
    GOLDEN = json.load(f)
CASES = tuple(rec.CASES)
F64 = 1e-10
PIN = 1e-12


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("peratom") / "data.cris_jitter")
    rec.write_jitter(path)
    built = {}

    def get(name):
        if name not in built:
            # the JAX package's torsion angle for its records
            sim = build_simulation(
                jax_torsion_deck(rec.case_config(name, path)), device="cpu")
            built[name] = (sim, sim.thermo())
        return built[name]

    return get


def _close(name, a, ref, rtol):
    """Column sums and the sampled atoms of ``a`` against the record's."""
    a = np.asarray(a, np.float64)
    idx = np.asarray(GOLDEN[name]["sample"])
    s, rs = a.sum(0), np.asarray(ref["sum"])
    smp, rsmp = a[idx], np.asarray(ref["sample"])
    es = float(np.abs(s - rs).max()) / max(float(np.abs(rs).max()), 1e-300)
    ep = float(np.abs(smp - rsmp).max()) / max(float(np.abs(rsmp).max()),
                                               1e-300)
    return es, ep


def _f64(sim, nyquist):
    at = sim.atoms_on_device()
    pair = computes._pair_peratom(sim, at, torch.float64)
    ks = computes._kspace_peratom(sim, at, torch.float64, nyquist)
    xs = tuple(at["x"].to(torch.float64).unbind(0))
    bonded = (compute_bonded_peratom(sim.bonded, xs, sim.box)
              if sim.bonded is not None else None)
    return at, pair, ks, bonded


@pytest.mark.parametrize("name", CASES)
def test_peratom_functions_match_jax(name, sims):
    sim, _ = sims(name)
    ref = GOLDEN[name]["f64"]
    assert sim.n_atoms == GOLDEN[name]["n_atoms"]
    _, pair, ks, bonded = _f64(sim, nyquist=False)
    got = dict(pair_e=pair[0], pair_v=pair[1], kspace_e=ks[0],
               kspace_v=ks[1])
    if bonded is not None:
        got.update(bonded_e=bonded[0], bonded_v=bonded[1],
                   bonded_e14=bonded[2], bonded_v14=bonded[3])
    else:
        assert ref["bonded_e"]["sum"] == 0.0
    for key, a in got.items():
        es, ep = _close(name, a.numpy(), ref[key], F64)
        assert es <= F64 and ep <= F64, (key, es, ep)


@pytest.mark.parametrize("name", CASES)
def test_peratom_functions_pin_to_global(name, sims):
    sim, _ = sims(name)
    at, pair, ks, bonded = _f64(sim, nyquist=True)
    x = at["x"].to(torch.float64)

    def pin(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= PIN * max(np.abs(b).max(), 1.0), (a, b)

    # pair: the pass over the same list
    box = sim.box
    L = torch.as_tensor(np.asarray(box.lengths, np.float64))
    spec = tnl.make_spec(sim.n_atoms, box.lengths,
                         float(np.sqrt(sim.pair.cutsq_max)) * 1.0001)
    sp = at["special"]
    nl, _ = tnl.build_with_retry(x, torch.as_tensor(box.lo), L, spec, sp)
    g = driver.compute_pair(sim.pair, x, at["typ"], at["q"].double(), L, nl,
                            acc_dtype=torch.float64,
                            use_special=sp is not None)
    pin(pair[0].sum(), g.evdwl + g.ecoul)
    pin(pair[1].sum(0), g.virial)
    # k-space: the solver's elong and virial
    solver = computes._solvers(sim.kspace)[0]
    solver = getattr(solver, "pm", solver)
    if name == "rhodo_npt":
        solver = tpppm.setup_pppm(
            sim.box, at["q"].double().numpy(), cutoff=1.0, accuracy_rel=1e-4,
            qqrd2e=solver.qqrd2e, order=solver.order,
            g_ewald=solver.g_ewald, grid=solver.grid,
            acc_dtype=torch.float64)
    r = solver.compute(x, at["q"].double(), True, True)
    pin(ks[0].sum(), r.elong)
    pin(ks[1].sum(0), r.virial)
    if name.startswith("silica_pppm"):
        # the JAX package's half-spectrum virial moves off the diagonal only
        _, ks0 = computes._kspace_peratom(sim, at, torch.float64, False)
        assert torch.equal(ks0[:, :3], ks[1][:, :3])
        assert not torch.equal(ks0[:, 3:], ks[1][:, 3:])
    if bonded is not None:
        br = compute_bonded(sim.bonded, tuple(x.unbind(0)), sim.box,
                            acc_dtype=torch.float64)
        pin(bonded[0].sum(), br.emol)
        pin(bonded[2].sum(), br.e14_lj + br.e14_coul)
        pin(bonded[1].sum(0) + bonded[3].sum(0), br.virial)


@pytest.mark.parametrize("name", CASES)
def test_computes_match_jax_and_thermo(name, sims):
    sim, row = sims(name)
    g = GOLDEN[name]
    cache = {}
    pe = computes.pe_atom(sim, cache=cache).numpy()
    st_t = computes.stress_atom(sim, cache=cache)
    st_jax = rec.half_spectrum_stress(sim, st_t, cache).numpy()
    st = st_t.numpy()
    assert pe.shape == (sim.n_atoms,) and st.shape == (sim.n_atoms, 6)
    for a, key in ((pe, "pe"), (st_jax, "stress")):
        es, ep = _close(name, a, g[key], 0.0)
        assert es <= 2e-5 and ep <= 1e-4, (key, es, ep)
    assert np.array_equal(st[:, :3], st_jax[:, :3])
    total = row["epair"] + row["emol"]
    assert abs(pe.sum() - total) <= 2e-5 * abs(total), (pe.sum(), total)
    if name.startswith("silica"):
        vol = float(np.prod(np.asarray(sim.box.lengths)))
        press = -st[:, :3].sum() / (3.0 * vol)
        assert abs(press - row["press"]) <= 2e-4 * max(abs(row["press"]),
                                                        1.0)


def _bound_pairs(x, typ, L):
    """(JAX, port) k-space terms as the deck runner builds them: the
    per-atom geometric channel, the typed no-mix channels, and the
    Coulomb PPPM beside the typed channels."""
    q = np.where(typ == 0, 0.8, -0.8)
    q = q - q.mean()
    gj, gt = disp_solvers("geometric", x, typ, L)
    nj, nt = disp_solvers("none", x, typ, L)
    kw = dict(cutoff=3.0, accuracy_rel=1e-4, qqrd2e=1.0, grid=(16, 16, 16))
    cj = jsetup_pppm(jmake_box([0, 0, 0], [L] * 3), q,
                     acc_dtype=jnp.float64, **kw)
    ct = setup_pppm(make_box([0, 0, 0], [L] * 3), q,
                    acc_dtype=torch.float64, **kw)
    return q, {
        "per_atom": (JBound(gj, B[typ]), BoundKSpace(gt, B[typ])),
        "typed": (JBound(nj, typ, typed=True),
                  BoundKSpace(nt, typ, typed=True)),
        "combined": (JCombined([cj, JBound(nj, typ, typed=True)]),
                     CombinedKSpace([ct, BoundKSpace(nt, typ, typed=True)])),
    }


def test_dispersion_kspace_raises():
    """The dispersion solvers of pppm/disp dispatch through the per-atom
    k-space (BoundKSpace typed and per-atom, CombinedKSpace beside a
    Coulomb PPPM) and give the JAX numbers: in f64 against the JAX
    solvers' per-atom functions bound as the JAX computes bind them (the
    per-atom charges cast to f32; 1e-10), in f32 against the JAX
    ``_kspace_peratom`` (2e-5 of the sums, 1e-4 of the largest atom).  Only
    an unbound PPPMDisp raises, TypeError as in JAX."""
    from lammps_buck_intel_tpu import computes as jcomputes
    from lammps_buck_intel_tpu.models.kspace.pppm import (
        compute_peratom as jcompute_peratom)

    x, typ, L = disp_system()
    n = len(x)
    q, pairs = _bound_pairs(x, typ, L)
    at = dict(x=torch.as_tensor(x.T.copy()), q=torch.as_tensor(q),
              typ=torch.as_tensor(typ))
    for name, (jks, tks) in pairs.items():
        sim = types.SimpleNamespace(kspace=tks)
        te, tv = computes._kspace_peratom(sim, at, torch.float64, False)
        je = jv = 0.0
        for s in (jks.solvers if name == "combined" else [jks]):
            if not isinstance(s, JBound):
                e, v = jcompute_peratom(s, jnp.asarray(x), jnp.asarray(q))
            elif s.typed:
                e, v = s.solver.compute_peratom(jnp.asarray(x),
                                                typ=jnp.asarray(typ))
            else:
                e, v = s.solver.compute_peratom(
                    jnp.asarray(x),
                    b_per_atom=jnp.asarray(s.per_atom, np.float32))
            je, jv = je + np.asarray(e), jv + np.asarray(v)
        assert rel(te, je) <= F64 and rel(tv, jv) <= F64, name
        fe, fv = computes._kspace_peratom(sim, at, torch.float32, False)
        ge, gv = jcomputes._kspace_peratom(
            types.SimpleNamespace(kspace=jks), x, typ, q, n)
        for a, b in ((fe, ge), (fv, gv)):
            a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
            assert rel(a.sum(0), b.sum(0)) <= 2e-5, name
            assert rel(a, b) <= 1e-4, name
    ub = types.SimpleNamespace(kspace=pairs["typed"][1].solver)
    with pytest.raises(TypeError, match="unbound PPPMDisp"):
        computes._kspace_peratom(ub, at)


def test_scope_is_checked(sims):
    sim, _ = sims("silica_ewald")
    with pytest.raises(NotImplementedError, match="scope"):
        computes.pe_atom(sim, scope=("pair", "fix"))
    e = computes.pe_atom(sim, scope=("pair", "kspace", "bond"))
    assert e.shape == (sim.n_atoms,)


def test_exclude_molecule_matches_jax_build(sims):
    import jax.numpy as jnp

    from lammps_buck_intel_tpu.core import make_box as jmake_box
    from lammps_buck_intel_tpu.neighbor import neighbor_list as jnl

    sim, _ = sims("silica_ewald")
    x = sim.atoms_on_device()["x"].double()
    n = x.shape[1]
    mol = torch.arange(n, dtype=torch.int32) // 6
    box = sim.box
    spec = tnl.make_spec(n, box.lengths, 6.0)
    L = torch.as_tensor(np.asarray(box.lengths, np.float64))
    nl, spec = tnl.build_with_retry(x, torch.as_tensor(box.lo), L, spec)
    ex = tnl.exclude_molecule(nl, mol)
    jbox = jmake_box(box.lo, box.hi)
    jspec = jnl.make_spec(n, np.asarray(box.lengths), 6.0)
    jl, _ = jnl.build_with_retry(jnp.asarray(x.t().numpy()), jbox, jspec,
                                 None, None, jnp.asarray(mol.numpy()))
    jidx = np.asarray(jl.idx)
    idx = ex.idx.numpy()
    nn = ex.nnei.numpy()
    assert nn.sum() < nl.nnei.sum().item()
    for i in range(n):
        want = set(int(j) for j in jidx[i] if j < n)
        assert set(int(j) for j in idx[i, :nn[i]]) == want, i
        assert (idx[i, nn[i]:] == n).all()
