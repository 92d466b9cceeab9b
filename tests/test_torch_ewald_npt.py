"""The Ewald sum under a variable cell and on the cell engine, and the
fix npt decks of the rest of the Coulomb k-space, against the JAX package.

(a) ``Ewald.compute_traced`` (the plain version of K11 traced, K11a and
    K11b) equals the JAX ``_ewald_compute_traced`` on a stretched box in
    f64 at 1e-10, its tables equal a fresh ``setup_ewald``'s at the set-up
    box, and ``Ewald.at_box`` gives the static solver of a box.
(b) Under fix npt the per-atom Ewald energies follow the current box:
    sum(c_pe) pins to the thermo row on a stretched box, where the JAX
    computes (its computes.py:162-163, the set-up box's k vectors) miss
    it (ROADMAP queue 3).
(c) cristobalite_ewald_cell.yaml at full size binds the cell engine (its
    box holds 3 cells an axis), not the list engine's fallback.
(d) The shrunk Ewald cell, Ewald NPT and rhodo_npt_ad decks
    (``examples/kspace_rest_cases.py``) equal the JAX package's record
    (tests/goldens/torch_kspace_rest.json) in f64 at 1e-9.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.models.kspace import setup_ewald as jsetup_ewald
from lammps_buck_intel_tpu_torch.core import make_box as tmake_box
from lammps_buck_intel_tpu_torch.models.kspace import setup_ewald
from lammps_buck_intel_tpu_torch.models.kspace import ewald as tewald
from lammps_buck_intel_tpu_torch.run import build_simulation

jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "torch_kspace_rest.json")
QQRD2E = 14.399645
RTOL = 1e-10


def _system():
    """A jittered 400-charge neutral box and a stretch of it."""
    rng = np.random.RandomState(7)
    L = np.array([14.0, 15.0, 13.0])
    x = rng.uniform(0, 1, (400, 3)) * L
    q = rng.uniform(-1, 1, 400)
    q -= q.mean()
    s = np.array([1.04, 0.97, 1.02])
    L1 = L * s
    return x, q, L, x * s + 0.5 * (L - L1), L1


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rtol * np.abs(b).max(), \
        (np.abs(a - b).max(), np.abs(b).max())


def test_ewald_compute_traced_matches_jax():
    x, q, L, x1, L1 = _system()
    kw = dict(cutoff=5.0, accuracy_rel=1e-4, qqrd2e=QQRD2E)
    je = jsetup_ewald(jmake_box([0, 0, 0], L), q, acc_dtype=jnp.float64,
                      **kw)
    te = setup_ewald(tmake_box([0, 0, 0], L), q, acc_dtype=torch.float64,
                     **kw)
    jr = je.compute_traced(jnp.asarray(x1), jnp.asarray(q),
                           jnp.asarray(L1))
    tr = te.compute_traced(torch.as_tensor(x1.T.copy()),
                           torch.as_tensor(q), torch.as_tensor(L1))
    _close(torch.stack(tr.f).T, jr.f)
    assert abs(float(tr.elong) - float(jr.elong)) <= \
        RTOL * abs(float(jr.elong))
    _close(tr.virial, jr.virial)
    # at the set-up box the traced tables are the static solver's, and
    # at_box gives the static solver of the stretched box
    m = te.m_rows("cpu", torch.float64)
    t0 = tewald.traced_tables_plain(m, torch.as_tensor(L), te.g_ewald,
                                    torch.float64)
    _close(t0["kv_rows"].T, te.kvecs, 1e-13)
    _close(t0["ug"], te.ug, 1e-13)
    r1 = te.at_box(L1).compute(torch.as_tensor(x1.T.copy()),
                               torch.as_tensor(q))
    _close(torch.stack(r1.f).T, jr.f, 1e-9)
    assert abs(float(r1.elong) - float(jr.elong)) <= \
        1e-9 * abs(float(jr.elong))


def _npt_ewald_sim(tmp):
    import kspace_rest_cases as kc

    return build_simulation(kc.deck_cfg("ewald_npt", tmp), device="cpu")


def test_ewald_npt_peratom_pins_on_the_current_box(tmp_path):
    """On a stretched box sum(c_pe) equals the thermo row's epair with the
    port's per-atom Ewald (the k vectors of the current box); the JAX
    binding (the set-up box's k vectors and volume) misses it by far more
    than the f32 per-atom pass's rounding."""
    from lammps_buck_intel_tpu_torch.computes import pe_atom
    from lammps_buck_intel_tpu_torch.integrate import NPTSimulation

    sim = _npt_ewald_sim(str(tmp_path))
    assert isinstance(sim, NPTSimulation)
    st = sim.state
    s = torch.tensor([1.03, 0.98, 1.02], dtype=st.boxL.dtype)
    c = sim._center_t[:, None]
    sim.state = st._replace(boxL=st.boxL * s, x=c + (st.x - c) * s[:, None])
    row = sim.thermo()
    pe = float(pe_atom(sim).sum())
    tol = 2e-6 * abs(row["epair"])       # the computes run in f32
    assert abs(pe - row["epair"]) <= tol, (pe, row["epair"])
    # the k-space shares alone, in f64: the port's solver of the current
    # box pins to elong; the JAX binding's set-up solver does not
    from lammps_buck_intel_tpu.models.kspace.ewald import \
        ewald_compute_peratom as jperatom

    ks = sim.kspace
    x = np.asarray(sim.get_atoms()["x"], np.float64)
    q = sim.q.to(torch.float64)
    e_port = tewald.ewald_compute_peratom(ks.at_box(sim.box.lengths),
                                          torch.as_tensor(x.T.copy()), q)[0]
    assert abs(float(e_port.sum()) - row["elong"]) <= \
        1e-9 * abs(row["elong"])
    je = jsetup_ewald(jmake_box(sim._center - 0.5 * sim._L0,
                                sim._center + 0.5 * sim._L0), q.numpy(),
                      cutoff=5.0, accuracy_rel=1e-4, qqrd2e=QQRD2E,
                      g_ewald=ks.g_ewald, acc_dtype=jnp.float64)
    assert je.kvecs.shape == ks.kvecs.shape
    e_jax = jperatom(je, jnp.asarray(x), jnp.asarray(q.numpy()))[0]
    assert abs(float(jnp.sum(e_jax)) - row["elong"]) > 100 * tol


def test_ewald_cell_deck_binds_the_cell_engine():
    """At full size (11,520 atoms, list reach 12.3 A) the box holds 4x5x3
    cells: the cell engine, not the box-too-small fallback."""
    import kspace_rest_cases as kc
    from lammps_buck_intel_tpu_torch.neighbor import cell_slots as cs

    cfg = kc.load_deck("cristobalite_ewald_cell.yaml")
    assert cfg["engine"] == "cellpair"
    L = np.array([28.64, 35.8, 21.48]) * np.asarray(cfg["replicate"])
    reach = cfg["pair_style"]["cut"] + cfg["neighbor"]["skin"]
    grid = cs.make_grid(11520, L, reach)
    assert grid is not None and tuple(grid.nc) == (4, 5, 3)


def _record():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["ewald_cell", "ewald_npt",
                                  "rhodo_npt_ad"])
def test_kspace_rest_deck_matches_record(name, tmp_path):
    from test_torch_pppm_ad import check_case, run_case

    rec = _record()["cases"][name]
    check_case(name, rec, *run_case(name, str(tmp_path)))
