"""Ewald (``kspace_style ewald``) and the coul/cut decks of the port
against the JAX package (CPU, f64).

(a) ``setup_ewald``: the k set, ug, the m triples, g_ewald and kmax equal
    the JAX package's to the bit, on the rock-salt cube of
    tests/test_ewald.py and on the jittered cristobalite at 1x1x2 (2,880
    atoms, K = 8,820); ``interop.ewald_from_numpy`` carries a JAX Ewald
    over unchanged.
(b) ``ewald_compute_plain`` (the version the CUDA kernels are held to)
    against the JAX ``_ewald_compute`` on the same k set: forces (of the
    largest force), elong and the virial (of the largest component)
    within 1e-10 relative; the chunked loop over k vectors gives the
    one-chunk result to 1e-12; without eflag / vflag elong / the virial
    are zero.
(c) The two decks, shrunk, through ``run.build_simulation`` against the
    JAX package's record (tests/goldens/torch_ewald.json, written by
    tools/record_ewald.py): cristobalite_ewald.yaml at 1x1x2 and
    cristobalite_coul_cut.yaml at one copy of the jittered crystal, 20
    steps: the list sizing, the k set's size, g_ewald and self energy,
    the step-0 forces, every row (1e-10 relative), the final positions
    (of the box length) and image flags.  The coul/cut rows carry the
    Coulomb energy in ecoul and an elong of 0.
(d) The decks are the reference decks line for line but for the data
    file and its replication; the Ewald forms the port does not run
    (engine cellpair, fix npt, an unread kspace key) raise.
"""
import copy
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.models.kspace import ewald as jewald
from lammps_buck_intel_tpu_torch.core import make_box as tmake_box
from lammps_buck_intel_tpu_torch.interop import ewald_from_numpy
from lammps_buck_intel_tpu_torch.io import lattice
from lammps_buck_intel_tpu_torch.io import read_data
from lammps_buck_intel_tpu_torch.models.kspace import ewald as tewald
from lammps_buck_intel_tpu_torch.run import build_simulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = os.path.join(ROOT, "examples", "decks")
GOLDEN = os.path.join(ROOT, "tests", "goldens", "torch_ewald.json")
ROW_KEYS = ("temp", "evdwl", "ecoul", "elong", "emol", "epair", "ke",
            "etotal", "press")
RTOL = 1e-10
QQRD2E = 14.399645   # metal units


def _nacl():
    """The 4^3 rock-salt cube of tests/test_ewald.py, jittered so that the
    forces are not zero by symmetry."""
    n = 4
    idx = np.array([(i, j, k) for i in range(n) for j in range(n)
                    for k in range(n)], float)
    q = np.where(idx.sum(1) % 2 == 0, 1.0, -1.0)
    x = idx + 0.5 + np.random.default_rng(4).uniform(-0.1, 0.1, idx.shape)
    return x, q, np.zeros(3), np.full(3, float(n)), dict(cutoff=1.9,
                                                         accuracy=1e-6,
                                                         qqrd2e=1.0)


def _cristobalite():
    """The crystal at 1x1x2 with the deck's cutoff and accuracy, jittered."""
    d = read_data(os.path.join(ROOT, "examples", "data.cristobalite"))
    x, lo, hi, pa, *_ = lattice.replicate(d.x, d.box_lo, d.box_hi, (1, 1, 2),
                                          per_atom={"q": d.q})
    x = x + np.random.default_rng(5).uniform(-0.1, 0.1, x.shape)
    return x, pa["q"], lo, hi, dict(cutoff=12.0, accuracy=1e-6,
                                    qqrd2e=QQRD2E)


def _setups(system):
    x, q, lo, hi, p = _nacl() if system == "nacl" else _cristobalite()
    je = jewald.setup_ewald(jmake_box(lo, hi), q, p["cutoff"], p["accuracy"],
                            p["qqrd2e"], acc_dtype=jnp.float64)
    te = tewald.setup_ewald(tmake_box(lo, hi), q, p["cutoff"],
                            p["accuracy"], p["qqrd2e"],
                            acc_dtype=torch.float64)
    return x, q, je, te


@pytest.mark.parametrize("system", ["nacl", "cristobalite"])
def test_setup_ewald_matches_jax(system):
    _, _, je, te = _setups(system)
    assert te.kvecs.shape == je.kvecs.shape and te.kvecs.shape[0] > 100
    for f in ("kvecs", "ug", "mvecs"):
        assert np.array_equal(getattr(te, f), getattr(je, f)), f
    for f in ("g_ewald", "qsum", "qsqsum", "qqrd2e", "volume",
              "elong_self"):
        assert getattr(te, f) == getattr(je, f), f
    assert te.kmax == tuple(je.kmax)
    if system == "cristobalite":
        assert te.kvecs.shape[0] == 8820 and te.kmax == (10, 13, 15)
    p = ewald_from_numpy(je.g_ewald, je.kvecs, je.ug, je.mvecs, je.qsum,
                         je.qsqsum, je.qqrd2e, je.volume, je.kmax)
    for f in ("kvecs", "ug", "mvecs"):
        assert np.array_equal(getattr(p, f), getattr(te, f)), f
    assert (p.g_ewald, p.kmax, p.elong_self) == (te.g_ewald, te.kmax,
                                                 te.elong_self)


@pytest.mark.parametrize("system", ["nacl", "cristobalite"])
def test_ewald_compute_plain_matches_jax(system, monkeypatch):
    x, q, je, te = _setups(system)
    jr = jewald._ewald_compute(je, jnp.asarray(x), jnp.asarray(q), True,
                               True)
    xt, qt = torch.as_tensor(x.T.copy()), torch.as_tensor(q)
    tr = tewald.ewald_compute_plain(te, xt, qt, True, True)
    fj = np.asarray(jr.f)
    ft = torch.stack(tr.f, -1).numpy()
    assert np.abs(fj).max() > 1e-2   # the jitter makes real forces
    assert np.abs(ft - fj).max() <= RTOL * np.abs(fj).max()
    ej = float(jr.elong)
    assert abs(float(tr.elong) - ej) <= RTOL * abs(ej)
    vj = np.asarray(jr.virial)
    assert np.abs(tr.virial.numpy() - vj).max() <= RTOL * np.abs(vj).max()
    # Ewald.compute on CPU planes is the plain version
    same = te.compute(xt, qt)
    assert abs(float(same.elong - tr.elong)) <= 1e-12 * abs(ej)
    # the chunked loop over k vectors: the same sums to rounding
    monkeypatch.setattr(tewald, "_CHUNK_ELEMS",
                        (te.kvecs.shape[0] // 5) * len(q))
    tc = tewald.ewald_compute_plain(te, xt, qt, True, True)
    fc = torch.stack(tc.f, -1).numpy()
    assert np.abs(fc - ft).max() <= 1e-12 * np.abs(ft).max()
    assert abs(float(tc.elong - tr.elong)) <= 1e-12 * abs(float(tr.elong))
    none = tewald.ewald_compute_plain(te, xt, qt, False, False)
    assert float(none.elong) == 0.0 and not none.virial.any()
    fn = torch.stack(none.f, -1).numpy()
    assert np.abs(fn - ft).max() <= 1e-12 * np.abs(ft).max()


def _record():
    with open(GOLDEN) as f:
        return json.load(f)


def _deck(name, **kw):
    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("key", ["ewald_traj", "coul_cut_traj"])
def test_deck_record_matches_jax(key, tmp_path):
    rec = _record()[key]
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import gen_cristobalite

    path = os.path.join(str(tmp_path), "data.cristobalite_jitter")
    gen_cristobalite.write(path, jitter_amp=rec["amp"])
    sim = build_simulation(_deck(rec["deck"], read_data=path,
                                 replicate=rec["replicate"],
                                 precision="double"), device="cpu")
    assert sim.n_atoms == rec["n_atoms"]
    assert dict(cutneigh=sim.spec.cutneigh, kmax=sim.spec.kmax,
                nc=None if sim.spec.nc is None else list(sim.spec.nc)) \
        == rec["spec"]
    if key == "ewald_traj":
        ew = sim.kspace
        assert isinstance(ew, tewald.Ewald)
        assert (ew.g_ewald, list(ew.kmax), ew.kvecs.shape[0]) == \
            (rec["g_ewald"], rec["kmax"], rec["n_k"])
        assert ew.elong_self == rec["elong_self"]
        assert sim.pair.g_ewald == ew.g_ewald
    else:
        assert sim.kspace is None and sim.pair.cfg.coul == "cut"
    pick = np.asarray(rec["atoms"])
    f0 = sim.get_atoms()["f"][pick]
    ref_f = np.asarray(rec["f0"])
    assert np.abs(f0 - ref_f).max() <= RTOL * np.abs(ref_f).max()
    rows = sim.run(rec["steps"], thermo_every=rec["thermo_every"],
                   log=False)
    assert [r["step"] for r in rows] == [r["step"] for r in rec["rows"]]
    for row, ref in zip(rows, rec["rows"]):
        for k in ROW_KEYS:
            assert abs(row[k] - ref[k]) <= RTOL * abs(ref[k]), \
                (ref["step"], k, row[k], ref[k])
        if key == "coul_cut_traj":
            assert row["elong"] == 0.0 and row["ecoul"] < -1e3
    at = sim.get_atoms()
    L = float(np.max(sim.box.lengths))
    assert np.abs(at["x"][pick] - np.asarray(rec["x_end"])).max() <= \
        RTOL * L
    np.testing.assert_array_equal(at["image"][pick],
                                  np.asarray(rec["image_end"]))


@pytest.mark.parametrize("ours,theirs", [
    ("cristobalite_ewald.yaml", "buck_coul_long.yaml"),
    ("cristobalite_coul_cut.yaml", "buck_coul_cut.yaml")])
def test_decks_are_the_reference_decks(ours, theirs):
    a, b = _deck(ours), _deck(theirs)
    assert a.pop("read_data") == "examples/data.cristobalite"
    assert b.pop("read_data").endswith("data.aC")
    assert a.pop("replicate") == ([2, 2, 2] if "ewald" in ours
                                  else [4, 4, 4])
    b.pop("replicate")
    assert a == b and "engine" not in a


def _small_ewald(**kw):
    cfg = _deck("cristobalite_ewald.yaml",
                read_data=os.path.join(ROOT, "examples",
                                       "data.cristobalite"),
                replicate=[1, 1, 1], precision="double")
    cfg["pair_style"]["cut"] = 10.0
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("change,match", [
    (dict(engine="cellpair", kspace_style={"name": "pppm", "accuracy": 1e-4,
                                           "grid": [24, 30, 18]}),
     "item 10.*engine nlist"),
    (dict(fixes=[{"name": "npt", "t_start": 300.0, "t_damp": 0.1,
                  "iso": [0.0, 0.0, 1.0], "xy": [0.0, 0.0, 1.0]}]),
     "item 14"),
    (dict(kspace_style={"name": "ewald", "accuracy": 1e-6, "order": 5}),
     "not ported"),
])
def test_unported_ewald_forms_raise(change, match):
    with pytest.raises(NotImplementedError, match=match):
        build_simulation(_small_ewald(**change), device="cpu")


def test_ewald_gewald_key_and_engine():
    """A deck's gewald is the solver's and the pair style's, and the deck
    runs on the neighbor-list Simulation."""
    from lammps_buck_intel_tpu_torch.integrate import Simulation

    cfg = _small_ewald(kspace_style={"name": "ewald", "accuracy": 1e-4,
                                     "gewald": 0.31})
    sim = build_simulation(copy.deepcopy(cfg), device="cpu")
    assert isinstance(sim, Simulation)
    assert sim.kspace.g_ewald == sim.pair.g_ewald == 0.31
