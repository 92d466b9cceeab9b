"""buck/long/coul/long and the arithmetic and no-mix dispersion PPPM of the
port against the JAX package (CPU, f64).

(a) ``pair_terms`` of buck/long with coul none and coul long, with and
    without special-bond factors (the additive correction on the undamped
    Buckingham term), against the JAX ``pair_terms`` within 1e-12
    relative.
(b) ``disp_compute_plain`` at mix none (the eigen-split of a C6 matrix
    with a negative eigenvalue, as BKS's) and arithmetic against the JAX
    ``PPPMDisp.compute_typed``: forces, elong and virial within 1e-10;
    the row route (``disp_compute_rows``: every channel in one deposit and
    one gather, e0 and the self term from column counts) with each stage's
    plain version gives the plain result within 1e-12.
(c) ``CombinedKSpace`` (Coulomb PPPM + a typed ``BoundKSpace``) against the
    JAX ``CombinedKSpace``: ``compute`` in atom order and ``compute_slot``
    on a permuted slot order with empty slots, within 1e-10.
(d) The three new decks shrunk (one cristobalite copy at cut 5 on both
    engines, a 384-atom hexane cut-out at cut 5), 5 steps in f64 through
    both packages' ``build_simulation``: every thermo row within 1e-9.
(e) The new decks are the reference decks line for line but for the
    lines they name.
"""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lammps_buck_intel_tpu.core import make_box as jmake_box
from lammps_buck_intel_tpu.models.kspace import pppm as jpppm
from lammps_buck_intel_tpu.models.kspace import pppm_disp as jdisp
from lammps_buck_intel_tpu.models.kspace.base import BoundKSpace as JBound
from lammps_buck_intel_tpu.models.kspace.base import \
    CombinedKSpace as JCombined
from lammps_buck_intel_tpu.models.pair import styles as jstyles
from lammps_buck_intel_tpu.run import build_simulation as jbuild
from lammps_buck_intel_tpu_torch.interop import (kspace_from_numpy,
                                                 pppm_disp_from_numpy)
from lammps_buck_intel_tpu_torch.models.kspace import pppm_disp as tdisp
from lammps_buck_intel_tpu_torch.models.pair import styles as tstyles
from lammps_buck_intel_tpu_torch.run import build_simulation as tbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = os.path.join(ROOT, "examples", "decks")
sys.path.insert(0, os.path.join(ROOT, "examples"))
import gen_hexane  # noqa: E402

RTOL = 1e-10
QQRD2E = 14.399645          # metal units
BKS = {(1, 1): (1388.77, 0.3623188, 175.0),
       (0, 1): (18003.0, 0.2052124, 133.5381),
       (0, 0): (0.0, 0.1, 0.0)}
EPS = np.array([0.30, 0.18])
SIG = np.array([1.10, 1.25])
ROW_KEYS = ("temp", "evdwl", "ecoul", "elong", "epair", "ke", "etotal",
            "press")


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rtol * scale, (
        float(np.abs(a - b).max()), scale)


@pytest.mark.parametrize("coul,special", [("none", False), ("none", True),
                                          ("long", False), ("long", True)])
def test_buck_long_pair_terms_matches_jax(coul, special):
    kw = dict(cut_global=10.0, coul=coul, disp="long", qqrd2e=QQRD2E)
    j = jstyles.build_buck(2, BKS, dtype=jnp.float64, **kw)
    t = tstyles.build_buck(2, BKS, **kw)
    assert np.array_equal(j.tables, t.tables) and j.cutsq_max == t.cutsq_max
    g6 = jdisp.solve_g6(10.0, 1e-4)
    j = j.replace(g_ewald_6=g6, g_ewald=0.29)
    t = t.replace(g_ewald_6=g6, g_ewald=0.29)
    rng = np.random.default_rng(11)
    rsq = rng.uniform(2.0, 110.0, size=4000)    # both sides of cut^2 100
    tt = rng.integers(0, 4, size=rsq.shape)
    flat = j.tables.reshape(4, -1)
    qi = rng.choice([2.4, -1.2], size=rsq.shape)
    qj = rng.choice([2.4, -1.2], size=rsq.shape)
    f_lj = rng.choice([0.0, 0.5, 1.0], size=rsq.shape) if special else 1.0
    f_c = rng.choice([0.0, 0.5, 1.0], size=rsq.shape) if special else 1.0

    def args(asarray):
        coef = {n: asarray(flat[tt, c])
                for c, n in enumerate(jstyles.COEF_NAMES)}
        fs = ((asarray(f_lj), asarray(f_c)) if special else (1.0, 1.0))
        return asarray(rsq), coef, asarray(qi), asarray(qj), *fs

    jf, je, jc = jstyles.pair_terms(j, *args(jnp.asarray), eflag=True)
    tf, te, tc = tstyles.pair_terms(t, *args(torch.as_tensor), eflag=True)
    for a, b in ((jf, tf), (je, te), (jc, tc)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max())
    if special:
        # the additive correction is live: the plain style differs
        pf, _, _ = tstyles.pair_terms(
            t, *args(torch.as_tensor)[:4], 1.0, 1.0, eflag=True)
        assert not torch.allclose(pf, tf)


def _disp_system(seed=0, n=24, L=7.0):
    """tests/test_pppm_disp.py's _disp_system: n atoms of two types, no
    pair closer than sqrt(1.2), in a cube of side L, with charges."""
    rng = np.random.RandomState(seed)
    x = []
    while len(x) < n:
        p = rng.uniform(0, L, 3)
        d = [p - xx for xx in x]
        if all(float(((v - np.round(v / L) * L) ** 2).sum()) > 1.2
               for v in d):
            x.append(p)
    typ = rng.randint(0, 2, n).astype(np.int32)
    q = np.where(typ == 0, 1.0, -1.0)
    q[-1] -= q.sum()
    return np.asarray(x), typ, q, L


def _c6():
    """BKS's C6 pattern: C11 = 0, C12 = 133.5381, C22 = 175 (one eigenvalue
    negative), scaled to the test's units."""
    return np.array([[0.0, 1.335381], [1.335381, 1.75]])


def _disp_setups(mix, seed=0):
    x, typ, q, L = _disp_system(seed)
    B = np.sqrt(4.0 * EPS) * SIG**3
    mk = dict(B_per_type=B, typ=typ, cutoff=3.2, tol_real=1e-5, mix=mix,
              epsilon=EPS, sigma=SIG, C6=_c6())
    j = jdisp.setup_pppm_disp(jmake_box([0, 0, 0], [L] * 3),
                              acc_dtype=jnp.float64, **mk)
    t = pppm_disp_from_numpy(j.g_ewald_6, j.grid, j.order, j.greensfn, j.kx,
                             j.ky, j.kz, j.B, j.volume, j.box_lo, j.h, j.mix,
                             j.A, j.P, j.vfac)
    return x, typ, q, L, j, t


@pytest.mark.parametrize("mix", ["none", "arithmetic"])
def test_disp_compute_plain_matches_jax(mix):
    x, typ, _, _, j, t = _disp_setups(mix)
    nch = np.asarray(j.A).shape[0]
    assert nch == (2 if mix == "none" else 7)
    if mix == "none":
        assert sorted(np.diag(j.P)) == [-1.0, 1.0]
    jr = j.compute_typed(jnp.asarray(x), typ)
    xt = torch.as_tensor(x.T.copy())
    a = torch.as_tensor(np.asarray(j.A)[:, typ])
    tr = tdisp.disp_compute_plain(t, xt, a, t.P, True, True)
    _close(torch.stack(tr.f, -1).numpy(), jr.f)
    _close(float(tr.elong), float(jr.elong))
    _close(tr.virial.numpy(), jr.virial)
    # the row route on the CPU: the multi-channel deposit and gather and
    # the column-count constants, each through its plain version
    table = torch.as_tensor(np.concatenate(
        [np.asarray(j.A), np.zeros((nch, 1))], 1))
    rows = torch.as_tensor(typ)
    rr = tdisp.disp_compute_rows(t, xt, rows, table, t.P, True, True)
    _close(torch.stack(rr.f, -1).numpy(), torch.stack(tr.f, -1).numpy(),
           1e-12)
    _close(float(rr.elong), float(tr.elong), 1e-12)
    _close(rr.virial.numpy(), tr.virial.numpy(), 1e-12)
    # the plain multi-channel deposit is the per-channel deposit
    shim = t.shim()
    meshes = tdisp.deposit_multi_plain(shim, xt, rows, table)
    assert meshes.shape == (nch, *t.grid)
    for ch in range(nch):
        one = tdisp.deposit_multi_plain(shim, xt, rows, table[ch:ch + 1])
        assert torch.equal(one[0], meshes[ch])


def _combined(seed=1):
    x, typ, q, L, j, t = _disp_setups("none", seed)
    box = jmake_box([0, 0, 0], [L] * 3)
    jp = jpppm.setup_pppm(box, q, cutoff=3.2, accuracy_rel=1e-5,
                          qqrd2e=QQRD2E, order=5, acc_dtype=jnp.float64)
    jc = JCombined([jp, JBound(j, typ, typed=True)])
    fields = dict(grid=jp.grid, g_ewald=jp.g_ewald, order=jp.order,
                  greensfn=jp.greensfn, kx=jp.kx, ky=jp.ky, kz=jp.kz,
                  qsum=jp.qsum, qsqsum=jp.qsqsum, qqrd2e=jp.qqrd2e,
                  volume=jp.volume, box_lo=jp.box_lo, h=jp.h)
    dfields = dict(g_ewald_6=j.g_ewald_6, grid=j.grid, order=j.order,
                   greensfn=j.greensfn, kx=j.kx, ky=j.ky, kz=j.kz, B=j.B,
                   volume=j.volume, box_lo=j.box_lo, h=j.h, mix=j.mix,
                   A=j.A, P=j.P, vfac=j.vfac)
    tc = kspace_from_numpy([("pppm", fields), ("disp", dfields, typ, True)])
    return x, q, jc, tc


def test_combined_kspace_matches_jax():
    x, q, jc, tc = _combined()
    n = len(x)
    jr = jc.compute(jnp.asarray(x), jnp.asarray(q))
    tr = tc.compute(torch.as_tensor(x.T.copy()), torch.as_tensor(q))
    _close(torch.stack(tr.f, -1).numpy(), jr.f)
    _close(float(tr.elong), float(jr.elong))
    _close(tr.virial.numpy(), jr.virial)
    # slot order: a permutation of the atoms with empty slots (aid = n,
    # q = 0, finite positions anywhere, outside the box too)
    rng = np.random.default_rng(3)
    perm = rng.permutation(n)
    aid = np.concatenate([perm[:n // 2], [n, n], perm[n // 2:], [n]])
    empty = aid == n
    xs = np.where(empty[:, None], np.array([1.5, -2.0, 9.0]),
                  x[np.minimum(aid, n - 1)])
    qs = np.where(empty, 0.0, q[np.minimum(aid, n - 1)])
    jr = jc.compute_slot(jnp.asarray(xs), jnp.asarray(aid), jnp.asarray(qs))
    tr = tc.compute_slot(torch.as_tensor(xs.T.copy()), torch.as_tensor(aid),
                         torch.as_tensor(qs))
    f = torch.stack(tr.f, -1).numpy()
    _close(f, jr.f)
    assert not f[empty].any()
    _close(float(tr.elong), float(jr.elong))
    _close(tr.virial.numpy(), jr.virial)
    # the atom-order result, permuted
    ta = tc.compute(torch.as_tensor(x.T.copy()), torch.as_tensor(q))
    _close(f[~empty], torch.stack(ta.f, -1).numpy()[aid[~empty]])
    _close(float(tr.elong), float(ta.elong))


def _deck(name):
    with open(os.path.join(DECKS, name)) as f:
        return yaml.safe_load(f)


def _shrunk(name, tmp_path):
    """A new deck at test size in f64: one cristobalite copy at cut 5 /
    skin 0.5 (three cells per axis of the 28.64 x 35.8 x 21.48 box, and the
    dense list), or the 4x4x4 hexane cut-out at cut 5 / skin 1."""
    cfg = _deck(name)
    cfg["precision"] = "double"
    if name.startswith("hexane"):
        data = str(tmp_path / "data.hexane_cut")
        gen_hexane.write(data, 4, 4, 4)
        cfg["read_data"] = data
        cfg["pair_style"]["cut"] = 5.0
        cfg["neighbor"]["skin"] = 1.0
    else:
        cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
        cfg["replicate"] = [1, 1, 1]
        cfg["pair_style"]["cut"] = 5.0
        cfg["neighbor"]["skin"] = 0.5
        cfg["neighbor"]["every"] = 2
    return cfg


@pytest.mark.parametrize("name,engine", [
    ("cristobalite_buck_long.yaml", "CellPairSimulation"),
    ("cristobalite_buck_long_nlist.yaml", "Simulation"),
    ("hexane_gen_arith.yaml", "CellPairSimulation")])
def test_shrunk_deck_matches_jax(name, engine, tmp_path):
    cfg = _shrunk(name, tmp_path)
    jsim = jbuild(copy.deepcopy(cfg))
    tsim = tbuild(copy.deepcopy(cfg), device="cpu")
    assert type(jsim).__name__ == type(tsim).__name__ == engine
    jrows = jsim.run(5, thermo_every=1, log=False)
    trows = tsim.run(5, thermo_every=1, log=False)
    assert len(jrows) == len(trows) == 6
    for jr, tr in zip(jrows, trows):
        for k in ROW_KEYS:
            assert abs(tr[k] - jr[k]) <= 1e-9 * max(abs(jr[k]), 1.0), (
                tr["step"], k, tr[k], jr[k])
    # the solvers are the JAX package's: meshes, splits and channels
    jks = list(getattr(jsim.kspace, "solvers", [jsim.kspace]))
    tks = list(getattr(tsim.kspace, "solvers", [tsim.kspace]))
    assert [type(s).__name__ for s in jks] == [type(s).__name__ for s in tks]
    for js, ts in zip(jks, tks):
        jp, tp = getattr(js, "solver", js), getattr(ts, "solver", ts)
        assert tp.grid == jp.grid and tp.order == jp.order
        if hasattr(jp, "A"):
            assert tp.g_ewald_6 == jp.g_ewald_6 and tp.mix == jp.mix
            assert np.array_equal(tp.A, np.asarray(jp.A))
        else:
            assert tp.g_ewald == jp.g_ewald


@pytest.mark.parametrize("name,ref,changed,mention", [
    ("cristobalite_buck_long.yaml", "silica_pppm.yaml",
     {"pair_style", "kspace_style", "read_data", "replicate"},
     "silica_pppm.yaml"),
    ("cristobalite_buck_long_nlist.yaml", "silica_pppm.yaml",
     {"pair_style", "kspace_style", "read_data", "replicate", "engine"},
     "silica_pppm.yaml"),
    ("hexane_gen_arith.yaml", "hexane.yaml", {"kspace_style", "read_data"},
     "in.hexane")])
def test_new_decks_are_the_reference_lines(name, ref, changed, mention):
    cfg, want = _deck(name), _deck(ref)
    assert set(cfg) == set(want)
    assert {k for k in cfg if cfg[k] != want[k]} == changed
    ks = cfg["kspace_style"]
    if name.startswith("hexane"):
        assert cfg["read_data"] == "examples/data.hexane_gen"
        assert ks == dict(want["kspace_style"], mix="arithmetic")
    else:
        assert cfg["read_data"] == "examples/data.cristobalite"
        assert cfg["replicate"] == [6, 5, 6]
        ps, wps = cfg["pair_style"], want["pair_style"]
        assert ps == dict(wps, name="buck/long/coul/long")
        assert ks == dict(want["kspace_style"], name="pppm/disp",
                          force_disp_real=1.0e-4, mix="none")
        assert cfg["engine"] == ("nlist" if "nlist" in name else "cellpair")
    with open(os.path.join(DECKS, name)) as f:
        head = f.read(600)
    assert mention in head and "mix" in head
