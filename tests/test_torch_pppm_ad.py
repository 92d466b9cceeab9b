"""PPPM with ad differentiation and kspace_modify slab in the port, against
the JAX package.

(a) The self-force sine series (``_sf_sine_fit``, the set-up) equals the
    JAX one to 1e-12.
(b) ``PPPM.compute`` with ad and / or slab, the plain version and the
    staged route that the card runs (here with each stage's plain
    version), equal the JAX ``_pppm_compute_ad`` / ``_pppm_compute`` with
    slab in f64 at 1e-10: on the jittered 1,440-atom cristobalite and on
    the eight-charge slab of tests/test_pppm.py:213.
(c) ``CellPPPM.compute_slots`` with ad, in atom order, equals the JAX
    ``CellPPPM`` (its zblock transfer) in f64.
(d) ``TracedPPPM`` with ad and / or slab equals the JAX ``TracedPPPM`` on
    a stretched box in f64 (the re-fitted series included).
(e) With slab the per-atom energies carry the slab term, so sum(eatom)
    equals elong; the JAX ``compute_peratom`` has no slab term and misses
    it (ROADMAP queue 3).
(f) ``kspace_modify mesh`` reaches the list engine's mesh as in the JAX
    package; the JAX cell engine drops it (its run.py:921-929), and the
    port refuses it there; the dispersion ad and a tilted slab raise.
(g) The shrunk ad and slab decks (``examples/kspace_rest_cases.py``) run
    on the CPU in f64 equal the JAX package's record
    (tests/goldens/torch_kspace_rest.json, written by
    tools/record_kspace_rest.py) at 1e-9.
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
from lammps_buck_intel_tpu.models.kspace import pppm as jpppm
from lammps_buck_intel_tpu.models.kspace import setup_pppm as jsetup
from lammps_buck_intel_tpu_torch.core import make_box as tmake_box
from lammps_buck_intel_tpu_torch.interop import jax_torsion_deck
from lammps_buck_intel_tpu_torch.models.kspace import pppm as tpppm
from lammps_buck_intel_tpu_torch.models.kspace import setup_pppm as tsetup
from lammps_buck_intel_tpu_torch.run import build_simulation

jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "torch_kspace_rest.json")
QQRD2E = 14.399645
RTOL = 1e-10


def _cristobalite(tmp, vacuum=0.0):
    """The jittered 1,440-atom cristobalite (a slab with ``vacuum``):
    positions (N, 3), charges, box lengths."""
    import gen_cristobalite

    x, t, q, hi = gen_cristobalite.build(4, 5, 3)
    if vacuum:
        x = gen_cristobalite.slab_block(x, t, hi) + gen_cristobalite.jitter(
            len(x), 0.1) + np.array([0.0, 0.0, 0.5 * vacuum * hi[2]])
        hi = hi * np.array([1.0, 1.0, 1.0 + vacuum])
    else:
        x = np.mod(x + gen_cristobalite.jitter(len(x), 0.1), hi)
    return x, q, hi


def _eight_charges(charged=False):
    """The four alternating dipole pairs of tests/test_pppm.py:213 in an
    8 x 8 x 12 box (atoms in z [3, 5]); ``charged``: the first charge
    raised by 0.5, so Q = 0.5."""
    rng = np.random.RandomState(4)
    base = np.column_stack([rng.uniform(0, 8.0, 4), rng.uniform(0, 8.0, 4),
                            rng.uniform(3.2, 4.0, 4)])
    d = np.array([0.9, 0.7, 0.5])
    x, q = [], []
    for i, pos in enumerate(base):
        s = 1.0 if i < 2 else -1.0
        x += [pos, pos + s * d]
        q += [s, -s]
    q[0] += 0.5 if charged else 0.0
    return np.asarray(x), np.asarray(q), np.array([8.0, 8.0, 12.0])


def _pair(L, q, **kw):
    kw = dict(dict(cutoff=5.0, accuracy_rel=1e-4, qqrd2e=QQRD2E, order=7),
              **kw)
    return (jsetup(jmake_box([0, 0, 0], L), q, acc_dtype=jnp.float64, **kw),
            tsetup(tmake_box([0, 0, 0], L), q, acc_dtype=torch.float64,
                   **kw))


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rtol * np.abs(b).max(), \
        (np.abs(a - b).max(), np.abs(b).max())


@pytest.mark.parametrize("order,grid", [(5, (12, 15, 9)), (7, (20, 24, 16))])
def test_sf_sine_fit_matches_jax(order, grid):
    L = np.array([12.0, 13.5, 9.0])
    G = tpppm._greens_function(grid, L, 0.35, order)
    t = tpppm._sf_sine_fit(grid, L, G, order)
    j = jpppm._sf_sine_fit(grid, L, G, order)
    assert t.shape == (3, 4)
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12 * np.abs(j).max())


@pytest.mark.parametrize("system,diff,slab", [
    ("cristobalite", "ad", None), ("cristobalite_slab", "ad", 3.0),
    ("eight", "ik", 3.0), ("eight", "ad", 3.0), ("eight_charged", "ad", 3.0)])
def test_pppm_compute_ad_slab_matches_jax(system, diff, slab, tmp_path):
    if system.startswith("eight"):
        x, q, L = _eight_charges(system == "eight_charged")
        jp, tp = _pair(L, q, cutoff=3.0, accuracy_rel=1e-6, qqrd2e=1.0,
                       diff=diff, slab=slab)
    else:
        x, q, L = _cristobalite(tmp_path, 1.0 if slab else 0.0)
        jp, tp = _pair(L, q, diff=diff, slab=slab)
    assert tp.grid == jp.grid and tp.g_ewald == jp.g_ewald
    assert tp.volume == jp.volume and tp.h == tuple(jp.h)
    if diff == "ad":
        np.testing.assert_allclose(tp.sf_sine, jp.sf_sine, rtol=1e-12,
                                   atol=1e-13 * np.abs(jp.sf_sine).max())
    jr = jp.compute(jnp.asarray(x), jnp.asarray(q))
    xt, qt = torch.as_tensor(x.T.copy()), torch.as_tensor(q)
    for r in (tpppm.pppm_compute_plain(tp, xt, qt, True, True),
              tp.compute_staged(xt, qt)):
        _close(torch.stack(r.f).T, jr.f)
        assert abs(float(r.elong) - float(jr.elong)) <= \
            RTOL * abs(float(jr.elong))
        _close(r.virial, jr.virial)


def test_cell_pppm_ad_matches_jax():
    """CellPPPM ad on the slot planes against the JAX CellPPPM (zblock) on
    the same cell-aligned order-7 mesh, forces in atom order."""
    from lammps_buck_intel_tpu import run as jrun
    from lammps_buck_intel_tpu.models.kspace import CellPPPM as JCellPPPM
    from lammps_buck_intel_tpu.neighbor import cell_slots as jcs
    from lammps_buck_intel_tpu_torch.interop import slot_state_from_numpy
    from lammps_buck_intel_tpu_torch.models.kspace import CellPPPM

    x, q, L = _cristobalite(None)
    n, skin = len(q), 0.5
    box = jmake_box([0, 0, 0], L)
    grid = jcs.make_grid(n, L, 5.5)
    st = jcs.from_atoms(grid, box, x, np.zeros_like(x),
                        np.zeros((n, 3), np.int32), np.zeros(n, np.int32),
                        q, dtype=jnp.float64)
    kgrid = grid.coarse()
    nc = np.asarray(kgrid.nc)
    smin = jrun._patch_aligned_smin(nc, L, skin, 7)
    kw = dict(multiple_of=kgrid.nc, diff="ad",
              grid_min=tuple(int(s * c) for s, c in zip(smin, nc)))
    jp, tp = _pair(L, q, **kw)
    assert jp.grid == tp.grid
    jfx, jfy, jfz, jel, jvir = JCellPPPM(jp, grid, skin=skin).compute_slots(
        st, True, True)
    planes = {k: np.asarray(v) for k, v in
              jax.device_get(st._asdict()).items() if v is not None}
    tst = slot_state_from_numpy(planes, device="cpu")
    tfx, tfy, tfz, tel, tvir = CellPPPM(tp, n).compute_slots(tst, True, True)
    aid = planes["aid"]
    live = aid < n
    fj = np.zeros((n, 3))
    ft = np.zeros((n, 3))
    fj[aid[live]] = np.stack([np.asarray(a) for a in (jfx, jfy, jfz)],
                             -1)[live]
    ft[aid[live]] = torch.stack([tfx, tfy, tfz], -1).numpy()[live]
    _close(ft, fj, 1e-9)
    assert abs(float(tel) - float(jel)) <= RTOL * abs(float(jel))
    _close(tvir, jvir, 1e-9)
    assert bool((tfx[torch.as_tensor(~live)] == 0).all())


@pytest.mark.parametrize("diff,slab", [("ad", None), ("ik", 3.0),
                                       ("ad", 3.0)])
def test_traced_pppm_ad_slab_matches_jax(diff, slab):
    """TracedPPPM with ad / slab on a stretched box (the test_npt.py:395
    variants) against the JAX TracedPPPM: tables, re-fitted series and the
    force pass."""
    from lammps_buck_intel_tpu.models.kspace import TracedPPPM as JTraced
    from lammps_buck_intel_tpu_torch.models.kspace.pppm_npt import TracedPPPM

    x, q, L = _eight_charges()
    jp, tp = _pair(L, q, cutoff=3.0, accuracy_rel=1e-4, qqrd2e=1.0, order=5,
                   diff=diff, slab=slab)
    jt, tt = JTraced(jp, center=0.5 * L), TracedPPPM(tp, 0.5 * L)
    s = np.array([1.04, 0.98, 1.03])
    L1 = L * s
    x1 = x * s + 0.5 * (L - L1)
    jk = jt.tables(jnp.asarray(L1))
    tk = tt.tables(torch.as_tensor(L1))
    _close(tk["G"], jk["G"])
    if diff == "ad":
        _close(tk["sf"], jk["sf"], 1e-9)
    jr = jt.compute_traced(jnp.asarray(x1), jnp.asarray(q), jnp.asarray(L1))
    tr = tt.compute_traced(torch.as_tensor(x1.T.copy()), torch.as_tensor(q),
                           torch.as_tensor(L1), kc=tk)
    _close(torch.stack(tr.f).T, jr.f)
    assert abs(float(tr.elong) - float(jr.elong)) <= \
        RTOL * abs(float(jr.elong))
    _close(tr.virial, jr.virial)


def test_slab_peratom_pins_to_elong():
    """With slab each atom gets its share of the slab energy (the eatom
    tally of host LAMMPS slabcorr()): sum(eatom) equals elong, and the
    virial shares the virial; the JAX compute_peratom, without the term,
    misses elong by e_slab."""
    x, q, L = _cristobalite(None, vacuum=1.0)
    jp, tp = _pair(L, q, slab=3.0)
    xt, qt = torch.as_tensor(x.T.copy()), torch.as_tensor(q)
    r = tp.compute(xt, qt)
    eat, vat = tpppm.compute_peratom(tp, xt, qt)
    assert abs(float(eat.sum() - r.elong)) <= 1e-9 * abs(float(r.elong))
    _close(vat.sum(0), r.virial, 1e-9)
    je, _ = jpppm.compute_peratom(jp, jnp.asarray(x), jnp.asarray(q))
    e_slab, _ = tpppm.slab_correction_plain(tp, xt[2], qt, True)
    miss = float(jnp.sum(je)) - float(r.elong)
    assert abs(miss + float(e_slab)) <= 1e-8 * abs(float(r.elong))
    assert abs(float(e_slab)) > 1e-3


@pytest.mark.parametrize("system", ["eight_charged", "cristobalite"])
def test_slab_correction_charged_matches_jax(system):
    """K10 slab's plain version with a non-zero total charge (the -Q z_i
    of fz, the -Q M2 - Q^2 zprd^2 / 12 of e_slab) against the JAX
    slab_correction at 1e-10; its per-atom shares sum to e_slab."""
    if system == "eight_charged":
        x, q, L = _eight_charges(True)
        kw = dict(cutoff=3.0, accuracy_rel=1e-6, qqrd2e=1.0)
    else:
        x, q, L = _cristobalite(None, vacuum=1.0)
        q = q + 0.05
        kw = {}
    jp, tp = _pair(L, q, slab=3.0, **kw)
    assert abs(tp.qsum) > 0.4 and tp.qsum == jp.qsum
    je, jf = jpppm.slab_correction(jp, jnp.asarray(x), jnp.asarray(q), True)
    xt, qt = torch.as_tensor(x.T.copy()), torch.as_tensor(q)
    te, tf = tpppm.slab_correction_plain(tp, xt[2], qt, True)
    assert abs(float(te) - float(je)) <= RTOL * abs(float(je))
    _close(tf, jf)
    eat = tpppm.slab_peratom_plain(tp, xt[2], qt)
    assert abs(float(eat.sum() - te)) <= RTOL * abs(float(te))


def _slab_deck(**ks):
    import kspace_rest_cases as kc

    cfg = kc.load_deck("cristobalite_pppm_nlist.yaml")
    cfg.update(read_data=os.path.join(ROOT, "examples",
                                      "data.cristobalite"),
               replicate=[1, 1, 1], precision="double", run=0)
    cfg["pair_style"]["cut"] = 5.0
    cfg["neighbor"]["skin"] = 0.5
    cfg["kspace_style"].update(ks)
    return cfg


def test_mesh_key_on_both_packages():
    """kspace_modify mesh: the list engine solves on the deck's grid in
    both packages; the JAX cell engine rebuilds its cell-aligned mesh and
    drops the grid (the quirk ROADMAP queue 3 records), which the port
    refuses rather than ignore."""
    from lammps_buck_intel_tpu.run import build_simulation as jbuild

    grid = [30, 40, 24]
    cfg = _slab_deck(grid=grid)
    assert list(build_simulation(cfg, device="cpu").kspace.grid) == grid
    assert list(jbuild(_slab_deck(grid=grid)).kspace.grid) == grid
    cell = _slab_deck(grid=grid)
    cell["engine"] = "cellpair"
    jsim = jbuild(cell)
    assert type(jsim).__name__ == "CellPairSimulation"
    assert list(jsim.kspace.pm.grid) != grid
    with pytest.raises(NotImplementedError, match="item 10.*engine nlist"):
        build_simulation(_slab_deck(grid=grid) | {"engine": "cellpair"},
                         device="cpu")


def test_remaining_refusals():
    """The dispersion ad (the next slice) and a tilted slab (item 14)
    raise."""
    import yaml

    from lammps_buck_intel_tpu_torch.models.kspace import setup_pppm_disp

    with open(os.path.join(ROOT, "examples", "decks",
                           "hexane_gen.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["kspace_style"]["diff"] = "ad"
    with pytest.raises(NotImplementedError, match="item 10.*dispersion ad"):
        build_simulation(cfg, device="cpu")
    box = tmake_box([0, 0, 0], [10.0] * 3)
    with pytest.raises(NotImplementedError, match="item 10.*dispersion ad"):
        setup_pppm_disp(box, [1.0], np.zeros(4, np.int32), cutoff=4.0,
                        g_ewald_6=0.3, diff="ad")
    with pytest.raises(NotImplementedError, match="item 14"):
        tsetup(tmake_box([0, 0, 0], [10.0] * 3, tilt=(1.0, 0.0, 0.0)),
               np.array([1.0, -1.0]), cutoff=4.0, accuracy_rel=1e-4,
               qqrd2e=1.0, slab=3.0)


def _record():
    with open(GOLDEN) as f:
        return json.load(f)


def run_case(name, tmp, device="cpu"):
    """The port's run of a recorded case: (sim, step-0 forces (N, 3),
    rows, final atoms)."""
    import kspace_rest_cases as kc

    _, _, _, steps, every = kc.CASES[name]
    # the records are the JAX package's: its torsion angle
    sim = build_simulation(jax_torsion_deck(kc.deck_cfg(name, tmp)),
                           device=device)
    f0 = sim.get_atoms()["f"]
    rows = sim.run(steps, thermo_every=every, log=False)
    return sim, f0, rows, sim.get_atoms()


def check_case(name, rec, sim, f0, rows, at, rtol=1e-9):
    """The port's run against the record's: solver, forces, rows, final
    positions and image flags."""
    assert type(sim).__name__ == rec["engine"]
    ks = sim.kspace
    pm = getattr(ks, "pm", ks)
    assert type(ks).__name__ == rec["kspace"]
    assert abs(float(pm.g_ewald) - rec["g_ewald"]) <= 1e-12 * rec["g_ewald"]
    if "grid" in rec:
        assert list(pm.grid) == rec["grid"] and pm.diff == rec["diff"]
    if "n_k" in rec:
        assert pm.kvecs.shape[0] == rec["n_k"]
    pick = np.asarray(rec["atoms"])
    ref_f = np.asarray(rec["f0"])
    assert np.abs(f0[pick] - ref_f).max() <= rtol * np.abs(ref_f).max()
    assert [r["step"] for r in rows] == [r["step"] for r in rec["rows"]]
    for row, ref in zip(rows, rec["rows"]):
        for k, v in ref.items():
            if k != "step":
                assert abs(row[k] - v) <= rtol * max(abs(v), 1e-8), \
                    (name, ref["step"], k, row[k], v)
    L = float(np.max(sim.box.lengths))
    assert np.abs(at["x"][pick] - np.asarray(rec["x_end"])).max() <= \
        rtol * L
    np.testing.assert_array_equal(at["image"][pick],
                                  np.asarray(rec["image_end"]))


@pytest.mark.parametrize("name", ["pppm_ad_cell", "pppm_ad_nlist", "slab"])
def test_kspace_rest_deck_matches_record(name, tmp_path):
    rec = _record()["cases"][name]
    check_case(name, rec, *run_case(name, str(tmp_path)))


def test_slab_deck_pe_atom_pins_to_thermo(tmp_path):
    """compute pe/atom (what dump custom's c_pe writes) on the shrunk
    cristobalite_slab deck: its sum equals the thermo row's epair, the
    slab term's per-atom shares included (the computes run in f32)."""
    import kspace_rest_cases as kc
    from lammps_buck_intel_tpu_torch.computes import pe_atom

    sim = build_simulation(kc.deck_cfg("slab", str(tmp_path)), device="cpu")
    assert sim.kspace.slab == 3.0
    row = sim.run(0, thermo_every=1, log=False)[-1]
    pe = float(pe_atom(sim).sum())
    assert abs(pe - row["epair"]) <= 2e-6 * abs(row["epair"]), \
        (pe, row["epair"])
