"""Host layer of the PyTorch port against the JAX package (CPU).

Lattice, velocity seeding (numpy and RanPark streams), boxes, units and
systems must give arrays identical to the JAX package's; the port must
import without jax; unported deck features and a missing GPU must raise.
Deck routing follows the JAX package's: ``engine: nlist`` and a deck
without ``engine:`` build the neighbor-list ``Simulation``, as does a
cell-engine deck whose box is too small (buck_small.yaml); the
neighbor-list deck front end builds the JAX run.py's generic PPPM mesh
and g_ewald (cristobalite_pppm_nlist.yaml at full size, host set-up
only).
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from lammps_buck_intel_tpu import core as jcore
from lammps_buck_intel_tpu.io import lattice as jlattice
from lammps_buck_intel_tpu.io import velocity as jvelocity
from lammps_buck_intel_tpu_torch import core as tcore
from lammps_buck_intel_tpu_torch.io import lattice as tlattice
from lammps_buck_intel_tpu_torch.io import velocity as tvelocity
from lammps_buck_intel_tpu_torch.run import build_simulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = os.path.join(ROOT, "examples", "decks")


def _deck(name="buck.yaml"):
    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    cfg["lattice"].update(nx=6, ny=6, nz=6)
    return cfg


@pytest.mark.parametrize("style,dims", [("fcc", (3, 4, 5)), ("bcc", (4, 4, 4)),
                                        ("sc", (2, 3, 4))])
def test_create_atoms_identical(style, dims):
    a = jlattice.create_atoms(style, 0.8442, *dims)
    b = tlattice.create_atoms(style, 0.8442, *dims)
    for u, v in zip(a, b):
        assert np.array_equal(u, v)
    assert (jlattice.lattice_constant(style, 0.8442)
            == tlattice.lattice_constant(style, 0.8442))


@pytest.mark.parametrize("rng,dist", [("numpy", "gaussian"),
                                      ("numpy", "uniform"),
                                      ("lammps", "gaussian"),
                                      ("lammps", "uniform")])
def test_velocity_create_identical(rng, dist):
    n = 200
    mass = np.where(np.arange(n) % 3 == 0, 2.0, 1.0)
    kw = dict(dist=dist, rng=rng)
    a = jvelocity.create(n, 1.44, 87287, mass, jcore.LJ, **kw)
    b = tvelocity.create(n, 1.44, 87287, mass, tcore.LJ, **kw)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["lj", "real", "metal"])
def test_units_identical(name):
    a, b = jcore.get_units(name), tcore.get_units(name)
    for field in ("boltz", "hplanck", "mvv2e", "ftm2v", "mv2d", "nktv2p",
                  "qqr2e", "qe2f", "dt", "skin", "qqrd2e"):
        assert getattr(a, field) == getattr(b, field)


def test_make_box_identical():
    lo, hi = np.array([-1.0, 0.5, 2.0]), np.array([10.0, 12.25, 9.5])
    a, b = jcore.make_box(lo, hi), tcore.make_box(lo, hi)
    assert np.array_equal(a.lengths, b.lengths)
    assert a.volume == b.volume
    assert np.array_equal(a.perp_widths, b.perp_widths)
    with pytest.raises(NotImplementedError):
        tcore.make_box(lo, hi, tilt=(0.5, 0.0, 0.0))


def test_make_system_identical():
    x, lo, hi = tlattice.create_atoms("fcc", 0.8442, 3, 3, 3)
    n = len(x)
    v = np.random.default_rng(0).normal(size=(n, 3))
    typ = np.arange(n) % 2
    a = jcore.make_system(x, jcore.make_box(lo, hi), type=typ, v=v,
                          mass=[1.0, 2.0], dtype=np.float64)
    b = tcore.make_system(x, tcore.make_box(lo, hi), type=typ, v=v,
                          mass=[1.0, 2.0], dtype=torch.float64, device="cpu")
    for f in ("x", "v", "q", "type", "image", "mass", "molecule"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              getattr(b, f).numpy()), f
    assert a.n_types == b.n_types == 2


def test_precision_modes():
    assert tcore.get_precision("mixed").acc == torch.float64
    assert tcore.get_precision("single").flt == torch.float32
    with pytest.raises(NotImplementedError):
        tcore.get_precision("single_comp")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import lammps_buck_intel_tpu_torch, lammps_buck_intel_tpu_torch.run\n"
        "import lammps_buck_intel_tpu_torch.interop\n"
        "import lammps_buck_intel_tpu_torch.ops.cellpair\n"
        "import lammps_buck_intel_tpu_torch.ops.rebin\n"
        "import lammps_buck_intel_tpu_torch.ops.pppm\n"
        "import lammps_buck_intel_tpu_torch.ops.bonded\n"
        "import lammps_buck_intel_tpu_torch.models.bonded\n"
        "import lammps_buck_intel_tpu_torch.integrate.nvt\n"
        "import lammps_buck_intel_tpu_torch.models.kspace\n"
        "import lammps_buck_intel_tpu_torch.io.data_reader\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'lammps_buck_intel_tpu' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_jax():
    """No source file of the port, and not chip_smoke.py, imports jax or
    the JAX package (scanned as text: an import inside a function that
    the CPU tests never reach counts too)."""
    import re

    bad = re.compile(r"^\s*(import|from)\s+(jax\b|lammps_buck_intel_tpu\b)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT,
                                            "lammps_buck_intel_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    names = {os.path.relpath(p, ROOT) for p in files}
    pkg = "lammps_buck_intel_tpu_torch"
    for new in ("models/bonded/harmonic.py", "models/bonded/charmm.py",
                "ops/bonded.py", "integrate/nvt.py"):
        assert os.path.join(pkg, new) in names, new
    for path in files:
        with open(path) as f:
            m = bad.search(f.read())
        assert m is None, (path, m.group(0) if m else None)


def test_cuda_requested_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        build_simulation(_deck(), device="cuda")


@pytest.mark.parametrize("change", [
    {"kspace_style": {"name": "pppm", "accuracy": 1e-4}},
    {"kspace_style": {"name": "ewald", "accuracy": 1e-4, "slab": 3.0},
     "pair_style": {"name": "buck/coul/long", "cut": 2.5,
                    "coeffs": {"1 1": [1.0, 0.2, -0.8]}}},
    {"kspace_style": {"name": "pppm", "accuracy": 1e-4,
                      "grid": [12, 12, 12]},
     "pair_style": {"name": "buck/coul/long", "cut": 2.5,
                    "coeffs": {"1 1": [1.0, 0.2, -0.8]}}},
    {"pair_style": {"name": "buck/coul/cut", "cut": 2.5,
                    "coeffs": {"1 1": [1.0, 0.2, -0.8]}},
     "kspace_style": {"name": "ewald", "accuracy": 1e-4}},
    {"replicate": [2, 2, 2]},
    {"fixes": [{"name": "npt", "t_start": 1.0, "t_damp": 0.1,
                "iso": [0.0, 0.0, 1.0], "xy": [0.0, 0.0, 1.0]}]},
    {"engine": "slab"},
    {"fixes": [{"name": "nvt", "t_start": 1.0, "t_damp": 0.1, "drag": 0.2}]},
    {"pair_style": {"name": "buck/coul/long", "cut": 2.5,
                    "coeffs": {"1 1": [1.0, 0.2, -0.8]}}},
    {"dump": {"file": "x.lammpstrj", "style": "local"}},
    {"write_restart": "x.restart"},
])
def test_unported_deck_raises(change):
    cfg = copy.deepcopy(_deck())
    cfg.update(change)
    with pytest.raises(NotImplementedError):
        build_simulation(cfg, device="cpu")


def _rhodo(name="rhodo_flex_nve.yaml"):
    with open(os.path.join(DECKS, name)) as f:
        cfg = yaml.safe_load(f)
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    cfg["replicate"] = [1, 1, 1]
    return cfg


@pytest.mark.parametrize("change,match", [
    ({"fixes": [{"name": "shake", "m": 1.0, "t": [2]}]}, "item 12.*K13"),
    ({"fixes": [{"name": "rigid/npt/small"}]}, "item 13"),
    ({"fixes": [{"name": "npt", "t_start": 300.0, "t_damp": 50.0,
                 "tri": [0.0, 0.0, 1000.0]}]}, "item 14"),
    ({"kspace_style": {"name": "ewald", "accuracy": 1e-4, "slab": 3.0}},
     "item"),
    ({"kspace_style": {"name": "pppm/disp", "accuracy": 1e-4}}, "item"),
    ({"exclude_intra": True, "engine": "nlist"}, "item 13"),
    ({"angle_style": {"name": "cosine/squared", "coeffs": [[1.0, 100.0]]}},
     "angle_style"),
    ({"dihedral_style": {"name": "opls", "coeffs": [[1.0, 1.0, 1.0, 1.0]]}},
     "dihedral_style"),
])
def test_unported_molecular_deck_raises(change, match):
    """Neighbours of the rhodo decks that the port does not run (a fix
    shake keyword it does not read among them) raise, naming the ROADMAP
    item."""
    cfg = _rhodo()
    cfg.update(change)
    with pytest.raises(NotImplementedError, match=match):
        build_simulation(cfg, device="cpu")


@pytest.mark.parametrize("name", ["rhodo_nve.yaml", "rhodo_32k.yaml",
                                  "rhodo_class.yaml"])
def test_literal_rhodo_decks_raise_for_shake(name):
    """The literal decks build with their fix shake (the 864 C-H bonds of
    one copy, 3N - 3 - Nc degrees of freedom); only a fix shake keyword
    the port does not read raises, naming K13."""
    cfg = _rhodo(name)
    sim = build_simulation(copy.deepcopy(cfg), device="cpu")
    assert sim.shake.n_constraints == 864
    assert sim.dof == 3 * sim.n_atoms - 3 - 864
    assert (sim.thermostat is None) == (name == "rhodo_nve.yaml")
    cfg["fixes"][0]["t"] = [2]
    with pytest.raises(NotImplementedError, match="shake.*K13"):
        build_simulation(cfg, device="cpu")


def test_flex_decks_differ_from_theirs_by_the_shake_fix_only():
    for flex, orig in (("rhodo_flex_nve.yaml", "rhodo_nve.yaml"),
                       ("rhodo_flex_nvt.yaml", "rhodo_32k.yaml")):
        a, b = _rhodo(flex), _rhodo(orig)
        fixes = [f for f in b.pop("fixes") if f["name"] != "shake"]
        assert a.pop("fixes") == (fixes or [{"name": "nve"}])
        assert a == b


def test_special_bonds_forms():
    from lammps_buck_intel_tpu_torch.run import _special_factors

    assert _special_factors({"special_bonds": "charmm"}) == (
        (1.0, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0))
    assert _special_factors({"special_bonds": "amber"}) == (
        (1.0, 0.0, 0.0, 0.5), (1.0, 0.0, 0.0, 1.0 / 1.2))
    assert _special_factors({"special_bonds": [0.0, 0.5, 1.0]}) == (
        (1.0, 0.0, 0.5, 1.0), (1.0, 0.0, 0.5, 1.0))
    assert _special_factors({"special_bonds": [0.0, 0.0, 0.0],
                             "special_bonds_coul": [0.0, 0.0, 0.5]})[1] \
        == (1.0, 0.0, 0.0, 0.5)
    assert _special_factors({"special_bonds": {"lj/coul": [0.0, 0.0, 0.5]}}) \
        == ((1.0, 0.0, 0.0, 0.5), (1.0, 0.0, 0.0, 0.5))
    assert _special_factors({"special_bonds": {"coul": [0.0, 0.0, 1.0]}}) == (
        (1.0, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 1.0))
    assert _special_factors({}) == ((1.0,) * 4, (1.0,) * 4)
    with pytest.raises(ValueError, match="special_bonds"):
        _special_factors({"special_bonds": "opls"})


def test_new_entry_points_default_to_the_card():
    """Every entry point that places tensors defaults to the card; the
    tests pass device="cpu"."""
    import inspect

    from lammps_buck_intel_tpu_torch import interop, run

    for fn in (run.build_simulation, run.run_deck, tcore.make_system,
               interop.slot_state_from_numpy, interop.md_state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__name__
    # make_special_table takes the device without a default: the engine
    # passes its own
    from lammps_buck_intel_tpu_torch.models.pair import make_special_table

    assert inspect.signature(make_special_table).parameters[
        "device"].default is inspect.Parameter.empty


def test_thermostat_target_ramps_over_the_run():
    cfg = _rhodo("rhodo_flex_nvt.yaml")
    cfg["fixes"] = [{"name": "nvt", "t_start": 300.0, "t_stop": 400.0,
                     "t_damp": 50.0}]
    sim = build_simulation(cfg, device="cpu")
    assert sim.thermostat.tchain == 3 and sim.state.therm.shape == (2, 3)
    assert sim.thermostat.dt == 1.0 and sim.thermostat.boltz == sim.units.boltz
    sim._run_total, sim._run_done = 100, 0
    assert sim._t_target(ahead=50) == 350.0
    sim._run_done = 50
    assert sim._t_target(ahead=50) == 400.0 == sim._t_target(ahead=500)
    sim._run_total = 0
    assert sim._t_target() == 300.0


@pytest.mark.parametrize("engine", ["nlist", None])
def test_nlist_decks_build_simulation(engine):
    from lammps_buck_intel_tpu_torch.integrate import Simulation

    cfg = _deck()
    if engine is None:
        del cfg["engine"]
    else:
        cfg["engine"] = engine
    sim = build_simulation(cfg, device="cpu")
    assert isinstance(sim, Simulation) and sim.n_atoms == 864
    assert not sim.spec.dense and min(sim.spec.nc) >= 3


def test_small_box_falls_back_to_simulation():
    """buck_small.yaml asks for the cell engine; its 2 cells per axis are
    too few, so the deck runner builds the neighbor-list engine with the
    dense build, as the JAX package does.  cap (the cell engine's) is then
    refused, not ignored."""
    from lammps_buck_intel_tpu_torch.integrate import Simulation

    with open(os.path.join(DECKS, "buck_small.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert cfg["engine"] == "cellpair"
    sim = build_simulation(copy.deepcopy(cfg), device="cpu")
    assert isinstance(sim, Simulation) and sim.n_atoms == 500
    assert sim.spec.dense
    cfg["cap"] = 40
    with pytest.raises(NotImplementedError, match="cap"):
        build_simulation(cfg, device="cpu")


@pytest.mark.parametrize("change,match", [
    ({"engine": "slab"}, "item 16"),
    ({"devices": 2}, "item 16"),
    ({"devices_2d": [2, 2]}, "item 16"),
    ({"exclude_intra": True, "engine": "nlist"}, "item 13"),
    ({"engine": "nlist", "cap": 40}, "cap"),
])
def test_nlist_unported_forms_raise(change, match):
    cfg = _deck()
    cfg.update(change)
    with pytest.raises(NotImplementedError, match=match):
        build_simulation(cfg, device="cpu")


def test_unknown_engine_raises():
    cfg = _deck()
    cfg["engine"] = "verlet"
    with pytest.raises(ValueError, match="unknown engine"):
        build_simulation(cfg, device="cpu")


def test_nlist_front_end_matches_jax_mesh(monkeypatch):
    """cristobalite_pppm_nlist.yaml at its full 259,200 atoms: the port's
    deck runner and the JAX run.py build the same generic PPPM mesh and
    g_ewald.  Host set-up only: both engines are stubbed out and the
    influence function (which no mesh size depends on) is skipped."""
    import lammps_buck_intel_tpu.integrate as jint
    import lammps_buck_intel_tpu_torch.integrate as tint
    from lammps_buck_intel_tpu import run as jrun
    from lammps_buck_intel_tpu.models.kspace import pppm as jpppm
    from lammps_buck_intel_tpu_torch.models.kspace import pppm as tpppm

    class Stub:
        def __init__(self, system, style, **kw):
            self.n_atoms = system.x.shape[0]
            self.style, self.kspace = style, kw["kspace"]

    def no_g(grid, *a, **k):
        return np.zeros(grid)

    for mod, stub in ((jint, "Simulation"), (tint, "Simulation")):
        monkeypatch.setattr(mod, stub, Stub)
    monkeypatch.setattr(jpppm, "_greens_function", no_g)
    monkeypatch.setattr(tpppm, "_greens_function", no_g)
    monkeypatch.chdir(ROOT)
    with open(os.path.join(DECKS, "cristobalite_pppm_nlist.yaml")) as f:
        cfg = yaml.safe_load(f)
    j = jrun.build_simulation(copy.deepcopy(cfg))
    t = build_simulation(copy.deepcopy(cfg), device="cpu")
    assert t.n_atoms == j.n_atoms == 259200
    assert t.kspace.grid == tuple(j.kspace.grid)
    assert t.kspace.order == j.kspace.order == 7
    assert abs(t.kspace.g_ewald - j.kspace.g_ewald) <= 1e-14
    assert t.style.g_ewald == t.kspace.g_ewald
    np.testing.assert_allclose(t.kspace.h, np.asarray(j.kspace.h),
                               rtol=1e-14)
