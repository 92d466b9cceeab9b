"""Dumps of the port (``io.dump``, the ``dump`` block of ``run_deck``)
against the JAX package's writers (CPU).

(a) ``write_lammpstrj``, ``write_xyz``, ``write_custom`` and
    ``write_image`` write the bytes the JAX package's writers write for
    the same engine state (the JAX writers read the port's engine through
    ``get_atoms``; its native lammpstrj writer is switched off, its
    Python writer is the format; its ``write_custom`` is given the port's
    compute values), on one jittered copy of examples/data.cristobalite
    on the neighbor-list engine; ``read_lammpstrj`` reads what the JAX
    package's reads, and every value reads back as its ``%.8g``.
(b) One ``dump custom`` frame with c_pe and c_stress runs the pair and
    k-space passes once (the frame cache).
(c) ``run_deck`` with a dump block: frames at step 0 and every ``every``
    steps, each frame's sum of c_pe equal to the thermo row's epair (5e-4
    of it, the f32 gate of the JAX package's tests/test_computes.py) and
    -trace(sum c_stress) / (3 V) to press (2e-4); ``style: xyz`` writes
    xyz frames; the frames' seconds are kept apart from the run's.
(d) The dump block is checked (keys, style, columns, scopes); a
    dispersion deck's c_pe runs, and raises only for a scope without a
    per-atom form.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from lammps_buck_intel_tpu_torch import computes
from lammps_buck_intel_tpu_torch.io import dump as tdump
from lammps_buck_intel_tpu_torch.run import build_simulation, run_deck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import peratom_cases as rec  # noqa: E402

COLS = ["id", "type", "x", "y", "z", "vx", "fz", "q", "c_pe",
        "c_stress[1]", "c_stress[2]", "c_stress[3]", "c_stress[4]",
        "c_stress[5]", "c_stress[6]"]


@pytest.fixture(scope="module")
def jitter(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dump") / "data.cris_jitter")
    rec.write_jitter(path)
    return path


def _deck(jitter, **kw):
    """The silica_pppm case of examples/peratom_cases.py at the deck's own
    precision (single)."""
    cfg = rec.case_config("silica_pppm", jitter)
    cfg.update(precision="single", **kw)
    return cfg


@pytest.fixture(scope="module")
def sim(jitter):
    return build_simulation(_deck(jitter), device="cpu")


def test_writers_match_jax(sim, tmp_path, monkeypatch):
    from lammps_buck_intel_tpu import computes as jcomputes
    from lammps_buck_intel_tpu.io import dump as jdump
    from lammps_buck_intel_tpu.io import fastdata

    monkeypatch.setattr(fastdata, "write_lammpstrj_frame",
                        lambda *a, **k: False)
    cache = {}
    values = {"pe/atom": computes.pe_atom(sim, cache=cache).numpy(),
              "stress/atom": computes.stress_atom(sim,
                                                  cache=cache).numpy()}
    monkeypatch.setattr(jcomputes, "evaluate",
                        lambda s, name, scope=None, cache=None: values[name])
    for kind in ("lammpstrj", "xyz", "custom", "image"):
        paths = [str(tmp_path / f"{who}.{kind}") for who in ("t", "j")]
        for mod, path in zip((tdump, jdump), paths):
            for append in (False, True):   # two frames in one file
                if kind == "custom":
                    mod.write_custom(path, sim, COLS, append=append)
                elif kind == "lammpstrj":
                    mod.write_lammpstrj(path, sim, append=append)
                elif kind == "xyz":
                    mod.write_xyz(path, sim, append=append)
                else:
                    mod.write_image(path, sim, size=128)
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read(), kind
    frames = tdump.read_lammpstrj(paths[0].replace("image", "custom"))
    jframes = jdump.read_lammpstrj(paths[0].replace("image", "custom"))
    assert len(frames) == 2 and frames[0]["cols"] == COLS
    for f, g in zip(frames, jframes):
        assert f["step"] == g["step"] and f["cols"] == g["cols"]
        for k in ("lo", "hi", "data"):
            assert np.array_equal(f[k], g[k]), k
    d = frames[0]["data"]
    assert d.shape == (sim.n_atoms, len(COLS))
    want = np.column_stack([values["pe/atom"], values["stress/atom"]])
    as8g = np.vectorize(lambda v: float(f"{v:.8g}"))
    assert np.array_equal(d[:, COLS.index("c_pe"):], as8g(want))
    assert np.array_equal(d[:, 0], np.arange(1, sim.n_atoms + 1))


def test_frame_cache_runs_passes_once(sim, tmp_path, monkeypatch):
    calls = {"pair": 0, "kspace": 0}
    for key in calls:
        orig = getattr(computes, f"_{key}_peratom")

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(computes, f"_{key}_peratom", counted)
    tdump.write_custom(str(tmp_path / "f.dump"), sim,
                       ["id", "c_pe", "c_stress[1]", "c_stress[4]"],
                       append=False)
    assert calls == {"pair": 1, "kspace": 1}


def test_run_deck_dump_frames_pin_to_thermo(jitter, tmp_path):
    path = str(tmp_path / "run.dump")
    cfg = _deck(jitter, run=4, thermo=2,
                dump=dict(style="custom", every=2, file=path,
                          columns=COLS))
    sim, rows = run_deck(cfg, device="cpu", log=False)
    frames = tdump.read_lammpstrj(path)
    assert [f["step"] for f in frames] == [0, 2, 4]
    assert sim.timings["dump"] > 0.0
    vol = float(np.prod(np.asarray(sim.box.lengths)))
    by_step = {r["step"]: r for r in rows}
    for f in frames:
        row, d = by_step[f["step"]], f["data"]
        pe = d[:, COLS.index("c_pe")].sum()
        assert abs(pe - row["epair"]) <= 5e-4 * abs(row["epair"])
        press = -d[:, COLS.index("c_stress[1]"):
                   COLS.index("c_stress[3]") + 1].sum() / (3.0 * vol)
        assert abs(press - row["press"]) <= 2e-4 * max(abs(row["press"]),
                                                        1.0)
    xyz = str(tmp_path / "run.xyz")
    run_deck(_deck(jitter, run=2, thermo=2,
                   dump=dict(style="xyz", every=1, file=xyz)),
             device="cpu", log=False)
    with open(xyz) as fh:
        lines = fh.read().splitlines()
    n = int(lines[0])
    assert len(lines) == 3 * (n + 2)
    assert [lines[k * (n + 2) + 1] for k in range(3)] == [
        "step 0", "step 1", "step 2"]


@pytest.mark.parametrize("dump, err", [
    (dict(style="custom", every=5, file="f", fmt="%g"), NotImplementedError),
    (dict(style="atom", file="f"), NotImplementedError),
    (dict(style="custom", file="f", columns=["id", "c_ke"]),
     NotImplementedError),
    (dict(style="lammpstrj", file="f", columns=["id"]), ValueError),
    (dict(style="custom", file="f", columns=["c_pe"], scope=["fix"]),
     NotImplementedError),
    (dict(style="custom", file="f", columns=["c_pe"],
          scopes={"ke": ["pair"]}), ValueError),
    (dict(style="custom", every=0, file="f"), ValueError),
    (dict(style="custom", columns=["id"]), ValueError),
])
def test_dump_block_is_checked(jitter, dump, err):
    with pytest.raises(err):
        build_simulation(_deck(jitter, dump=dump), device="cpu")


def test_dispersion_deck_c_pe_raises(tmp_path):
    """A pppm/disp deck's dump custom c_pe runs (the Coulomb PPPM and the
    no-mix dispersion channels per atom: the frame's sum equals the thermo
    row's epair within 5e-4) and raises only for a scope without a
    per-atom form; the pair scope alone runs too."""
    with open(os.path.join(ROOT, "examples", "decks",
                           "cristobalite_buck_long.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["read_data"] = os.path.join(ROOT, cfg["read_data"])
    cfg.update(replicate=[1, 1, 1], run=0, engine="nlist",
               dump=dict(style="custom", file=str(tmp_path / "d.dump"),
                         columns=["id", "c_pe"]))
    cfg["pair_style"] = dict(cfg["pair_style"], cut=5.0)
    cfg["neighbor"] = dict(cfg["neighbor"], skin=0.5)
    cfg["kspace_style"] = dict(cfg["kspace_style"], accuracy=1e-2,
                               force_disp_real=1e-2)
    sim, _ = run_deck(copy.deepcopy(cfg), device="cpu", log=False)
    d = tdump.read_lammpstrj(cfg["dump"]["file"])[0]["data"]
    epair = sim.thermo()["epair"]
    assert np.isfinite(d).all() and d.shape == (sim.n_atoms, 2)
    assert abs(d[:, 1].sum() - epair) <= 5e-4 * abs(epair)
    cfg["dump"]["scope"] = ["pair", "fix"]
    with pytest.raises(NotImplementedError, match="scope"):
        run_deck(copy.deepcopy(cfg), device="cpu", log=False)
    # the pair scope alone
    cfg["dump"]["scope"] = ["pair"]
    sim, _ = run_deck(cfg, device="cpu", log=False)
    d = tdump.read_lammpstrj(cfg["dump"]["file"])[0]["data"]
    assert np.isfinite(d).all() and d.shape == (sim.n_atoms, 2)
    assert torch.isfinite(computes.pe_atom(sim, scope=("pair",))).all()
