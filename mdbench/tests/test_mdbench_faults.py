"""A run of the tiny cell on the CPU with the timed path broken
underneath comes out not correct, once for each fault an MD cell on one
chip can have (there is no exchange between chips to leave out)."""
import time

import pytest
import torch

from lammps_buck_intel_tpu_torch.integrate import cellpair_verlet, nve, verlet
from mdbench.harness import cell

from . import tiny

ENGINES = {"cellpair": cellpair_verlet.CellPairSimulation,
           "nlist": verlet.Simulation}


def _run(tmp_path, dump=False, engine="cellpair"):
    cfg, tr, lim = tiny.cell(tmp_path, dump, engine)
    return cell.run(cfg, tr, 2 ** 31 + 77, 1.0, False, "cpu",
                    time.perf_counter(), lim)


def _failed(run, name):
    c = run.checks[name]
    return c["value"] > c["limit"]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_a_step_that_returns_its_state_unchanged(tmp_path, monkeypatch,
                                                 engine):
    monkeypatch.setattr(ENGINES[engine], "_block",
                        lambda self, state, *a: state)
    run = _run(tmp_path, engine=engine)
    assert not run.correct
    assert _failed(run, "follow_x")


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_half_of_the_atoms_left_out(tmp_path, monkeypatch, engine):
    """The pair forces of the second half of the atoms never computed."""
    if engine == "cellpair":
        orig = cellpair_verlet.compute_cellpair

        def half(style, grid, box, state, **kw):
            r = orig(style, grid, box, state, **kw)
            gone = state.aid >= grid.n_atoms // 2
            for p in (r.fx, r.fy, r.fz):
                p[gone] = 0
            return r

        monkeypatch.setattr(cellpair_verlet, "compute_cellpair", half)
    else:
        orig = verlet.driver.compute_pair

        def half(style, x, *a, **kw):
            r = orig(style, x, *a, **kw)
            for p in (r.fx, r.fy, r.fz):
                p[p.shape[0] // 2:] = 0
            return r

        monkeypatch.setattr(verlet.driver, "compute_pair", half)
    run = _run(tmp_path, engine=engine)
    assert not run.correct
    assert _failed(run, "force_max")


@pytest.mark.parametrize("engine,dump", [("cellpair", False),
                                         ("cellpair", True),
                                         ("nlist", False)])
def test_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch,
                                                engine, dump):
    """One atom's drift off by 0.01 A along x in every step; in the dump cell
    one atom's c_pe off by 1% in the frame as well."""
    orig = nve.kick_drift

    def bent(xs, vs, fs, typ, aid, *a, **kw):
        out = orig(xs, vs, fs, typ, aid, *a, **kw)
        held = torch.nonzero(aid < a[1])[0]     # a slot that holds an atom
        xs[0][held] += 0.01
        return out

    monkeypatch.setattr(nve, "kick_drift", bent)
    if dump:
        from lammps_buck_intel_tpu_torch import computes
        pe = computes.pe_atom

        def pe_bent(*a, **kw):
            e = pe(*a, **kw).clone()
            e[5] *= 1.01
            return e

        monkeypatch.setitem(computes._COMPUTES, "pe/atom", pe_bent)
    run = _run(tmp_path, dump, engine)
    assert not run.correct
    assert _failed(run, "follow_x")
    if dump:
        assert _failed(run, "pe_atom")


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_the_sound_tiny_run_reads_small(tmp_path, engine):
    """The unbroken tiny cell: every position and velocity number at f32
    rounding (its force and pressure numbers are its small box's PPPM
    error, not the full cell's, so they are not held here)."""
    run = _run(tmp_path, engine=engine)
    for k in ("start_x", "follow_x"):
        assert run.checks[k]["value"] < 1e-4, k
    assert run.checks["force_rms"]["value"] < 1.0
    assert torch.isfinite(torch.tensor(run.checks["energy"]["value"]))
