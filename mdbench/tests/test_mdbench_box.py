"""Under fix npt the check reads the window's end in the program's box:
on the tiny silica deck with its box scaled by 1.02, ``checks.compare``
given that box reads what a reference built on the scaled box reads;
given the deck's box it does not."""
import numpy as np
import pytest
import torch

from mdbench.harness import checks, spec
from mdbench.reference import model, system
from mdbench.work import pair

END = ("force_max", "force_rms", "energy", "temp", "press", "follow_x",
       "follow_v")


def _case(scale=1.02):
    cfg = spec.config("cristobalite_pppm")
    deck = spec.deck(cfg, dict(spec.traffic("x656.thermo50"),
                               replicate=[1, 1, 1]), 7)
    deck["pair_style"]["cut"] = 5.0
    d = system.build(deck, 7)
    moved = dict(d, x=d["x"] * scale, L=d["L"] * scale)
    # a reference built on the scaled box, g_ewald held at the deck box's
    # (LAMMPS sets it in init; PPPM::setup only follows the box)
    ref = model.Reference(deck, moved, "cpu")
    ref.g = ref.style.g = model.Reference(deck, d, "cpu").g
    rng = np.random.default_rng(3)
    n = len(d["x"])
    x = torch.as_tensor(moved["x"] + rng.normal(0, 0.03, (n, 3)))
    v = torch.as_tensor(d["v"])
    r = ref.forces(x)
    t, _ = ref.kinetic(v, ref.dof)
    row = {"epair": r["epot"] + 1e-3 * n, "emol": 0.0, "temp": t * 1.001,
           "press": ref.pressure(v, r["vir"]) + 500.0}
    x1, v1, _ = ref.verlet_step(x, v, r["f"], ref.timestep)
    follow = {"x": (x1 + 1e-3).numpy(), "v": (v1 * 1.01).numpy()}
    end = {"x": x.numpy(), "v": v.numpy(),
           "f": (r["f"] + torch.as_tensor(rng.normal(0, 0.01, (n, 3)))
                 ).numpy(), "box": moved["L"]}
    start = {"x": d["x"], "v": d["v"]}
    return deck, d, ref, start, end, row, follow


def test_the_check_reads_the_end_in_the_programs_box():
    deck, d, ref, start, end, row, follow = _case()
    got = checks.compare(deck, 7, start, end, row, follow, None, "cpu")
    plain = {k: v for k, v in end.items() if k != "box"}
    with torch.no_grad():
        want = checks._numbers(ref, d, start, plain, row, follow, None,
                               torch.float64)
    for k in END:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    # the start stays in the deck's box
    assert got["start_x"] < 1e-12 and got["start_v"] < 1e-12
    # in the deck's box the same outputs read far off
    wrong = checks.compare(deck, 7, start, plain, row, follow, None, "cpu")
    for k in ("force_max", "force_rms", "energy", "follow_x"):
        assert wrong[k] > 10 * got[k], k


def test_no_box_is_the_decks_box():
    deck, d, _, start, end, row, follow = _case(1.0)
    plain = {k: v for k, v in end.items() if k != "box"}
    a = checks.compare(deck, 7, start, end, row, follow, None, "cpu")
    b = checks.compare(deck, 7, start, plain, row, follow, None, "cpu")
    assert a == b


def test_pairs_are_counted_in_the_traced_box():
    deck, d, _, _, end, _, _ = _case()
    inside = pair.count(deck, end["x"], end["box"])[0]
    assert pair.bound_s(deck, end["x"], end["box"]) == pytest.approx(
        pair._bound(len(d["x"]) * pair.BYTES_ATOM, inside * 53), rel=1e-15)
    assert pair.count(deck, end["x"], d["L"])[0] != inside
