"""What the check and the work counts give for fixed inputs on the decks
of the fixed-box cells is pinned to values recorded before the reference
learned dispersion PPPM and a moving box: those changes must move no
reading of a cell that has neither.

The program's side of each case is made here from a seed (the reference's
own build, moved by seeded noise), so the numbers do not depend on the
program; ``numbers(case)`` gives them, and the recorded values are in
``PINNED``."""
import numpy as np
import pytest

from mdbench.harness import checks, spec
from mdbench.reference import system
from mdbench.work import kspace, pair

CASES = ("cristobalite", "cristobalite_dump", "rhodo")


def _deck(case: str) -> dict:
    if case.startswith("cristobalite"):
        cfg = spec.config("cristobalite_pppm")
        deck = spec.deck(cfg, dict(spec.traffic("x656.thermo50"),
                                   replicate=[1, 1, 1]), 7)
        deck["pair_style"]["cut"] = 5.0
        return deck
    cfg = spec.config("rhodo")
    return spec.deck(cfg, dict(spec.traffic("x332.thermo50"),
                               replicate=[1, 1, 1]), 7)


def inputs(case: str):
    """(deck, seed, start, end, row, follow, frame): the program's side of
    a run, made from the reference's build and seeded noise."""
    deck = _deck(case)
    d = system.build(deck, 7)
    rng = np.random.default_rng(11)
    n = len(d["x"])
    start = {"x": d["x"] + rng.normal(0, 1e-6, (n, 3)),
             "v": d["v"] * (1 + rng.normal(0, 1e-6, (n, 1)))}
    x = d["x"] + rng.normal(0, 0.03, (n, 3))
    v = d["v"] * (1 + rng.normal(0, 0.01, (n, 1)))
    end = {"x": x, "v": v, "f": rng.normal(0, 1.0, (n, 3))}
    row = {"epair": -1.0e3 * n / 100, "emol": 5.0, "temp": 301.0,
           "press": 120.0}
    follow = {"x": x + v * float(deck["timestep"]) * 1e-3,
              "v": v * (1 + 1e-4)}
    frame = None
    if case == "cristobalite_dump":
        frame = np.concatenate([np.zeros((n, 5)),
                                rng.normal(-10.0, 1.0, (n, 1)),
                                rng.normal(0, 1e3, (n, 6))], 1)
    return deck, 7, start, end, row, follow, frame


def numbers(case: str) -> dict:
    return checks.compare(*inputs(case), "cpu")


def work() -> dict:
    """The rooflines' least times: k-space on the three cells' decks at
    their size, pairs on the tiny cristobalite deck's jittered atoms."""
    out = {}
    for name, tr in (("cristobalite_pppm", "x656.thermo50"),
                     ("cristobalite_pppm_nlist", "x656.thermo50"),
                     ("rhodo", "x664.thermo50")):
        deck = spec.deck(spec.config(name), spec.traffic(tr), 1)
        out[f"kspace.{name}"] = kspace.bound_s(deck, 0)
    deck, _, _, end, *_ = inputs("cristobalite")
    out["pair.cristobalite"] = pair.bound_s(deck, end["x"])
    return out


PINNED = {
    "cristobalite": {
        "start_x": 3.7315614651589613e-06,
        "start_v": 3.606808741325641e-06,
        "force_max": 3.528750422164965,
        "force_rms": 2647.2058119492513,
        "energy": 9.03843107304145,
        "temp": 0.003403604568394602,
        "press": 93.34763418154675,
        "follow_x": 0.014474634473396364,
        "follow_v": 0.6636766391667666,
    },
    "cristobalite_dump": {
        "start_x": 3.7315614651589613e-06,
        "start_v": 3.606808741325641e-06,
        "force_max": 3.528750422164965,
        "force_rms": 2647.2058119492513,
        "energy": 9.03843107304145,
        "temp": 0.003403604568394602,
        "press": 93.34763418154675,
        "follow_x": 0.014474634473396364,
        "follow_v": 0.6636766391667666,
        "pe_atom": 1.3132986940318734,
        "stress_atom": 2.0628404703643763,
    },
    "rhodo": {
        "start_x": 3.7315614651589613e-06,
        "start_v": 2.980658443880634,
        "force_max": 4.581295704487366,
        "force_rms": 987.9569910135417,
        "energy": 13.074781721875558,
        "temp": 0.16401537632883442,
    },
    "work": {
        "kspace.cristobalite_pppm": 2.871317014925373e-05,
        "kspace.cristobalite_pppm_nlist": 2.871317014925373e-05,
        "kspace.rhodo": 6.326027462686568e-06,
        "pair.cristobalite": 1.4153373134328359e-08,
    },
}


@pytest.mark.parametrize("case", CASES)
def test_the_check_reads_as_before(case):
    got = numbers(case)
    want = PINNED[case]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k


def test_the_work_counts_read_as_before():
    got = work()
    for k, v in PINNED["work"].items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k


if __name__ == "__main__":       # prints the values to pin, from this tree
    import json

    print(json.dumps({**{c: numbers(c) for c in CASES}, "work": work()},
                     indent=1))
