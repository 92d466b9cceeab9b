"""The port's tracer (``utils/trace.py``): the no-op span while it is off,
the span tree and its self times while it is on, its annotations in a
``torch.profiler`` trace, and the spans and counters of the three engines
on tiny decks."""
import os

import pytest
import torch
import yaml

from lammps_buck_intel_tpu_torch import ops
from lammps_buck_intel_tpu_torch.run import build_simulation
from lammps_buck_intel_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


class _Clock:
    """perf_counter_ns advancing 10 ns a read."""

    def __init__(self):
        self.t = 0

    def perf_counter_ns(self):
        self.t += 10
        return self.t


def test_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not trace.enabled()
    a, b = trace.span("pair"), trace.span("kspace")
    assert a is b
    with a:
        with b:
            pass
    assert trace.spans() == [] and trace.summary() == {}


def test_span_tree_parents_and_self_time(monkeypatch):
    monkeypatch.setattr(trace, "time", _Clock())
    trace.enable()
    with trace.span("block"):
        with trace.span("pair"):
            pass
        with trace.span("kspace"):
            with trace.span("pair"):
                pass
    recs = trace.spans()
    assert [(n, p) for n, p, _, _ in recs] == [
        ("block", -1), ("pair", 0), ("kspace", 0), ("pair", 2)]
    # each span reads the clock once on entry and once on exit: 10 ns a
    # read, so a leaf lasts 10 ns and each level adds the reads inside it
    assert [t1 - t0 for _, _, t0, t1 in recs] == [70, 10, 30, 10]
    s = trace.summary()
    assert s["pair"]["count"] == 2
    assert s["pair"]["total_s"] == pytest.approx(20e-9)
    assert s["kspace"]["self_s"] == pytest.approx(20e-9)
    assert s["block"]["self_s"] == pytest.approx(30e-9)
    assert s["block"]["total_s"] == pytest.approx(70e-9)


def test_cpu_profiler_holds_the_spans():
    trace.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("run"):
            with trace.span("pair"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"lbi.run", "lbi.pair"} <= names


def test_counters_and_launches_share_one_store():
    ops.LAUNCHES["cellpair"] += 2
    trace.count("host_sync")
    trace.count("step", 20)
    c = trace.counters()
    assert c["launch.cellpair"] == 2 and c["host_sync"] == 1
    assert c["step"] == 20
    ops.reset_launches()
    assert ops.LAUNCHES["cellpair"] == 0
    assert trace.counters()["host_sync"] == 1
    trace.reset()
    assert not any(trace.counters().values())
    assert set(ops.LAUNCHES) == {k[len("launch."):] for k in trace.counters()
                                 if k.startswith("launch.")}


def _deck(engine: str, n: int, npt: bool = False) -> dict:
    with open(os.path.join(ROOT, "examples", "decks", "buck.yaml")) as f:
        d = yaml.safe_load(f)
    d["lattice"].update(nx=n, ny=n, nz=n)
    d["engine"] = engine
    d["neighbor"]["every"] = 4
    if npt:
        d["fixes"] = [{"name": "npt", "t_start": 1.44, "t_stop": 1.44,
                       "t_damp": 0.5, "iso": [0.0, 0.0, 5.0]}]
    return d


ENGINES = [("cellpair", 6, False, "CellPairSimulation"),
           ("nlist", 5, False, "Simulation"),
           ("nlist", 5, True, "NPTSimulation")]


# 10 steps with thermo every 5 and blocks of 4: rows at steps 0, 5 and 10,
# each segment a block of 4 and a tail of 1, each row and block one build;
# the waits are the rows' copies and the run's closing synchronize (the
# row at step 10 reads the flags of the run's end)
@pytest.mark.parametrize("engine,n,npt,engine_cls", ENGINES,
                         ids=["cell", "nlist", "npt"])
def test_engine_spans_and_counters(engine, n, npt, engine_cls):
    trace.enable()
    sim = build_simulation(_deck(engine, n, npt), device="cpu")
    assert type(sim).__name__ == engine_cls
    assert sim.timings["setup"] > 0.0
    before = trace.counters()
    rows = sim.run(10, thermo_every=5, log=False)
    after = trace.counters()
    delta = {k: after[k] - before[k] for k in after}
    assert len(rows) == 3
    assert delta["thermo_row"] == 3
    assert delta["neighbor_build"] == 4 + 3
    assert delta["step"] == 10
    assert delta["host_sync"] == 3 + 1
    assert not any(v for k, v in delta.items() if k.startswith("launch."))
    s = trace.summary()
    for name in ("setup.geometry", "setup.velocity", "setup.params",
                 "setup.engine"):
        assert s[name]["count"] == 1, name
    assert s["run"]["count"] == 1 and s["segment"]["count"] == 2
    assert s["block"]["count"] == 4 and s["neighbor"]["count"] == 7
    assert s["thermo"]["count"] == 3 and s["readback"]["count"] == 3
    # one force evaluation a step and a row, and the set-up's first force
    assert s["pair"]["count"] == 10 + 3 + 1
    assert s["integrate"]["count"] == 2 * 10
    recs = trace.spans()
    paths = set()
    for name, parent, _, _ in recs:
        path = [name]
        while parent >= 0:
            path.append(recs[parent][0])
            parent = recs[parent][1]
        paths.add("/".join(reversed(path)))
    assert {"run/segment/block/neighbor", "run/segment/block/pair",
            "run/segment/block/integrate", "run/thermo/neighbor",
            "run/thermo/pair", "run/thermo/readback",
            "setup.engine/pair"} <= paths


def test_shake_span_and_unconverged_counter_on_a_rhodo_deck():
    """One copy of rhodo_class.yaml (NVT + SHAKE): the ``shake`` span
    holds the constraint kernels of the steps and of the thermo row, and
    ``shake.unconverged`` counts, at each row, the clusters that the last
    SHAKE solve left above the deck's tol: none, and one when a cluster's
    corrected bond vector is 0.1% too long."""
    from lammps_buck_intel_tpu_torch.integrate import shake as shk

    with open(os.path.join(ROOT, "examples", "decks",
                           "rhodo_class.yaml")) as f:
        d = yaml.safe_load(f)
    d["read_data"] = os.path.join(ROOT, d["read_data"])
    trace.enable()
    sim = build_simulation(d, device="cpu")
    assert sim.shake.tol == 1e-4
    before = trace.counters()
    sim.run(1, thermo_every=1, log=False)
    after = trace.counters()
    assert after["thermo_row"] - before["thermo_row"] == 2
    assert after["shake.unconverged"] == before["shake.unconverged"] == 0
    s = trace.summary()
    # set-up's settle (ref, positions, RATTLE); the step's ref, positions
    # and RATTLE; a row's constraint virial
    assert s["shake"]["count"] == 3 + 3 + 2
    recs = trace.spans()
    parents = {recs[p][0] for name, p, _, _ in recs if name == "shake"}
    assert parents == {"setup.engine", "integrate", "thermo"}
    t, rn = sim._shake_t, sim._shake_rn.clone()
    assert int(shk.unconverged(t, rn, 1e-4)) == 0
    rn[:, 0, 7] *= 1.001
    assert int(shk.unconverged(t, rn, 1e-4)) == 1
    sim._shake_rn = rn
    row = sim.thermo()
    assert "shake_unconverged" not in row
    assert trace.counters()["shake.unconverged"] == 1


@pytest.mark.parametrize("engine,n,npt,engine_cls", ENGINES,
                         ids=["cell", "nlist", "npt"])
def test_cell_overflow_is_read_before_non_finite_thermo(engine, n, npt,
                                                        engine_cls):
    """On every engine, a row whose rebin or list build dropped atoms or
    pairs raises the engine's overflow error (the cell engine's rolls the
    segment back, grows and replays), not the non-finite thermodynamics
    that the dropped atoms cause, and counts none of the unconverged SHAKE
    clusters of the segment it throws away."""
    sim = build_simulation(_deck(engine, n, npt), device="cpu")
    assert type(sim).__name__ == engine_cls
    nan = torch.tensor(float("nan"))
    row = dict(temp=nan, etotal=nan, press=nan, overflow=torch.tensor(True),
               shake_unconverged=torch.tensor(7), virial=torch.zeros(6),
               boxL=torch.ones(3))
    before = trace.counters()["shake.unconverged"]
    with pytest.raises(RuntimeError, match="overflow") as err:
        sim._readback(row)
    assert type(err.value) is type(sim._overflow_error())
    assert trace.counters()["shake.unconverged"] == before
