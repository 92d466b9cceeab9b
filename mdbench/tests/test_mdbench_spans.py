"""The spans slice's reduction (``harness/spans.py``) on synthetic event
lists, the old slice's reduction with the program's annotations in its
trace, and the counter readers."""
import importlib.util
import os
import sys
from types import SimpleNamespace

import pytest
import torch

from mdbench.harness import spans
from mdbench.harness.layers import LayerMap
from mdbench.harness.spec import HERE
from mdbench.harness.trace import Slice

T = ("pid", 1)          # the launching thread
DEV = (0, 7)            # the card's stream


def span(name, t0, t1):
    return spans.Event("span", "lbi." + name, T, t0, t1, -1, -1)


def launch(t, corr):
    return spans.Event("runtime", "cudaLaunchKernel", T, t, t + 1, corr, -1)


def kernel(name, t0, t1, corr=-1, ext=-1):
    return spans.Event("device", name, DEV, t0, t1, corr, ext)


# a block (pair, then kspace) and a thermo row (its readback) after a
# leading spin kernel; times in microseconds
EVENTS = [
    kernel("spin_kernel", 0, 5),
    span("run", 10, 400),
    span("segment", 10, 100), span("block", 10, 100),
    span("pair", 12, 20), launch(13, 1),
    span("kspace", 20, 30), launch(21, 2),
    spans.Event("host", "aten::add", T, 24, 26, -1, 9),
    kernel("cellpair_kernel", 40, 60, corr=1),
    kernel("pppm_deposit_kernel", 60, 90, corr=2),
    kernel("vectorized_elementwise_kernel", 90, 95, corr=3, ext=9),
    kernel("stray_kernel", 95, 97),
    span("thermo", 100, 200), span("pair", 105, 110), launch(106, 4),
    span("readback", 150, 200), launch(151, 5),
    kernel("cellpair_kernel_true", 120, 170, corr=4),
    kernel("Memcpy DtoH", 175, 180, corr=5),
    span("segment", 250, 300), launch(251, 6),
    kernel("Memcpy DtoD", 260, 270, corr=6),
]


def test_attribution_by_correlation_and_fallback():
    red = spans.reduce(EVENTS, spans.lead_end(EVENTS), steps=10)
    d = red["device_s"]
    assert d["run/segment/block/pair"] == pytest.approx(20e-6)
    # the launch by correlation id, and the operator found by external id
    # (no runtime call recorded) inside the same span
    assert d["run/segment/block/kspace"] == pytest.approx(35e-6)
    assert d[spans.UNATTRIBUTED] == pytest.approx(2e-6)
    assert d["run/thermo/pair"] == pytest.approx(50e-6)
    assert d["run/thermo/readback"] == pytest.approx(5e-6)
    assert d["run/segment"] == pytest.approx(10e-6)
    incl = red["device_incl_s"]
    assert incl["thermo"] == pytest.approx(55e-6)
    assert incl["run"] == pytest.approx(sum(d.values()) - 2e-6)
    assert red["n_events"] == 7
    # top-level spans and unattributed sum to the busy time
    assert sum(red["top_s"].values()) == pytest.approx(red["busy_s"])


def test_idle_gaps_and_row_drain():
    red = spans.reduce(EVENTS, spans.lead_end(EVENTS), steps=10)
    idle = red["idle_s"]
    # the device is idle 5-40 (its middle in kspace), 97-120 (in the
    # row's pair), 170-175 (readback), 180-260 and 270-400 (in run alone)
    assert idle["run/segment/block/kspace"] == pytest.approx(35e-6)
    assert idle["run/thermo/pair"] == pytest.approx(23e-6)
    assert idle["run/thermo/readback"] == pytest.approx(5e-6)
    assert idle["run"] == pytest.approx(80e-6 + 130e-6)
    assert red["busy_s"] + sum(idle.values()) == pytest.approx(
        red["window_s"])
    # the row's drain: from the readback's start (150) to the first
    # operation launched after it (260), less the busy 150-170, 175-180
    assert red["row_idle_s"] == [pytest.approx(85e-6)]


def test_events_from_chrome_drop_device_annotations():
    tr = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7,
         "ts": 10.0, "dur": 2.0, "args": {"correlation": 3,
                                           "External id": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 5.0, "dur": 1.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "lbi.pair",
         "pid": 0, "tid": 7, "ts": 10.0, "dur": 2.0},
        {"ph": "X", "cat": "user_annotation", "name": "lbi.pair",
         "pid": 1, "tid": 1, "ts": 4.0, "dur": 3.0},
        {"ph": "X", "cat": "user_annotation", "name": "mdbench.thermo",
         "pid": 1, "tid": 1, "ts": 1.0, "dur": 9.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 5.0},
    ]}
    evs = spans.events_from_chrome(tr)
    assert [e.kind for e in evs] == ["device", "runtime", "span", "host"]
    assert evs[0].corr == 3 and evs[0].ext == 5 and evs[0].t1 == 12.0
    red = spans.reduce(evs, 0.0, steps=1)
    assert red["device_s"] == {"pair": pytest.approx(2e-6)}
    assert spans.breakdown(red)["device_ms_per_step"] == {
        "pair": pytest.approx(2e-3)}


class _Ev:
    """A FunctionEvent as ``Slice.reduce`` reads one."""

    def __init__(self, name, t0, t1, device, annotation=False):
        self.name = name
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = annotation
        self.time_range = SimpleNamespace(start=t0, end=t1)


def _old_reduce(evs):
    sl = Slice()
    sl.prof = SimpleNamespace(events=lambda: evs)
    sl.t0, sl.t1 = 0.0, 1e-3
    return sl.reduce(LayerMap())


def test_old_slice_reads_the_same_with_program_annotations():
    base = [_Ev("spin_kernel", 0, 5, True),
            _Ev("aten::add", 8, 12, False),
            _Ev("cellpair_kernel", 20, 60, True),
            _Ev("pppm_deposit_kernel", 70, 90, True),
            _Ev("Memcpy DtoH", 95, 98, True)]
    marked = base + [_Ev("lbi.block", 6, 92, False),
                     _Ev("lbi.pair", 7, 15, False),
                     _Ev("lbi.block", 20, 90, True, annotation=True),
                     _Ev("lbi.pair", 20, 60, True, annotation=True)]
    a, b = _old_reduce(base), _old_reduce(marked)
    for k in ("by_layer", "n_events", "busy_s", "window_s"):
        assert a[k] == b[k], k
    assert a["breakdown"]["device_ops"] == b["breakdown"]["device_ops"]


def _reader(name):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"t_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_counter_readers(monkeypatch):
    from lammps_buck_intel_tpu_torch.utils import trace

    run = SimpleNamespace()
    builds, syncs = _reader("builds_per_step"), _reader("host_syncs_per_step")
    monkeypatch.setattr(trace, "COUNTS", dict(trace.COUNTS))
    for k in trace.COUNTS:
        trace.COUNTS[k] = 0
    assert builds(run) is None and syncs(run) is None
    trace.count("step", 500)
    trace.count("neighbor_build", 40)
    trace.count("host_sync", 10)
    assert builds(run) == pytest.approx(0.08)
    assert syncs(run) == pytest.approx(0.02)
    # a program without the tracer (an older checkout): nothing
    monkeypatch.delitem(sys.modules, "lammps_buck_intel_tpu_torch.utils.trace")
    assert builds(run) is None and syncs(run) is None
