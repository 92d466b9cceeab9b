"""The port's tracer: named spans on the host clock, and counters.

Spans are off by default.  ``span(name)`` then returns one shared no-op
object and reads no clock, so a span left in the step costs a flag test
and the ``with`` statement around the no-op.  After ``enable()`` each
span records ``(name, parent, t0_ns, t1_ns)`` in memory
(``time.perf_counter_ns``; ``parent`` is the index in ``spans()`` of the
span that encloses it on the same thread, or -1) and enters
``torch.profiler.record_function("lbi." + name)``, so that a running
``torch.profiler`` holds the span on the timeline of the device
events and a launch can be put down to the span that issued it.

The engines' spans: ``setup.geometry``, ``setup.velocity``,
``setup.params`` and ``setup.engine`` (``run.build_simulation``); ``run``;
``segment`` (one thermo interval); ``block``; ``neighbor`` (a rebin, or a
wrap and a list build); ``pair``, ``kspace`` and ``bonded`` (the force
evaluation); ``integrate`` (kicks, drift, thermostat chain, SHAKE and
RATTLE), within which ``shake`` holds the constraint kernels (K13, also at
set-up and in the thermo row's constraint virial); ``thermo`` with its
``readback`` (the row's device -> host copy
and its checks); ``peratom`` (the per-atom computes).

Counters are always on: ``count`` is one add into the module's store.
The kernel wrappers' launches (``ops.LAUNCHES``, one entry a wrapper) are
the store's launch part.  The engines count:

- ``host_sync``: each wait of the run path for the device; ``to_host``
  and ``synchronize`` are the only places where it waits;
- ``neighbor_build``: each rebin or list build of a block, a thermo row
  or a capacity grow;
- ``thermo_row``: each thermo row;
- ``step``: the MD steps run;
- ``shake.unconverged``: at each thermo row of a deck with fix shake
  that the run keeps (not a row whose segment a capacity overflow rolls
  back), the constraint clusters that the last SHAKE solve before the
  row left with a relative residual |r^2 - d^2| / d^2 above the deck's
  ``tol`` (computed on the device and read with the row, no wait of its
  own).

Device counters are on only while the tracer is: ``device_counts(group,
device)`` hands a kernel wrapper the group's int64 buffer on that device
(None while the tracer is off, so the kernel counts nothing), and the
kernel adds into it on the device.  ``counters()`` reads the buffers,
a wait for the device, only when it is called.  The groups:

- ``cellpair`` (K1, ``ops/cellpair.py`` and the plain version in
  ``models/pair/cellpair.py``): ``tested``, the candidates its lanes
  tested; ``in_range``, the pairs among them within their type pair's
  cutoffs; ``eval_lanes``, the lane slots of the kernel's evaluate
  rounds (the plain version leaves it at 0).  ``in_range / tested`` is
  the hit share, ``in_range / eval_lanes`` the evaluate phase's lane use.
- ``pppm`` (K5 by cell, ``ops.pppm.deposit_cells``: the cell engine's
  slot deposit into a shared-memory brick of the mesh a coarse cell):
  ``deposited``, the charged slots it spread; ``spilled``, those among
  them with a stencil point outside their cell's brick (a drift past
  skin/2), which went to the mesh directly.  ``spilled / deposited`` is
  the share that took the slow path; the plain version counts neither.

Operator's use::

    from lammps_buck_intel_tpu_torch.utils import trace
    trace.enable()
    sim = build_simulation(deck)
    sim.run(1000, thermo_every=100)
    trace.summary()    # {name: {count, total_s, self_s}}
    trace.counters()   # {host_sync: ..., launch.cellpair: ..., ...}
"""
from __future__ import annotations

import threading
import time

import torch

PREFIX = "lbi."

COUNTS = {"host_sync": 0, "neighbor_build": 0, "thermo_row": 0, "step": 0,
          "shake.unconverged": 0}
LAUNCHES: dict = {}
# group -> the names of its device counters, in buffer order
DEVICE_COUNTS = {"cellpair": ("tested", "in_range", "eval_lanes"),
                 "pppm": ("deposited", "spilled")}
_device_bufs: dict = {}      # (group, device) -> int64 buffer

_on = False
_records: list = []          # [name, parent, t0_ns, t1_ns or None]
_local = threading.local()


class _Off:
    """The span of a tracer that is off: enters and leaves, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec", "entry", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        recs = _records
        top = stack[-1] if stack else None
        parent = top[1] if top is not None and top[0] is recs else -1
        self.rec = [self.name, parent, 0, None]
        self.entry = (recs, len(recs))
        recs.append(self.rec)
        stack.append(self.entry)
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.rec[2] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.rec[3] = t1
        stack = _stack()
        if stack and stack[-1] is self.entry:
            stack.pop()
        return False


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def enable():
    """Record spans from now on."""
    global _on
    _on = True


def disable():
    """Stop recording spans (the records stay until ``reset``)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset():
    """Drop the span records and zero every counter, launches included.
    Spans still open write into the dropped records."""
    global _records
    _records = []
    _local.stack = []
    for store in (COUNTS, LAUNCHES):
        for k in store:
            store[k] = 0
    for buf in _device_bufs.values():
        buf.zero_()


def span(name: str):
    """Context manager: a span named ``name`` while the tracer is on, the
    shared no-op object while it is off."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name``."""
    COUNTS[name] = COUNTS.get(name, 0) + n


def device_counts(group: str, device) -> torch.Tensor | None:
    """The int64 buffer of ``group``'s device counters on ``device``
    while the tracer is on (made zero at first use), None while it is
    off."""
    if not _on:
        return None
    key = (group, torch.device(device))
    buf = _device_bufs.get(key)
    if buf is None:
        buf = _device_bufs[key] = torch.zeros(
            len(DEVICE_COUNTS[group]), dtype=torch.int64, device=device)
    return buf


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the host: a wait for the device, counted as
    ``host_sync``."""
    COUNTS["host_sync"] += 1
    return t.cpu()


def synchronize(device: torch.device):
    """Wait for the device's work (none to wait for on the CPU), counted
    as ``host_sync``."""
    COUNTS["host_sync"] += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counters() -> dict:
    """A flat snapshot of the store: each counter, each wrapper's
    launches as ``launch.<wrapper>``, and each device counter as
    ``<group>.<name>`` summed over devices (0 where none was made)."""
    out = dict(COUNTS)
    out.update((f"launch.{k}", v) for k, v in LAUNCHES.items())
    for group, names in DEVICE_COUNTS.items():
        tot = [0] * len(names)
        for (g, _), buf in _device_bufs.items():
            if g == group:
                tot = [a + b for a, b in zip(tot, buf.tolist())]
        out.update((f"{group}.{name}", v) for name, v in zip(names, tot))
    return out


def spans() -> list:
    """The span records in the order they were opened: (name, parent,
    t0_ns, t1_ns), t1_ns None while the span is open."""
    return [tuple(r) for r in _records]


def summary() -> dict:
    """Per span name over the closed spans: ``count``, ``total_s`` and
    ``self_s`` (the total less what the span's child spans cover)."""
    recs = list(_records)
    inner = [0] * len(recs)
    for name, parent, t0, t1 in recs:
        if t1 is not None and parent >= 0:
            inner[parent] += t1 - t0
    out = {}
    for k, (name, _, t0, t1) in enumerate(recs):
        if t1 is None:
            continue
        s = out.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += (t1 - t0) * 1e-9
        s["self_s"] += (t1 - t0 - inner[k]) * 1e-9
    return out
