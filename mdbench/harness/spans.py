"""A ``torch.profiler`` slice taken with the program's tracer on, reduced
by program span.

With ``lammps_buck_intel_tpu_torch.utils.trace`` enabled, every span of
the program is a ``record_function("lbi.<name>")`` on the host timeline.
The slice's Chrome trace (the profiler's own export) is read as four
kinds of event:

- ``device``: kernels, copies and fills on the card;
- ``runtime``: the CUDA runtime and driver calls that launched them;
- ``span``: the program's ``lbi.*`` annotations on the host (their
  device-side copies, ``gpu_user_annotation``, are no device operations
  and are dropped);
- ``host``: every other host event (torch's operators).

Each device operation goes to the innermost span that was open on the
launching thread when it was launched: the launch is its runtime call,
found by correlation id; without one, the host operator that issued it,
found by external id; without either, the operation is ``unattributed``.
Each idle gap between device operations goes to the innermost span open
at its middle.  A row's drain is the idle time from the start of a
``readback`` span to the start of the first device operation launched
after it ends.
"""
from __future__ import annotations

import bisect
import json
from collections import namedtuple

PREFIX = "lbi."
UNATTRIBUTED = "unattributed"
OUTSIDE = "outside spans"

# t0, t1 in microseconds on the trace's clock; tid (pid, tid) of the host
# thread (or the device and stream); corr the CUPTI correlation id; ext
# the profiler's external id (-1 where the event has none)
Event = namedtuple("Event", "kind name tid t0 t1 corr ext")

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME = ("cuda_runtime", "cuda_driver")


def events_from_chrome(trace: dict) -> list:
    """The events of a Chrome trace (``prof.export_chrome_trace``)."""
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in _DEVICE:
            kind = "device"
        elif cat in _RUNTIME:
            kind = "runtime"
        elif cat.startswith("gpu_"):
            continue
        elif cat == "user_annotation" and name.startswith(PREFIX):
            kind = "span"
        else:
            kind = "host"
        args = e.get("args") or {}
        t0 = float(e["ts"])
        out.append(Event(kind, name, (e.get("pid"), e.get("tid")), t0,
                         t0 + float(e.get("dur", 0.0)),
                         int(args.get("correlation", -1)),
                         int(args.get("External id", -1))))
    return out


def events_from_profile(prof, path: str) -> list:
    """Export ``prof``'s trace to ``path`` and read it back."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        return events_from_chrome(json.load(f))


class _Spans:
    """The spans of one host thread, with their parents and paths."""

    def __init__(self, spans: list):
        spans = sorted(spans, key=lambda s: (s.t0, -s.t1))
        self.spans = spans
        self.starts = [s.t0 for s in spans]
        self.parent, self.path = [], []
        stack = []
        for k, s in enumerate(spans):
            while stack and spans[stack[-1]].t1 < s.t1:
                stack.pop()
            p = stack[-1] if stack else -1
            name = s.name[len(PREFIX):]
            self.parent.append(p)
            self.path.append(name if p < 0 else f"{self.path[p]}/{name}")
            stack.append(k)

    def at(self, t: float) -> int:
        """The innermost span open at time t, or -1."""
        k = bisect.bisect_right(self.starts, t) - 1
        while k >= 0 and self.spans[k].t1 < t:
            k = self.parent[k]
        return k

    def names_up(self, k: int):
        """The span names from k up to its top-level span, each once."""
        seen = set()
        while k >= 0:
            n = self.spans[k].name[len(PREFIX):]
            if n not in seen:
                seen.add(n)
                yield n
            k = self.parent[k]


class _Busy:
    """The union of the device operations' intervals, for overlaps."""

    def __init__(self, dev: list):
        merged = []
        for e in dev:
            if merged and e.t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e.t1)
            else:
                merged.append([e.t0, e.t1])
        self.ivals = merged
        self.starts = [a for a, _ in merged]
        self.cum = [0.0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + (b - a))

    def total(self) -> float:
        return self.cum[-1]

    def within(self, a: float, b: float) -> float:
        """Busy time inside [a, b]."""
        if b <= a:
            return 0.0
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        j = bisect.bisect_left(self.starts, b)
        tot = 0.0
        for s, t in self.ivals[i:j]:
            tot += max(0.0, min(t, b) - max(s, a))
        return tot


def lead_end(evs: list) -> float:
    """The end of the slice's last leading spin kernel (KeyError if the
    trace lost them all)."""
    ends = [e.t1 for e in evs
            if e.kind == "device" and "spin_kernel" in e.name]
    if not ends:
        raise KeyError("the trace holds none of its leading spin kernels")
    return max(ends)


def reduce(evs: list, t_lead: float, steps: int) -> dict:
    """Device and idle time of the slice by program span.

    Counts the device operations that start at or after ``t_lead``.
    Returns seconds: ``busy_s``, ``window_s`` (from ``t_lead`` to the last
    device operation or span end), ``n_events``; ``device_s`` (device time
    by the path of its innermost span, ``unattributed`` apart) and
    ``device_n`` (the operations' count by the same paths),
    ``device_incl_s`` (by span name, each operation counted once under
    every name on its path), ``top_s`` (by top-level span, with
    ``unattributed``), ``idle_s`` (gaps by the path of the span open at
    their middle), ``row_idle_s`` (each row's drain), and ``steps``."""
    dev = sorted((e for e in evs if e.kind == "device" and e.t0 >= t_lead),
                 key=lambda e: e.t0)
    runtime = {e.corr: e for e in evs if e.kind == "runtime" and e.corr >= 0}
    host_ext = {}
    for e in evs:
        if e.kind in ("host", "span") and e.ext >= 0:
            host_ext.setdefault(e.ext, e)
    threads = {}
    for e in evs:
        if e.kind == "span":
            threads.setdefault(e.tid, []).append(e)
    threads = {tid: _Spans(sp) for tid, sp in threads.items()}

    device_s, device_n, incl_s, top_s = {}, {}, {}, {}
    launches = []               # (launch time, thread, device start)
    for e in dev:
        dur = (e.t1 - e.t0) * 1e-6
        src = runtime.get(e.corr) if e.corr >= 0 else None
        if src is None and e.ext >= 0:
            src = host_ext.get(e.ext)
        sp = threads.get(src.tid) if src is not None else None
        k = sp.at(src.t0) if sp is not None else -1
        if src is not None:
            launches.append((src.t0, src.tid, e.t0))
        path = sp.path[k] if k >= 0 else UNATTRIBUTED
        device_s[path] = device_s.get(path, 0.0) + dur
        device_n[path] = device_n.get(path, 0) + 1
        top = path.split("/", 1)[0]
        top_s[top] = top_s.get(top, 0.0) + dur
        if k >= 0:
            for n in sp.names_up(k):
                incl_s[n] = incl_s.get(n, 0.0) + dur

    busy = _Busy(dev)
    span_end = max((s.t1 for sp in threads.values() for s in sp.spans),
                   default=t_lead)
    t_end = max([span_end] + [e.t1 for e in dev])

    def label(t):
        best, path = None, OUTSIDE
        for sp in threads.values():
            k = sp.at(t)
            if k >= 0 and (best is None or sp.spans[k].t0 > best):
                best, path = sp.spans[k].t0, sp.path[k]
        return path

    idle_s = {}
    edges = [t_lead] + [x for ab in busy.ivals for x in ab] + [t_end]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            lab = label(0.5 * (a + b))
            idle_s[lab] = idle_s.get(lab, 0.0) + (b - a) * 1e-6

    launches.sort()
    row_idle = []
    for tid, sp in threads.items():
        for s in sp.spans:
            if s.name != PREFIX + "readback" or s.t0 < t_lead:
                continue
            b = next((d0 for _, th, d0 in launches[
                bisect.bisect_right(launches, (s.t1,)):] if th == tid), None)
            if b is not None:
                row_idle.append(((b - s.t0) - busy.within(s.t0, b)) * 1e-6)
    return dict(busy_s=busy.total() * 1e-6, window_s=(t_end - t_lead) * 1e-6,
                n_events=len(dev), steps=steps, device_s=device_s,
                device_n=device_n, device_incl_s=incl_s, top_s=top_s,
                idle_s=idle_s, row_idle_s=row_idle)


def breakdown(red: dict) -> dict:
    """``breakdown_spans``: device and idle ms a step by span path,
    largest first."""
    steps = max(red["steps"], 1)

    def per_step(d):
        return {k: 1e3 * v / steps for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])}

    return {"device_ms_per_step": per_step(red["device_s"]),
            "idle_ms_per_step": per_step(red["idle_s"])}
