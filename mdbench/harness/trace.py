"""A ``torch.profiler`` slice of a run, reduced to device time by layer,
busy and idle time, and the breakdown the result line carries.

The tracer can miss the first kernels after it starts, so a slice opens
on an idle card with eight spin kernels, and only device events that
start after the last of them count; a slice that holds none of them is
lost, and the caller traces another.  (The same lead as the program's
``utils/device_trace.py``, copied so the yardstick does not move with it.)
"""
from __future__ import annotations

import bisect
import time

import torch

_LEAD = 8
ANNOTATION = "mdbench."


class Lost(RuntimeError):
    """The slice holds none of its leading spin kernels."""


class Slice:
    def __init__(self, spin_cycles: int = 1_000_000):
        self.spin = spin_cycles
        self.prof = None

    def start(self):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        for _ in range(_LEAD):
            torch.cuda._sleep(self.spin)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def reduce(self, layer_of) -> dict:
        """Device events after the lead: seconds by layer, event count,
        busy seconds (their union), the traced window and the breakdown:
        the device operations that took most time, and the idle gaps
        between them summed by the innermost host event running at each
        gap's middle."""
        ev = list(self.prof.events())
        cuda = torch.autograd.DeviceType.CUDA
        # the device operations: not the device-side copies of the
        # harness's own record_function annotations
        dev = [e for e in ev if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(ANNOTATION)]
        lead = [e.time_range.end for e in dev if "spin_kernel" in e.name]
        if not lead:
            raise Lost("the trace lost its leading spin kernels")
        t_lead = max(lead)
        dev = sorted((e for e in dev if e.time_range.start >= t_lead),
                     key=lambda e: e.time_range.start)
        if not dev:
            raise Lost("the trace holds no device event after its lead")
        host = sorted((e for e in ev if e.device_type != cuda),
                      key=lambda h: h.time_range.start)
        starts = [h.time_range.start for h in host]
        by_layer, by_name = {}, {}
        busy, end = 0.0, t_lead
        gaps = []
        for e in dev:
            s, t = e.time_range.start, e.time_range.end
            dur = (t - s) * 1e-6
            lay = layer_of(e.name)
            by_layer[lay] = by_layer.get(lay, 0.0) + dur
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
            if s > end:
                gaps.append((end, s))
            busy += max(0.0, t - max(s, end)) * 1e-6
            end = max(end, t)
        # host time after the last device operation (a frame's text)
        tail = (self.t1 - self.t0) - (end - t_lead) * 1e-6
        gap_by = {"host after the last device op": tail} if tail > 0 else {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            # the innermost host event running at the gap's middle: the
            # latest start before it among those that have not ended
            label = "host python"
            k = bisect.bisect_right(starts, mid) - 1
            for h in host[max(0, k - 256):k + 1][::-1]:
                if h.time_range.end >= mid:
                    label = h.name
                    break
            gap_by[label] = gap_by.get(label, 0.0) + (b - a) * 1e-6

        def top(d):
            return [[k[:160], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        # the traced window on the host clock: from the idle card after
        # the lead to the synchronisation that closes the slice, so host
        # work after the last kernel (a frame's text) counts as idle
        return dict(by_layer=by_layer, n_events=len(dev), busy_s=busy,
                    window_s=self.t1 - self.t0,
                    breakdown={"device_ops": top(by_name),
                               "idle_gaps": top(gap_by)})
