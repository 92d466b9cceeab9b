"""Device-side time of a piece of work, from a ``torch.profiler`` trace.

Used by chip_smoke.py and tools/profile_torch_deck.py to read the card's
own time of kernels (what CUDA events around a call cannot separate from
the host time of the Python wrapper that launches them).  The tracer can
miss the first kernels after it starts, so every trace opens with eight
spin kernels, and only events that start after the last of them count;
a trace that lost them all raises ``TraceLost`` (the caller may trace
the work again).
"""
from __future__ import annotations

import torch

_LEAD = 8
_SPIN_CYCLES = 100000


class TraceLost(RuntimeError):
    """The trace holds none of its leading spin kernels."""


def device_events(run) -> list:
    """The device events (kernels, copies, fills) of ``run()`` on the
    current CUDA device, as ``torch.profiler`` FunctionEvents."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(_LEAD):
            torch.cuda._sleep(_SPIN_CYCLES)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    lead = [e.time_range.end for e in dev if "spin_kernel" in e.name]
    if not lead:
        raise TraceLost("the device trace lost its leading spin kernels")
    t0 = max(lead)
    return [e for e in dev if e.time_range.start >= t0]


def device_ms(events) -> float:
    """Summed duration of ``events`` in ms."""
    return sum(e.time_range.elapsed_us() for e in events) / 1e3
