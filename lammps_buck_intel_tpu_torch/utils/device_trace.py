"""Device-side time of a piece of work, from a ``torch.profiler`` trace.

Used by chip_smoke.py to read the card's own time of kernels (what CUDA
events around a call cannot separate from the host time of the Python
wrapper that launches them).  The tracer can
miss the first kernels after it starts, so it starts on an idle card and
every trace opens with eight spin kernels, and only events that start
after the last of them count;
a trace that lost them all raises ``TraceLost`` (the caller may trace
the work again).
"""
from __future__ import annotations

import torch

_LEAD = 8
SPIN_CYCLES = 1000000


class TraceLost(RuntimeError):
    """The trace holds none of its leading spin kernels."""


def device_events(run, spin_cycles: int = SPIN_CYCLES) -> list:
    """The device events (kernels, copies, fills) of ``run()`` on the
    current CUDA device, as ``torch.profiler`` FunctionEvents.
    spin_cycles: the length of each leading spin kernel (a caller whose
    trace lost its lead may trace again with a longer one)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # start on an idle card (a caller's warm-up may still be running) and
    # with the allocator's cached blocks returned to the device
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(_LEAD):
            torch.cuda._sleep(spin_cycles)
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
