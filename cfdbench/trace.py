"""The traced run's readings from torch.profiler: device busy time, the
span from the first kernel's start to the last one's end, the device
operations that took the most time, and the idle gaps by what the host
was doing in them.

One stream, so busy time is the union of the device records' intervals.
The window's wall time is the host clock around the traced calls, which
end in a synchronize; the profile waits SETTLE_S after it starts and
before it stops (mgcfd_tpu_torch.monitor.opstats.SETTLE_S: the profiler
drops a profile's first device records without it), outside that
clock.
"""
from __future__ import annotations

import time

SETTLE_S = 0.25
TOP = 10
NO_OP = "host, outside any op"


def profile(fn, sync, activities):
    """Run fn() under torch.profiler with `activities`, sync() before and
    after it. Returns (events, the host seconds of fn up to its sync)."""
    from torch.profiler import profile as prof_

    sync()
    with prof_(activities=activities) as prof:
        time.sleep(SETTLE_S)
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
        time.sleep(SETTLE_S)
    return prof.events(), wall


def _cpu():
    import torch
    return torch.autograd.DeviceType.CPU


def is_device(e) -> bool:
    """A device record: not the host's, nor a range's device-side copy."""
    return (e.device_type != _cpu()
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("k_"))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _top_level(host):
    """The host ops of the busiest host thread (the one the solver
    launches from) that no other of its ops contains, in time order."""
    count = {}
    for e in host:
        count[e.thread] = count.get(e.thread, 0) + 1
    main = max(count, key=count.get) if count else None
    tops = []
    for e in sorted((e for e in host if e.thread == main),
                    key=lambda e: (e.time_range.start, -e.time_range.end)):
        if not tops or e.time_range.start >= tops[-1].time_range.end:
            tops.append(e)
    return tops


def summarise(events, device=is_device) -> dict:
    """{"busy_s", "span_s", "kernels", "device_ops", "idle_gaps"} of a
    profile's events, device(e) telling the device's records; None when
    none is there."""
    dev = [e for e in events if device(e)]
    if not dev:
        return None
    busy = _merge((e.time_range.start, e.time_range.end) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    span_us = busy[-1][1] - busy[0][0]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    host = [e for e in events if e.device_type == _cpu()]
    tops = _top_level(host)
    gaps, i = {}, 0
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        covered = 0.0
        while i < len(tops) and tops[i].time_range.end <= g0:
            i += 1
        j = i
        while j < len(tops) and tops[j].time_range.start < g1:
            h = tops[j]
            o = min(g1, h.time_range.end) - max(g0, h.time_range.start)
            if o > 0:
                gaps[h.name] = gaps.get(h.name, 0.0) + o
                covered += o
            j += 1
        if g1 - g0 > covered:
            gaps[NO_OP] = gaps.get(NO_OP, 0.0) + (g1 - g0 - covered)

    def top(d):
        return [[k[:160], v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_us * 1e-6, "span_s": span_us * 1e-6,
            "kernels": len(dev), "device_ops": top(by_name),
            "idle_gaps": top(gaps)}
