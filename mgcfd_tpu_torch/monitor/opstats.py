"""Measured device time per (solver function, level) from torch.profiler
(mgcfd_tpu's monitor/opstats.py, which parses xplane traces).

While a measurement profiles, each solver function runs inside a range
k_<function>_l<level> (torch.profiler.record_function): every call of
the instrumented solver (measure_instrumented), or MGCFDSolver.cycle's
functions under solver.measured_ranges (measure_production). Each device
kernel event is charged to the innermost range whose CPU op launched it:
the kernel's correlation id names the runtime call that launched it
(cudaLaunchKernel, cudaMemcpyAsync, ...), and the range open on the host
at that call is the function's. The hand kernels' launches through ctypes
run inside no aten op, and the profiler links them to no op; through
their launch calls they are charged like any other. Nothing is joined by
name (mgcfd_tpu joins trace events to the cycle's HLO by instruction
name, opstats.py:196, which can charge one module's op to another's
scope). The solver launches from one host thread, so the range open at a
call's start is the one around it. On the CPU the ops run on the host:
each op's self CPU time stands in for device time, and its count for the
kernels', charged to the range open at the op's start.

Both measurements restore the solver's state, so a run with --measure-ops
ends in the state of a run without it. mgcfd_tpu's advance the state by
the measured cycles; the port differs from it there on purpose.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import time

import torch

from ..solver import solver as solver_mod

_TAG_RE = re.compile(r"^k_(?P<function>.+)_l(?P<level>\d+)$")
# seconds a profile on the card waits after it starts, before its work,
# and again after its work has synchronised, before it stops. The
# profiler keeps only the device records whose times fall inside its
# window, and its device times can sit milliseconds off the host clock
# that opens the window: with no wait at the start, a profile can lose
# the records of its first kernels (about 1 profile in 75 on the H100)
SETTLE_S = 0.25
# CUDA runtime and driver calls: cudaLaunchKernel, cuLaunchKernel, ...
_RUNTIME_RE = re.compile(r"^cu(da)?[A-Z]")


def _record() -> dict:
    return {"time_us": 0.0, "occurrences": 0, "kernels": {}}


@dataclasses.dataclass
class Measurement:
    """functions: (function, level) -> {"time_us", "occurrences",
    "kernels": {kernel name: [count, us]}}, the report's functions and
    the cycle's bookkeeping (invalid_count, residual, rms), which the
    reports leave out; other: the same for the device work outside every
    range; device: where it was measured."""

    functions: dict
    other: dict
    device: str

    @property
    def total_us(self) -> float:
        return self.other["time_us"] + sum(
            r["time_us"] for r in self.functions.values())


def _open_ranges(ranges, times):
    """For each time (or None), the key of the innermost of `ranges`
    ((start, end, key), properly nested) open then, else None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted((i for i, t in enumerate(times) if t is not None),
                   key=lambda i: times[i])
    keys = [None] * len(times)
    stack, j = [], 0
    for i in order:
        t = times[i]
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] <= ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        keys[i] = stack[-1][2] if stack else None
    return keys


def attribute(events, on_card: bool, device: str = "") -> Measurement:
    """Charge a profiler's events (prof.events()) to the ranges k_<f>_l<l>:
    on the card every device event (the ranges' device-side copies left
    out) through its launch call, on the CPU every op's self CPU time."""
    cpu = torch.autograd.DeviceType.CPU
    host = [e for e in events if e.device_type == cpu]
    ranges = []
    for e in host:
        m = _TAG_RE.match(e.name)
        if m:
            ranges.append((e.time_range.start, e.time_range.end,
                           (m["function"], int(m["level"]))))
    if on_card:
        calls = {e.id: e for e in host if _RUNTIME_RE.match(e.name)}
        charged = [(e.name, e.time_range.elapsed_us(), calls.get(e.id))
                   for e in events
                   if e.device_type != cpu and not _TAG_RE.match(e.name)]
    else:
        charged = [(e.name, e.self_cpu_time_total, e) for e in host
                   if not _TAG_RE.match(e.name)]
    keys = _open_ranges(ranges, [None if op is None else op.time_range.start
                                 for _, _, op in charged])
    functions, other = {}, _record()
    for (name, us, _), key in zip(charged, keys):
        rec = other if key is None else functions.setdefault(key, _record())
        rec["time_us"] += us
        rec["occurrences"] += 1
        count_us = rec["kernels"].setdefault(name, [0, 0.0])
        count_us[0] += 1
        count_us[1] += us
    return Measurement(functions, other, device)


@contextlib.contextmanager
def _preserved(solver):
    """An MGCFDSolver's state, RMS history and cycle count, restored on
    leaving; the cycles inside write no checkpoint."""
    state = {k: [t.clone() for t in v] for k, v in solver.state.items()}
    rms, done = list(solver.rms_history), solver.completed_cycles
    ck_every = solver.config.checkpoint_every
    solver.config.checkpoint_every = 0
    try:
        yield
    finally:
        solver.state = state
        solver.rms_history, solver.completed_cycles = rms, done
        solver.config.checkpoint_every = ck_every


def profile_cycles(solver, cycles: int = 1):
    """`cycles` cycles of `solver` (an InstrumentedSolver, whose calls
    then record no stats, or an MGCFDSolver) with the ranges switched on,
    under torch.profiler, CPU and, on the card, CUDA activity; the state
    restored afterwards. Returns the profiler. The kernels must be built
    already: a first launch's build would land inside the profile."""
    from torch.profiler import ProfilerActivity, profile

    from .instrument import InstrumentedSolver
    cuda = solver.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    if isinstance(solver, InstrumentedSolver):
        keep, run = solver.untimed(), \
            lambda: solver.run(cycles, warmup=False)
    else:
        keep, run = _preserved(solver), lambda: solver.run(cycles)
    with keep, solver_mod.measured_ranges():
        if cuda:
            torch.cuda.synchronize(solver.device)
        with profile(activities=acts) as prof:
            if cuda:
                time.sleep(SETTLE_S)
            run()
            if cuda:
                torch.cuda.synchronize(solver.device)
                time.sleep(SETTLE_S)
    return prof


def _measure(solver, cycles: int) -> Measurement:
    cuda = solver.device.type == "cuda"
    where = torch.cuda.get_device_name(solver.device) if cuda else "cpu"
    return attribute(profile_cycles(solver, cycles).events(), cuda, where)


def measure_instrumented(solver, cycles: int = 1) -> Measurement:
    """--measure-ops under --monitor instrumented: profile `cycles` more
    cycles of an InstrumentedSolver and fold each (function, level)'s
    measured device time and kernel count into stats.cost_details
    (MEASURED_DEVICE_TIME_US and MEASURED_OCCURRENCES rows of
    KernelCosts.csv) and stats.measured. The state is restored."""
    m = _measure(solver, cycles)
    for key, rec in m.functions.items():
        solver.stats.cost_details.setdefault(key, {}).update(
            measured_device_time_us=rec["time_us"],
            measured_occurrences=rec["occurrences"])
    solver.stats.measured = m.functions
    return m


def measure_production(solver, cycles: int = 1) -> Measurement:
    """--measure-ops under the fused monitor (mgcfd_tpu's _kscope
    attribution): profile `cycles` cycles of MGCFDSolver.run with its
    ranges switched on; a fused RK stage's launch lands on the flux row,
    and the eager ops each function runs land on that function's row.
    It profiles run, not run_batched: a replayed CUDA graph launches its
    kernels without entering the ranges. The state is restored."""
    return _measure(solver, cycles)


def export_trace(solver, directory: str) -> str:
    """--profile-dir: one more cycle under the profiler, its trace
    written as Chrome trace JSON into `directory`; the state is
    restored. Returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    profile_cycles(solver, 1).export_chrome_trace(path)
    return path
