"""The port's one recorder of host spans and counters.

span(name) records the name, the start and end (time.perf_counter_ns)
and the index of the span open when it started (its parent) in a store
held in memory for the life of the process: spans() returns it, total()
and self_time() sum it, reset() clears it. While a torch.profiler
session records, a span also opens the profiler range of its name, so
that it lands in the profile's events (and a Chrome trace) on the
profiler's clock beside the kernels; while none records it opens no
range. profiler_range is the one function of the port that opens
profiler ranges: the spans' and solver.kscope's k_<function>_l<level>.
A span also decorates a function: @span(name) records each call.

Span names start with "mgcfd." (never k_..._l<level>, which
monitor/opstats charges device time to). Set-up spans are recorded
always: each runs once per solver. Spans on the batch loop go through
when(profiling(), name), so that a batch outside a profile pays one test
and records nothing.

count(name, n) adds to a counter; counters() returns them, with the
counts of each source(prefix, read) as <prefix>.<name>: the kernels
package gives its wrappers' own launch counts as launches.<wrapper>, so
that this module imports no layer above it. Counters kept:
plans.loaded.<kind> and plans.built.<kind> (prep/plancache.py),
plans.key_bytes, upload.bytes, graph.captures, library.builds,
mesh.reads.native and mesh.reads.python (mesh/io_dat.py),
boundary.rows.stored and .all, window.entries.local and .all
(solver/solver.py prepare_device_mesh).

The store is written by the thread that drives the solver; spans do not
nest across threads.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch

OFF = contextlib.nullcontext()

# [name, start_ns, end_ns (None while open), parent index]
_store: list = []
# (index, record) of the open spans, innermost last
_open: list = []
_counts: dict = {}
# prefix -> a function that returns {name: count}
_sources: dict = {}


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]     # None while the span is open
    parent: Optional[int]     # index in spans() of the enclosing span

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def profiling() -> bool:
    """Whether a torch.profiler session is recording (one C call)."""
    return torch._C._autograd._profiler_enabled()


def profiler_range(name: str):
    """The profiler range `name`, as a context."""
    return torch.profiler.record_function(name)


class _Span(contextlib.ContextDecorator):
    __slots__ = ("_name", "_rec", "_rng")

    def __init__(self, name: str):
        self._name = name

    def _recreate_cm(self):
        # each call of a decorated function records a span of its own
        return _Span(self._name)

    def __enter__(self):
        rec = [self._name, time.perf_counter_ns(), None,
               _open[-1][0] if _open else None]
        _open.append((len(_store), rec))
        _store.append(rec)
        self._rec = rec
        self._rng = profiler_range(self._name) if profiling() else None
        if self._rng is not None:
            self._rng.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rng is not None:
            self._rng.__exit__(*exc)
        self._rec[2] = time.perf_counter_ns()
        # a reset() inside the span has emptied the stack already
        if _open and _open[-1][1] is self._rec:
            _open.pop()
        return False


def span(name: str) -> _Span:
    """A context, or a function's decorator, that records the span
    `name` (module docstring)."""
    return _Span(name)


def when(on: bool, name: str):
    """span(name) if on, else a shared context that does nothing."""
    return _Span(name) if on else OFF


def spans() -> list:
    """Every span recorded since the start or the last reset(), in the
    order they started."""
    return [Span(*rec) for rec in _store]


def total(name: str) -> float:
    """Seconds in the closed spans `name`, each counted once: a span
    inside another of the same name adds nothing."""
    every = spans()

    def outermost(s):
        p = s.parent
        while p is not None and every[p].name != name:
            p = every[p].parent
        return p is None
    return sum(s.seconds for s in every if s.name == name
               and s.end_ns is not None and outermost(s))


def self_time(name: str) -> float:
    """Seconds in the closed spans `name` that none of their child spans
    covers."""
    every = spans()
    children = {}
    for s in every:
        if s.parent is not None and s.end_ns is not None:
            children[s.parent] = children.get(s.parent, 0.0) + s.seconds
    return sum(s.seconds - children.get(i, 0.0)
               for i, s in enumerate(every)
               if s.name == name and s.end_ns is not None)


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def source(prefix: str, read) -> None:
    """Report read()'s {name: count} among the counters as
    <prefix>.<name>; the source keeps and resets its own counts."""
    _sources[prefix] = read


def counters(prefix: str = "") -> dict:
    """{name: count} of the counters whose names start with `prefix`,
    the prefix taken off, the sources' counts among them."""
    every = dict(_counts)
    for p, read in _sources.items():
        every.update((f"{p}.{k}", n) for k, n in read().items())
    return {k[len(prefix):]: v for k, v in sorted(every.items())
            if k.startswith(prefix)}


def reset() -> None:
    """Clear the spans and the counters (not the sources' counts)."""
    _store.clear()
    _open.clear()
    _counts.clear()


def report() -> list:
    """Lines for a log: each closed span name's seconds and self seconds,
    in the order the names first started, then the counters."""
    names = dict.fromkeys(s.name for s in spans() if s.end_ns is not None)
    lines = [f"span {n}: {total(n):.6f} s, self {self_time(n):.6f} s"
             for n in names]
    return lines + [f"counter {k}: {v}" for k, v in counters().items()]
