"""Readings of the program's own spans (mgcfd_tpu_torch/utils/spans.py)
for the per-layer metrics: the set-up spans from this process's store,
the batch spans from the traced run's idle gaps, which cfdbench/trace.py
names by the outermost host op (a span, while the profile records).

A program without the store (a port older than its spans) reads 0, the
sum over no spans; a program with the store that recorded no such span
reads None, so that a span the program lost fails the run. A batch span
that the store holds but under which the device never idled reads 0.
"""


def _store():
    """The program's span store, or None where it has none."""
    try:
        from mgcfd_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def _recorded(spans, name: str) -> bool:
    return any(s.name == name and s.end_ns is not None
               for s in spans.spans())


def setup_seconds(name: str):
    """Host seconds of the program's spans `name` in this process, each
    counted once where they nest."""
    spans = _store()
    if spans is None:
        return 0.0
    if not _recorded(spans, name):
        return None
    return spans.total(name)


def idle_share(record: dict, name: str):
    """100 x the seconds of the traced run's idle gaps under the host
    span `name` over the span of the device's records; None without a
    trace, or where the store holds no such span (module docstring)."""
    tr = record.get("trace")
    if not tr:
        return None
    spans = _store()
    if spans is not None and not _recorded(spans, name):
        return None
    gaps = sum(s for op, s in tr["idle_gaps"] if op == name)
    return 100.0 * gaps / tr["span_s"]
