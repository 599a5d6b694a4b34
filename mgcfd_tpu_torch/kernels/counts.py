"""The one store of the kernel wrappers' launch counters, keyed by the
names utils.spans's counters() reports them under (kernels/__init__.py
reads and resets it)."""
from __future__ import annotations

import collections

COUNTS: collections.Counter = collections.Counter()


def launched(*names: str, epilogues=(), n: int = 1) -> None:
    """n kernel launches, counted under launches.<name> for each of names
    (the wrapper's, and an edge_csr wrapper's shape counter) and under
    epilogue.<name> for each epilogue they carried."""
    for name in names:
        COUNTS[f"launches.{name}"] += n
    for name in epilogues:
        COUNTS[f"epilogue.{name}"] += n
