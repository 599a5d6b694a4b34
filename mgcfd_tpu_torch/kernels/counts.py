"""The one store of the kernel wrappers' launch counters, keyed by the
names utils.spans's counters() reports them under (kernels/__init__.py
reads and resets it)."""
from __future__ import annotations

import collections

COUNTS: collections.Counter = collections.Counter()


def launched(*names: str, epilogues=(), gathered=(), n: int = 1) -> None:
    """n kernel launches, counted under launches.<name> for each of names
    (the wrapper's, and an edge_csr wrapper's shape counter), under
    epilogue.<name> for each epilogue they carried and under
    <name>.gathered for each stored operand they gathered in place of
    computing it (primitives: the fused stage's)."""
    for name in names:
        COUNTS[f"launches.{name}"] += n
    for name in epilogues:
        COUNTS[f"epilogue.{name}"] += n
    for name in gathered:
        COUNTS[f"{name}.gathered"] += n
