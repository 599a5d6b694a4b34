"""The per-function instrumented solver over the sharded solver
(mgcfd_tpu's monitor/instrument_sharded.py), for --partitions P runs.

Each rank runs ShardedSolver's own cycle with the fused stages off, and
InstrumentedSolver's timer times each solver function of it on that
rank: compute_step, flux, time_step, indirect_rw, restrict and prolong
per level, the same ranges as the single-device solver's. A sharded
level's call includes its collectives (the separator gather, the MIN and
SUM reductions, the reduce-scatters), as the rank waits for them; the
replicated levels' calls are the single-device solver's. The iteration
counts are the whole level's, as mgcfd_tpu's (`Num threads` in the
reports is the partition count). Every rank keeps its own times; the CLI
writes rank 0's reports. The cost rows model one rank's share: its
block's CSRs or edge stream on a sharded level.
"""
from __future__ import annotations

from ..parallel.sharded import ShardedSolver
from .instrument import InstrumentedSolver


class InstrumentedShardedSolver(InstrumentedSolver):
    """InstrumentedSolver over a ShardedSolver: build one in every rank of
    the process group, as ShardedSolver."""

    solver_class = ShardedSolver

    @property
    def rank(self) -> int:
        return self._base.rank

    def _cost_path(self, level: int):
        base = self._base
        if level < base.S:       # the block's CSRs, else its edge stream
            return ("window", True) if base._kernels else ("segment", False)
        return self.config.accumulate, self.tstate

    def _stage_factors(self, level: int) -> bool:
        # the block levels' step factor is the sharded solver's own
        return level >= self._base.S and self.tstate
