"""The per-function monitor (mgcfd_tpu's monitor/): the instrumented
solver, single-device and sharded, the reference's CSV reports, the `-p`
event selection, the cost model, and measured device time from
torch.profiler."""
from .csvout import (CsvIdentification, write_costs_csv,
                     write_loop_stats_csv, write_times_csv)
from .instrument import InstrumentedSolver, KernelStats
from .instrument_sharded import InstrumentedShardedSolver

__all__ = ["CsvIdentification", "write_times_csv", "write_loop_stats_csv",
           "write_costs_csv", "InstrumentedSolver",
           "InstrumentedShardedSolver", "KernelStats"]
