"""Per-function instrumented solver (mgcfd_tpu's monitor/instrument.py).

MGCFDSolver runs a V-cycle as one stream of launches (or one CUDA graph
of K cycles), fast but unattributable. This solver mirrors the
reference's monitoring model (timer.cpp, loop_stats.cpp): each solver
function is its own call, timed as wall seconds through completion
(the device drained before the call, time.perf_counter around it and a
torch.cuda.synchronize after it: what mgcfd_tpu's block_until_ready
measures), accumulated per (function,
level) with its iteration count, and written as Times.csv and
LoopNumIters.csv in the reference's schema plus KernelCosts.csv
(monitor/events.py).

The cycle timed is MGCFDSolver's own: its run, with each function's
kscope (solver.py) wrapped in this solver's timer (solver.timed_calls),
so Times.csv attributes the kernels of the configuration users run
(solver.t_stage_factors, t_compute_fluxes, the time step, t_indirect_rw,
apply_restrict, apply_prolong, or the node-major twins on 'segment' and
'shift'). Every cycle is checked for an invalid state, as the
reference's instrumented run is. One deliberate exception: the fused RK
stages (fuse_stage on 'pallas', fuse_window_stage on 'window') are
switched off here. A fused launch covers flux, boundary/wall, time step
and the invalid count at once and cannot be split, so this solver times
the separate flux and time step dispatches that the fused kernel folds
together; the fused cycle's time per function comes from --measure-ops
on MGCFDSolver (monitor/opstats.measure_production), which charges the
fused launch to the flux row.

Iteration counts are mgcfd_tpu's: internal edges for flux, indirect_rw
and prolong, nodes for compute_step, time_step and restrict, and under
flux_fission internal + boundary + wall edges for `update`, the separate
accumulation of the per-edge values that the flux call then only stores.
As in mgcfd_tpu's instrumented solver, the crippled flux twin does not
run here (flux_cripple only labels the CSV's Flux variant field; the
fused cycle runs the twin outside every function, so --measure-ops on
MGCFDSolver charges it to no function), and this solver neither writes
nor resumes from checkpoints.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

from ..core.config import SolverConfig
from ..core.types import MultigridMesh
from ..solver.solver import MGCFDSolver, timed_calls, variable_major
from . import costs

# what a call of each timed function iterates over (mgcfd_tpu's counts);
# the cycle's bookkeeping (invalid_count, residual, rms) is not timed
_EDGE_FUNCTIONS = ("flux", "indirect_rw", "prolong")
_NODE_FUNCTIONS = ("compute_step", "time_step", "restrict")


@dataclasses.dataclass
class KernelStats:
    times: dict            # (function, level) -> seconds
    iters: dict            # (function, level) -> iterations
    calls: dict            # (function, level) -> calls
    total_time: float = 0.0
    # (function, level) -> {event key: value}: the pool the -p selection
    # draws KernelCosts.csv rows from (monitor/events.py)
    cost_details: dict = dataclasses.field(default_factory=dict)
    # (function, level) -> what --measure-ops measured
    # (monitor/opstats.py); empty unless it ran
    measured: dict = dataclasses.field(default_factory=dict)


class InstrumentedSolver:
    """Runs V-cycles one solver function at a time on a device (the card
    unless device='cpu'): owns a solver of `solver_class` for the mesh,
    plans and state, and times each function of its cycle."""

    solver_class = MGCFDSolver

    def __init__(self, mesh: MultigridMesh,
                 config: SolverConfig | None = None, device=None):
        config = config or SolverConfig()
        # mgcfd_tpu's instrumented solver neither resumes nor writes
        # checkpoints (see above); the fused stages cannot be split (see
        # above), so its levels are built for the unfused ones
        self._base = self.solver_class(mesh, dataclasses.replace(
            config, resume=False, checkpoint_every=0, fuse_stage=False,
            fuse_window_stage=False), device)
        self.mesh = mesh
        # the configuration as asked, resolved ('auto') by the base
        self.config = dataclasses.replace(
            self._base.config, fuse_stage=config.fuse_stage,
            fuse_window_stage=config.fuse_window_stage)
        self.device = self._base.device
        self.dmesh = self._base.dmesh
        self.tstate = variable_major(self.config)
        # the crippled twin does not run; every cycle checked
        self._base.config = dataclasses.replace(
            self._base.config, flux_cripple=False, check_invalid_every=1)
        self.stats = KernelStats(defaultdict(float), defaultdict(int),
                                 defaultdict(int))
        self._recording = True

    @property
    def state(self) -> dict:
        return self._base.state

    @state.setter
    def state(self, state: dict) -> None:
        self._base.state = state

    @property
    def rms_history(self) -> list:
        return self._base.rms_history

    @property
    def completed_cycles(self) -> int:
        return self._base.completed_cycles

    def variables(self, level: int = 0):
        """(N, 5) variables of one level, as float64 numpy (as
        MGCFDSolver.variables)."""
        return self._base.variables(level)

    def step_factors(self, level: int = 0):
        """(N,) step factors of the current state (as
        MGCFDSolver.step_factors)."""
        return self._base.step_factors(level)

    @contextlib.contextmanager
    def _timed(self, function: str, level: int, rng):
        """One call of `function` on `level` inside `rng`, as wall seconds
        through completion: the device drained before, synchronised
        after."""
        lvl = self.mesh.levels[level]
        if function in _EDGE_FUNCTIONS:
            iters = lvl.num_internal_edges
        elif function == "update":      # every edge's value, fission
            iters = lvl.num_edges
        elif function in _NODE_FUNCTIONS:
            iters = lvl.num_nodes
        else:
            with rng:
                yield
            return
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        with rng:
            t0 = time.perf_counter()
            yield
            if cuda:
                torch.cuda.synchronize(self.device)
            elapsed = time.perf_counter() - t0
        if self._recording:
            key = (function, level)
            self.stats.times[key] += elapsed
            self.stats.iters[key] += iters
            self.stats.calls[key] += 1

    def record_costs(self) -> None:
        """The model's bytes and operations of one call of each (function,
        level) that ran (monitor/costs.py) into stats.cost_details."""
        sz = torch.empty((), dtype=self._base.dtype).element_size()
        for function, level in self.stats.calls:
            nbytes, ops = costs.function_cost(
                function, self.dmesh.levels, level,
                *self._cost_path(level), sz, self.config.flux_fission,
                self._stage_factors(level),
                self.dmesh.variant.uses_legacy_step_factor)
            self.stats.cost_details.setdefault((function, level), {}).update(
                model_bytes=nbytes, model_operations=ops)

    def _cost_path(self, level: int):
        """(accumulate, variable_major) of the cost model on `level`."""
        return self.config.accumulate, self.tstate

    def _stage_factors(self, level: int) -> bool:
        """Whether `level`'s compute_step is step_factor (solver.py's
        variable-major visits)."""
        return self.tstate

    def run(self, cycles: int | None = None, verbose: bool = False,
            warmup: bool = True) -> KernelStats:
        """Timed run. With warmup (the default) one untimed cycle first
        builds the kernels and takes every first call's cost, then the
        state is restored, so Times.csv measures steady-state calls (what
        the reference's -DTIME timers measure)."""
        cycles = cycles if cycles is not None else self.config.num_cycles
        if warmup:
            with self.untimed():
                self.run(1, warmup=False)
        t_start = time.perf_counter()
        with timed_calls(self._timed):
            self._base.run(cycles, verbose)
        if self._recording:
            self.stats.total_time = time.perf_counter() - t_start
        return self.stats

    @contextlib.contextmanager
    def untimed(self):
        """Cycles inside the block record no stats and leave the state,
        the RMS history and the cycle count as they found them."""
        base = self._base
        snap = {k: list(v) for k, v in base.state.items()}
        rms, done = list(base.rms_history), base.completed_cycles
        self._recording = False
        try:
            yield
        finally:
            self._recording = True
            base.state = snap
            base.rms_history, base.completed_cycles = rms, done

    def write_reports(self, prefix: str = ""):
        """Times.csv, LoopNumIters.csv and KernelCosts.csv under `prefix`;
        returns their paths."""
        from .csvout import (CsvIdentification, write_costs_csv,
                             write_loop_stats_csv, write_times_csv)
        from .events import event_rows
        ident = CsvIdentification.build(self.config, self.mesh, self.device)
        L = len(self.dmesh.levels)
        self.record_costs()
        return (write_times_csv(prefix, ident, dict(self.stats.times), L,
                                self.stats.total_time),
                write_loop_stats_csv(prefix, ident, dict(self.stats.iters),
                                     L),
                write_costs_csv(prefix, ident,
                                event_rows(self.config, self.stats), L))
