"""What the sharded tests run inside each gloo rank (imported by name in
the ranks, so it imports neither jax nor mgcfd_tpu), and how they start
the ranks: gloo ranks on the CPU (parallel/launch.py forks them from one
forkserver, so that a test's ranks start in well under a second). Rank 0 writes the results
into an npz file for the test to read."""
import numpy as np
import torch

from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.parallel import ShardedSolver
from mgcfd_tpu_torch.parallel.launch import run_ranks


def launch(fn, P: int, *args) -> None:
    run_ranks(fn, P, args, device_type="cpu", timeout_s=300)


def joined(rank) -> None:
    """A rank that only joins the group (and leaves it)."""


def load(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return dict(z.items())


def _save(solver, out, **extra) -> None:
    """Every level's variables (a collective) and the RMS history; rank 0
    writes them."""
    vs = [solver.variables(lev) for lev in range(solver.mesh.num_levels)]
    if solver.rank == 0:
        np.savez(out, *vs, rms=np.asarray(solver.rms_history),
                 cycles=solver.completed_cycles, **extra)


def solve(rank, mesh, cfg: dict, cycles: int, out, batched: int = 0):
    """run (or run_batched with K = batched) `cycles` cycles; also the
    partition's facts the tests check."""
    s = ShardedSolver(mesh, SolverConfig(**cfg), device="cpu")
    if batched:
        s.run_batched(cycles, batched)
    else:
        s.run(cycles)
    _save(s, out, accumulate=s.config.accumulate,
          sharded_levels=len(s.smesh.levels),
          sep=float(s.smesh.level0.sep_mask.sum()),
          partitioned_2d=s.part_orders is not None)


def primitive_buffers(rank, mesh, cfg: dict, cycles: int, out):
    """`cycles` cycles, then as many from the same start with the
    replicated levels' primitive buffers dropped: each level's variables
    and the RMS histories of both, and which levels had buffers."""
    s = ShardedSolver(mesh, SolverConfig(**cfg), device="cpu")
    has = [lvl.prims is not None for lvl in s.dmesh.levels]
    start = {key: [t.clone() for t in v] for key, v in s.state.items()}
    s.run(cycles)
    got = {f"with{lev}": s.variables(lev)
           for lev in range(mesh.num_levels)}
    rms = list(s.rms_history)
    s.state, s.rms_history = start, []
    for lvl in s.dmesh.levels:
        lvl.prims = None
    s.run(cycles)
    got.update({f"without{lev}": s.variables(lev)
                for lev in range(mesh.num_levels)})
    if s.rank == 0:
        np.savez(out, has_buffers=np.asarray(has), rms_with=np.asarray(rms),
                 rms_without=np.asarray(s.rms_history), **got)


def resume(rank, mesh, cfg: dict, cycles: int, out):
    """A solver that resumes from cfg's checkpoint_dir, then `cycles`
    more; the start state too."""
    s = ShardedSolver(mesh, SolverConfig(**cfg), device="cpu")
    start = [s.variables(lev) for lev in range(mesh.num_levels)]
    s.run(cycles)
    _save(s, out, **{f"start{lev}": v for lev, v in enumerate(start)})


def instrumented(rank, mesh, cfg: dict, cycles: int, prefix: str, out):
    """The instrumented sharded solver's run, its reports (rank 0) and
    --measure-ops of the production solver."""
    from mgcfd_tpu_torch.monitor import InstrumentedShardedSolver
    from mgcfd_tpu_torch.monitor.opstats import measure_production
    ins = InstrumentedShardedSolver(
        mesh, SolverConfig(**{**cfg, "monitor_mode": "instrumented"}),
        device="cpu")
    stats = ins.run(cycles)
    keys = sorted(f"{f}:{lev}" for f, lev in stats.times)
    iters = {f"iters:{f}:{lev}": v for (f, lev), v in stats.iters.items()}
    if rank == 0:
        ins.write_reports(prefix)
    prod = ShardedSolver(mesh, SolverConfig(**cfg), device="cpu")
    prod.run(1)
    m = measure_production(prod, 1)
    vs = [ins.variables(lev) for lev in range(mesh.num_levels)]
    if rank == 0:
        np.savez(out, *vs, keys=np.asarray(keys),
                 measured=np.asarray(sorted(f"{f}:{lev}"
                                            for f, lev in m.functions)),
                 **iters)


def bf16_pair(rank, mesh, cfg: dict, cycles: int, out):
    """The sharded solver at bf16: its raw (5, N) bf16 state per level
    (gathered, the caller's order) for bit-level comparison."""
    s = ShardedSolver(mesh, SolverConfig(**cfg), device="cpu")
    s.run(cycles)
    raw = [s._level_node_major(t, lev).float().numpy()
           for lev, t in enumerate(s.state["variables"])]
    if rank == 0:
        np.savez(out, *raw)


torch.set_num_threads(1)
