"""Command-line driver, mgcfd_tpu's for one device:

    python -m mgcfd_tpu_torch.cli.main -i input.dat [-d DIR] [-m M]
        [--renumber] -g 10
    python -m mgcfd_tpu_torch.cli.main -c run.conf -v --output-variables
    python -m mgcfd_tpu_torch.cli.main --synthetic 68,64,70,4 -g 10
    python -m mgcfd_tpu_torch.cli.main --synthetic 8,8,8,2 -g 2
        --platform cpu --monitor instrumented -o out/ [--measure-ops]
        [-p events.conf] [--profile-dir DIR]

The reference binary's interface (config.cpp:32-47, :281-305):
-i/--input-file (input.dat), -c/--config-filepath (`key = value` lines,
'#' comments; flags override the file), -d/--input-directory,
-o/--output-file-prefix, -m/--mesh-duplicate-count, -g/--num-cycles,
-v/--validate-result (the per-level invalid scan, then the level-0
variables against <dir>/solution.variables.size=<m>x.cycles=<g>.level=0
at the reference's tolerances; exit 1 on a mismatch) and the dumps
--output-variables, --output-step-factors, --output-volumes,
--output-fluxes (the end-of-run fluxes array, all zeros as the
reference's) and --output-edge-fluxes (validate/golden.py). The mesh is
loaded, then duplicated, then renumbered (--renumber, RCM), or generated
(--synthetic NX,NY,NZ,L, the flagship box family). Then --dtype,
--accumulate, --transposed, --no-indirect-rw, --platform (cuda, the
default, or cpu), the kernel variants --flux-cripple,
--flux-precompute-edge-weights, --flux-fission, --flux-reuse-div and
--flux-reuse-factor, checkpoints (--checkpoint-dir, --checkpoint-every,
--resume) and --plan-cache. The monitor (monitor/): --monitor
instrumented writes Times.csv, LoopNumIters.csv and KernelCosts.csv under
-o, with the events -p/--papi-config-file selects; --measure-ops and
--profile-dir profile one more cycle after the run and restore the state,
so the dumps and -v see the state after -g cycles (mgcfd_tpu's advance
it by that cycle). --compile-cache and --dump-hlo have no counterpart
(there is no XLA program).

The sharded solver (parallel/): --partitions P (config key partitions),
--partition-2d PXxPY|auto and --shard-levels S, dispatched as mgcfd_tpu's
CLI dispatches them (the instrumented monitor and resume included). How
the P ranks start:
  - run plainly, the CLI starts P ranks itself (parallel/launch.py), each
    a process that runs this same command in one process group: NCCL
    ranks, rank p on card p, on --platform cuda (P cards needed); gloo
    ranks on --platform cpu;
  - under torchrun (WORLD_SIZE set), each process joins torchrun's group
    (env://), which must have WORLD_SIZE == P; card LOCAL_RANK.
Every rank loads the mesh and runs the solver; rank 0 prints, validates
and writes the dumps and reports.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch.distributed as dist

from ..core.config import ACCUMULATE_MODES, DTYPES, MONITOR_MODES, \
    SolverConfig
from ..validate.golden import (ValidationError, dump_edge_fluxes,
                               dump_scalars, dump_variables,
                               identify_differences, output_filepath,
                               read_solution, solution_filepath)

# mgcfd_tpu's flags that the port refuses, and why
_REFUSED = {
    "compile_cache": "--compile-cache has no counterpart in the port: it "
                     "compiles no XLA program (its kernels build once into "
                     "build/mgcfd_tpu_torch/)",
    "dump_hlo": "--dump-hlo has no counterpart in the port: it compiles "
                "no XLA program, so there is no HLO to dump (its kernels "
                "are CUDA C++ sources under csrc/)",
}


def read_config_file(path: str, cfg: SolverConfig) -> None:
    """mgcfd_tpu's read_config_file: the same keys set the same fields;
    relative directories are relative to the config file
    (config.cpp:196-216)."""
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, value = (s.strip() for s in line.split("=", 1))
            if key == "input_file":
                cfg.input_file = value
            elif key == "input_file_directory":
                cfg.input_file_directory = (
                    value if value.startswith("/")
                    else (base if value == "./"
                          else os.path.join(base, value)))
            elif key == "output_file_prefix":
                cfg.output_file_prefix = value
            elif key == "mesh_duplicate_count":
                cfg.mesh_duplicate_count = int(value)
            elif key == "cycles":
                cfg.num_cycles = int(value)
            elif key == "output_variables":
                cfg.output_variables = value == "Y"
            elif key == "output_step_factors":
                cfg.output_step_factors = value == "Y"
            elif key == "output_fluxes":
                cfg.output_fluxes = value == "Y"
            elif key == "output_volumes":
                cfg.output_volumes = value == "Y"
            elif key == "output_edge_fluxes":
                cfg.output_edge_fluxes = value == "Y"
            elif key == "dtype":
                cfg.dtype = value
            elif key == "partitions":
                cfg.num_partitions = int(value)
            elif key == "shard_levels":
                cfg.shard_levels = int(value)
            elif key == "partition_2d":
                cfg.partition_2d = value
            elif key == "papi_config_file":
                cfg.event_config_file = (
                    value if value.startswith("/")
                    else os.path.join(base, value))
            elif key == "compile_cache":
                cfg.compile_cache_dir = (
                    value if value.startswith("/")
                    else os.path.join(base, value))
            elif key in ("omp_num_threads", "output_old_variables",
                         "config_filepath"):
                pass  # accepted for reference compatibility
            else:
                print(f"WARNING: Unknown key '{key}' encountered during "
                      f"parsing of config file.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mgcfd-torch",
        description="Multigrid Euler solver (PyTorch + CUDA port of "
                    "mgcfd_tpu)")
    p.add_argument("-i", "--input-file", default=None,
                   help="multigrid input grid (input.dat descriptor)")
    p.add_argument("-c", "--config-filepath", default=None,
                   help="key=value config file")
    p.add_argument("-d", "--input-directory", default=None)
    p.add_argument("-o", "--output-file-prefix", default=None,
                   help="prefix of the dumps and reports (a directory if "
                        "it ends in '/')")
    p.add_argument("-m", "--mesh-duplicate-count", type=int, default=None)
    p.add_argument("-g", "--num-cycles", type=int, default=None)
    p.add_argument("-v", "--validate-result", action="store_true",
                   help="check the final level-0 variables against the "
                        "solution file in the input directory")
    p.add_argument("-p", "--papi-config-file", default=None,
                   help="event selection of KernelCosts.csv, one name a "
                        "line: CALLS, MODEL_BYTES, MODEL_OPERATIONS, "
                        "MEASURED_DEVICE_TIME_US, MEASURED_OCCURRENCES")
    p.add_argument("--output-variables", action="store_true")
    p.add_argument("--output-fluxes", action="store_true")
    p.add_argument("--output-step-factors", action="store_true")
    p.add_argument("--output-volumes", action="store_true")
    p.add_argument("--output-edge-fluxes", action="store_true")
    p.add_argument("--dtype", default=None, choices=DTYPES)
    p.add_argument("--shard-levels", type=int, default=None,
                   help="with --partitions: shard the finest S levels "
                        "(0 = auto: while a level keeps 4096 nodes a "
                        "shard); the coarser ones are replicated")
    p.add_argument("--partitions", type=int, default=None,
                   help="run the sharded solver over P ranks, one shard "
                        "each (NCCL, one card a rank; gloo on --platform "
                        "cpu); the CLI starts them unless torchrun did")
    p.add_argument("--partition-2d", default=None, metavar="PXxPY|auto",
                   help="with --partitions: 2-D tile decomposition "
                        "(e.g. 2x2, or auto) instead of 1-D slabs")
    p.add_argument("--monitor", default=None, choices=MONITOR_MODES,
                   help="'instrumented': time each solver function and "
                        "write the reference's reports (monitor/)")
    p.add_argument("--synthetic", default=None, metavar="NX,NY,NZ,L",
                   help="run on a generated box hierarchy instead of -i")
    p.add_argument("--accumulate", default=None, choices=ACCUMULATE_MODES,
                   help="'auto' (default): 'segment' with --flux-fission "
                        "or on the CPU; on CUDA the span kernels "
                        "('pallas') on box-class meshes, else the CSR "
                        "kernels ('window')")
    p.add_argument("--renumber", action="store_true",
                   help="RCM-renumber the mesh hierarchy before solving "
                        "(prep/renumber.py): imported meshes arrive in "
                        "arbitrary order and the kernels' gathers depend "
                        "on locality. Dumps and validation then use the "
                        "renumbered node order")
    p.add_argument("--flux-cripple", action="store_true",
                   help="also run the arithmetic-free flux twin "
                        "(FLUX_CRIPPLE); its result is discarded")
    p.add_argument("--flux-precompute-edge-weights", action="store_true",
                   help="precompute |edge normal| "
                        "(FLUX_PRECOMPUTE_EDGE_WEIGHTS)")
    p.add_argument("--flux-fission", action="store_true",
                   help="two-phase flux: per-edge store + update "
                        "(FLUX_FISSION; the edge-stream modes only)")
    p.add_argument("--flux-reuse-div", action="store_true",
                   help="FLUX_REUSE_DIV (reporting only)")
    p.add_argument("--flux-reuse-factor", action="store_true",
                   help="FLUX_REUSE_FACTOR (reporting only)")
    p.add_argument("--no-indirect-rw", action="store_true",
                   help="skip the indirect_rw data-movement twin")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None,
                   metavar="CYCLES")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--transposed", action="store_true",
                   help="variable-major (5, N) state for "
                        "--accumulate shift")
    p.add_argument("--measure-ops", action="store_true",
                   help="profile one more cycle after the run and charge "
                        "its device time to each solver function and "
                        "level (torch.profiler; the state is restored)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write the profiler trace of one more cycle "
                        "(Chrome trace JSON) into DIR")
    p.add_argument("--plan-cache", default=None, metavar="DIR",
                   help="content-keyed cache of the port's plans "
                        "(prep/plancache.py)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="refused: " + _REFUSED["compile_cache"])
    p.add_argument("--dump-hlo", default=None, metavar="DIR",
                   help="refused: " + _REFUSED["dump_hlo"])
    return p


def config_from_args(args) -> SolverConfig:
    """The run's configuration: the config file's, then the flags'."""
    cfg = SolverConfig()
    if args.config_filepath:
        read_config_file(args.config_filepath, cfg)
    if args.input_file is not None:
        cfg.input_file = args.input_file
    if args.input_directory is not None:
        cfg.input_file_directory = args.input_directory
    if args.output_file_prefix is not None:
        cfg.output_file_prefix = args.output_file_prefix
    if args.mesh_duplicate_count is not None:
        cfg.mesh_duplicate_count = args.mesh_duplicate_count
    if args.num_cycles is not None:
        cfg.num_cycles = args.num_cycles
    cfg.validate_result |= args.validate_result
    cfg.output_variables |= args.output_variables
    cfg.output_fluxes |= args.output_fluxes
    cfg.output_step_factors |= args.output_step_factors
    cfg.output_volumes |= args.output_volumes
    cfg.output_edge_fluxes |= args.output_edge_fluxes
    if args.dtype:
        cfg.dtype = args.dtype
    if args.partitions is not None:
        cfg.num_partitions = args.partitions
    if args.shard_levels is not None:
        cfg.shard_levels = args.shard_levels
    if args.partition_2d is not None:
        cfg.partition_2d = args.partition_2d
    if args.monitor:
        cfg.monitor_mode = args.monitor
    if args.accumulate:
        cfg.accumulate = args.accumulate
    cfg.transposed |= args.transposed
    cfg.flux_cripple |= args.flux_cripple
    cfg.flux_precompute_edge_weights |= args.flux_precompute_edge_weights
    cfg.flux_fission |= args.flux_fission
    cfg.flux_reuse_div |= args.flux_reuse_div
    cfg.flux_reuse_factor |= args.flux_reuse_factor
    if args.no_indirect_rw:
        cfg.include_indirect_rw = False
    if args.papi_config_file is not None:
        cfg.event_config_file = args.papi_config_file
    if args.plan_cache is not None:
        cfg.plan_cache_dir = args.plan_cache
    if args.checkpoint_dir is not None:
        cfg.checkpoint_dir = args.checkpoint_dir
    if args.checkpoint_every is not None:
        cfg.checkpoint_every = args.checkpoint_every
    cfg.resume |= args.resume
    return cfg


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for dest, why in _REFUSED.items():
        if getattr(args, dest) is not None:
            parser.error(why)
    cfg = config_from_args(args)
    try:
        cfg.validate()
    except (NotImplementedError, ValueError) as e:
        # the config file's compile_cache key is refused here, by name
        parser.error(str(e))
    sharded = cfg.num_partitions > 1
    if sharded and not dist.is_initialized():
        return _start_ranks(parser, args, cfg.num_partitions,
                            list(sys.argv[1:] if argv is None else argv))

    if args.synthetic:
        from ..bench.flagship import FlagshipSpec, flagship_mesh
        nx, ny, nz, L = (int(x) for x in args.synthetic.split(","))
        mesh = flagship_mesh(FlagshipSpec(nx=nx, ny=ny, nz=nz,
                                          num_levels=L))
    else:
        if not cfg.input_file:
            print("ERROR: input_file not set")
            return 1
        from ..mesh import load_multigrid_mesh
        path = cfg.input_file
        if cfg.input_file_directory:
            path = os.path.join(cfg.input_file_directory, cfg.input_file)
        mesh = load_multigrid_mesh(path, cfg.input_file_directory)
    if cfg.mesh_duplicate_count > 1:
        from ..mesh import duplicate_mesh
        mesh = duplicate_mesh(mesh, cfg.mesh_duplicate_count)
    if args.renumber:
        from ..prep.renumber import renumber_hierarchy
        mesh = renumber_hierarchy(mesh)

    instrumented = cfg.monitor_mode == "instrumented"
    # mgcfd_tpu's dispatch (its cli/main.py:282-296)
    if instrumented:
        from ..monitor import InstrumentedShardedSolver, InstrumentedSolver
        Solver = InstrumentedShardedSolver if sharded else \
            InstrumentedSolver
    elif sharded:
        from ..parallel import ShardedSolver as Solver
    else:
        from ..solver import MGCFDSolver as Solver
    solver = Solver(mesh, cfg, device=args.platform)
    _log_setup()
    say = print if getattr(solver, "rank", 0) == 0 else _quiet
    say(f"mesh {mesh.name}: {mesh.levels[0].num_nodes} nodes, "
        f"{mesh.num_levels} levels; dtype={cfg.dtype} "
        f"accumulate={solver.config.accumulate} device={solver.device} "
        f"monitor={cfg.monitor_mode}"
        + (f" partitions={cfg.num_partitions}" if sharded else ""),
        flush=True)
    cycles = cfg.num_cycles
    if not instrumented:
        # as mgcfd_tpu's CLI: a resumed run makes up the remaining cycles
        cycles = max(0, cfg.num_cycles - solver.completed_cycles)
        if cycles < cfg.num_cycles:
            say(f"Resumed at cycle {solver.completed_cycles}; "
                f"running {cycles} more")
    t0 = time.perf_counter()
    solver.run(cycles, verbose=True)
    say(f"{cycles} cycles in {time.perf_counter() - t0:.3f} s "
        "(host clock, set-up excluded)")
    _monitor_reports(args, cfg, mesh, solver, instrumented, say)
    if cfg.validate_result and not _validate(cfg, mesh, solver, say):
        return 1
    _dumps(cfg, mesh, solver, say is print)
    return 0


def _log_setup() -> None:
    """Under MGCFD_LOG=1, the set-up's spans and the counters
    (utils/spans.py) once set-up has ended."""
    from ..utils import spans
    from ..utils.logging import log, log_enabled
    if log_enabled():
        for line in spans.report():
            log("set-up %s", line)


def _quiet(*args, **kwargs) -> None:
    """print on ranks other than 0."""


def _start_ranks(parser, args, P: int, argv: list) -> int:
    """--partitions P outside a process group: join torchrun's (WORLD_SIZE
    set) and run, or start P ranks that each run this command (module
    docstring). Returns the exit code."""
    from ..parallel import comm, launch
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != P:
            parser.error(f"--partitions {P} under torchrun with "
                         f"WORLD_SIZE={world}: they must be equal")
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        comm.init_process_group(rank, world, "env://",
                                comm.rank_device(args.platform, local))
        try:
            return main(argv)
        finally:
            dist.destroy_process_group()
    if args.platform == "cuda":
        import torch
        if torch.cuda.device_count() < P:
            parser.error(f"--partitions {P} needs {P} cards (one NCCL rank "
                         f"a card); this machine has "
                         f"{torch.cuda.device_count()}")
    try:
        launch.run_ranks(_rank_main, P, (argv,), device_type=args.platform)
    except RuntimeError as e:
        print(f"ERROR: {e}")
        return 1
    finally:
        launch.stop_servers()
    return 0


def _rank_main(rank: int, argv: list) -> None:
    """One rank of --partitions: this command inside the process group."""
    rc = main(argv)
    if rc:
        sys.exit(rc)


def _validate(cfg: SolverConfig, mesh, solver, say=print) -> bool:
    """-v (euler3d_cpu_double.cpp:704-744): every level's invalid scan,
    then the level-0 variables against the solution file. False on a
    failure, after printing why. On the sharded solver every rank takes
    part (variables() gathers) and reaches the same verdict."""
    import torch
    from ..ops.validation import invalid_variables_count
    say("Beginning validation of variables[]")
    bad = [int(invalid_variables_count(torch.as_tensor(
        solver.variables(level)))) for level in range(mesh.num_levels)]
    for level, n_bad in enumerate(bad):
        if n_bad:
            say(f"  level {level}: {n_bad} invalid entries")
            return False
    say("  NaN check passed")
    sol_path = solution_filepath(cfg.input_file_directory, "variables",
                                 cfg.mesh_duplicate_count, cfg.num_cycles, 0)
    if not os.path.exists(sol_path):
        say("  could not open variables solution file:")
        say(f"    {sol_path}")
        say("  aborting validation")
        return True
    vars0 = solver.variables(0)
    sol = read_solution(sol_path, vars0.shape[0])
    try:
        identify_differences(vars0, sol, mesh.variant)
    except ValidationError as e:
        # the reference reports the offending value and exits
        # EXIT_FAILURE (validation.cpp:188-196)
        say(f"Validation of variables[] failed: {e}")
        return False
    say("PASS: variables[] validated successfully")
    return True


def _dumps(cfg: SolverConfig, mesh, solver, write: bool = True) -> None:
    """The finest level's dumps (euler3d_cpu_double.cpp:749-772). On the
    sharded solver every rank gathers the values and rank 0 (write)
    writes them."""
    def path(name):
        return output_filepath(cfg.output_file_prefix, name,
                               cfg.mesh_duplicate_count, cfg.num_cycles, 0)

    say = print if write else _quiet
    if cfg.output_variables:
        v = solver.variables(0)
        say(f"Dumping variables[] to file: {path('variables')}")
        if write:
            dump_variables(path("variables"), v)
    if cfg.output_step_factors:
        sf = solver.step_factors(0)
        if write:
            dump_scalars(path("step_factors"), sf)
    if cfg.output_volumes and write:
        dump_scalars(path("volumes"), mesh.levels[0].volumes)
    if cfg.output_fluxes and write:
        # the reference dumps the fluxes array's end-of-run state, which
        # every RK stage's time step clears: all zeros
        # (dump_flux, io_enhanced.cpp:791-817)
        say(f"Dumping fluxes[] to file: {path('fluxes')}")
        dump_variables(path("fluxes"),
                       np.zeros((mesh.levels[0].num_nodes, 5)))
    if cfg.output_edge_fluxes:
        values = _edge_flux_values(mesh, solver)
        if write:
            paths = dump_edge_fluxes(cfg.output_file_prefix,
                                     cfg.mesh_duplicate_count,
                                     cfg.num_cycles, 0, *values)
            say(f"Dumped edge fluxes: {len(paths)} files")


def _edge_flux_values(mesh, solver):
    """Per-edge internal, boundary and wall flux values of the final
    level-0 variables, at fp64 on the host, from the level's edge
    weights reconditioned as the solver conditioned them."""
    import dataclasses

    import torch
    from ..core.constants import far_field_state
    from ..mesh.build import apply_ewt_conditioning
    from ..ops import boundary_edge_flux, internal_edge_flux, wall_edge_flux
    l0 = dataclasses.replace(mesh.levels[0], edge_w=mesh.levels[0].edge_w
                             .copy(), bedge_w=mesh.levels[0].bedge_w.copy(),
                             wedge_w=mesh.levels[0].wedge_w.copy())
    apply_ewt_conditioning([l0], mesh.variant)
    v0 = torch.as_tensor(solver.variables(0))

    def t(a):
        return torch.as_tensor(np.asarray(a))

    def idx(a):
        return t(a).long()

    vi = internal_edge_flux(v0[idx(l0.edge_a)], v0[idx(l0.edge_b)],
                            t(l0.edge_w))
    vb = boundary_edge_flux(v0[idx(l0.bedge_b)], t(l0.bedge_w))
    vw = wall_edge_flux(v0[idx(l0.wedge_b)], t(l0.wedge_w),
                        t(far_field_state(np.float64)[1]))
    return vi.numpy(), vb.numpy(), vw.numpy()


def _monitor_reports(args, cfg, mesh, solver, instrumented: bool,
                     say=print) -> None:
    """--profile-dir, --measure-ops and the instrumented reports, after
    the run (mgcfd_tpu/cli/main.py:282-362, :460-462). On the sharded
    solver every rank profiles (the cycles hold collectives) and rank 0
    (say is print) reports its own measurement and writes the files."""
    from ..monitor import opstats
    write = say is print
    if args.profile_dir:
        if write:
            path = opstats.export_trace(solver, args.profile_dir)
            say(f"Profiler trace written to: {path}")
        else:
            opstats.profile_cycles(solver, 1)
    if args.measure_ops and instrumented:
        m = opstats.measure_instrumented(solver)
        say(f"Measured time captured for {len(m.functions)} functions "
            f"on {m.device} (MEASURED_* rows of KernelCosts.csv)")
    elif args.measure_ops:
        from ..monitor.csvout import CsvIdentification, write_costs_csv
        m = opstats.measure_production(solver)
        if not write:
            return
        for (k, lev), r in sorted(m.functions.items(),
                                  key=lambda kv: (kv[0][1], kv[0][0])):
            print(f"  measured {k} level {lev}: {r['time_us']:.1f} us on "
                  f"{m.device} ({r['occurrences']} ops)")
        print(f"  outside the functions: {m.other['time_us']:.1f} us on "
              f"{m.device} ({m.other['occurrences']} ops)")
        rows = [("MEASURED_DEVICE_TIME_US",
                 {kl: r["time_us"] for kl, r in m.functions.items()}),
                ("MEASURED_OCCURRENCES",
                 {kl: r["occurrences"] for kl, r in m.functions.items()})]
        path = write_costs_csv(
            cfg.output_file_prefix,
            CsvIdentification.build(cfg, mesh, solver.device), rows,
            mesh.num_levels)
        print(f"Measured time captured for {len(m.functions)} functions "
              f"on {m.device} -> {path}")
    if instrumented and write:
        paths = solver.write_reports(cfg.output_file_prefix)
        print(f"Loop runtimes written to: {paths[0]}")
        print(f"Loop stats written to: {paths[1]}")
        print(f"Kernel costs written to: {paths[2]}")


if __name__ == "__main__":
    sys.exit(main())
