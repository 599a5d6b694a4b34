"""Command-line entry point, a subset of mgcfd_tpu's flags:

    python -m mgcfd_tpu_torch.cli.main -i input.dat [-d DIR] [-m M]
        [--renumber] -g 10
    python -m mgcfd_tpu_torch.cli.main --synthetic 68,64,70,4 -g 10
    python -m mgcfd_tpu_torch.cli.main --synthetic 8,8,8,2 -g 2
        --platform cpu --monitor instrumented -o out/ [--measure-ops]
        [-p events.conf] [--profile-dir DIR]

-i/--input-file (the reference's input.dat), -d/--input-directory,
-m/--mesh-duplicate-count, --renumber (RCM, prep/renumber.py) or
--synthetic NX,NY,NZ,L (the flagship box family); -g, --dtype,
--accumulate, --transposed, --no-indirect-rw and --platform (cuda, the
default, or cpu). The mesh is loaded, then duplicated, then renumbered, in
the order of mgcfd_tpu's CLI. The monitor (monitor/): --monitor
instrumented times each solver function and writes Times.csv,
LoopNumIters.csv and KernelCosts.csv under -o/--output-file-prefix, with
the events -p/--papi-config-file selects; --measure-ops profiles one more
cycle and charges device time to each (function, level), under either
monitor; --profile-dir writes one more cycle's profiler trace. Both
restore the state after their cycle. Any other flag of the JAX CLI is
refused, naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from ..core.config import ACCUMULATE_MODES, DTYPES, MONITOR_MODES, \
    SolverConfig

# flags of mgcfd_tpu's CLI still refused, by name or (ending in '-')
# prefix -> the ROADMAP item that brings them; any other is item 8's
_REFUSED = {"--output-": "item 6 (validate/golden.py dumps)",
            "-v": "item 6 (validate/)", "--validate-result": "item 6 "
            "(validate/)", "--checkpoint-": "item 6 (utils/checkpoint.py)",
            "--resume": "item 6 (utils/checkpoint.py)",
            "--partitions": "item 9 (parallel/)",
            "--partition-2d": "item 9 (parallel/)",
            "--shard-levels": "item 9 (parallel/)",
            "--flux-cripple": "item 4 (the crippled flux twin)",
            "--flux-precompute-edge-weights": "item 4 (segment-path |w|)",
            "--flux-fission": "item 4 (the fission formulation)",
            "--plan-cache": "item 4 (prep/window.py cached_plan)"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mgcfd-torch",
        description="Multigrid Euler solver (PyTorch + CUDA port of "
                    "mgcfd_tpu)")
    p.add_argument("-i", "--input-file", default=None,
                   help="multigrid input grid (input.dat descriptor)")
    p.add_argument("-d", "--input-directory", default=None)
    p.add_argument("-m", "--mesh-duplicate-count", type=int, default=None)
    p.add_argument("--synthetic", default=None, metavar="NX,NY,NZ,L",
                   help="run on a generated box hierarchy instead of -i")
    p.add_argument("--renumber", action="store_true",
                   help="RCM-renumber the mesh hierarchy before solving "
                        "(prep/renumber.py): imported meshes arrive in "
                        "arbitrary order and the kernels' gathers depend "
                        "on locality")
    p.add_argument("-g", "--num-cycles", type=int, default=None)
    p.add_argument("--dtype", default=None, choices=DTYPES)
    p.add_argument("--accumulate", default=None, choices=ACCUMULATE_MODES,
                   help="'auto' (default): on CUDA the span kernels "
                        "('pallas') on box-class meshes, else the CSR "
                        "kernels ('window'); the plain edge-stream path "
                        "('segment') on the CPU")
    p.add_argument("--transposed", action="store_true",
                   help="variable-major (5, N) state for "
                        "--accumulate shift")
    p.add_argument("--no-indirect-rw", action="store_true",
                   help="skip the indirect_rw data-movement twin")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--monitor", default=None, choices=MONITOR_MODES,
                   help="'instrumented': time each solver function and "
                        "write the reference's reports (monitor/)")
    p.add_argument("-o", "--output-file-prefix", default=None,
                   help="prefix of the reports (a directory if it ends "
                        "in '/')")
    p.add_argument("-p", "--papi-config-file", default=None,
                   help="event selection of KernelCosts.csv, one name a "
                        "line: CALLS, MODEL_BYTES, MODEL_OPERATIONS, "
                        "MEASURED_DEVICE_TIME_US, MEASURED_OCCURRENCES")
    p.add_argument("--measure-ops", action="store_true",
                   help="profile one more cycle after the run and charge "
                        "its device time to each solver function and "
                        "level (torch.profiler; the state is restored)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write the profiler trace of one more cycle "
                        "(Chrome trace JSON) into DIR")
    p.add_argument("--dump-hlo", default=None, metavar="DIR",
                   help="refused: the port compiles no XLA program, so "
                        "there is no HLO to dump")
    return p


def _refusal(flags: list) -> str:
    """Why the first unknown flag is refused: its ROADMAP item."""
    flag = next((f for f in flags if f.startswith("-")), "").split("=")[0]
    item = next((it for name, it in _REFUSED.items() if flag == name
                 or (name.endswith("-") and flag.startswith(name))),
                "item 8 (the full CLI)")
    return f"not ported yet: {' '.join(flags)} (ROADMAP.md queue 1, {item})"


def main(argv=None) -> int:
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if rest:
        parser.error(_refusal(rest))
    if args.dump_hlo is not None:
        parser.error("--dump-hlo has no counterpart in the port: it "
                     "compiles no XLA program, so there is no HLO to dump "
                     "(its kernels are CUDA C++ sources under csrc/)")
    cfg = SolverConfig()
    if args.input_file is not None:
        cfg.input_file = args.input_file
    if args.input_directory is not None:
        cfg.input_file_directory = args.input_directory
    if args.mesh_duplicate_count is not None:
        cfg.mesh_duplicate_count = args.mesh_duplicate_count
    if args.num_cycles is not None:
        cfg.num_cycles = args.num_cycles
    if args.dtype:
        cfg.dtype = args.dtype
    if args.accumulate:
        cfg.accumulate = args.accumulate
    cfg.transposed |= args.transposed
    if args.no_indirect_rw:
        cfg.include_indirect_rw = False
    if args.monitor:
        cfg.monitor_mode = args.monitor
    if args.output_file_prefix is not None:
        cfg.output_file_prefix = args.output_file_prefix
    if args.papi_config_file is not None:
        cfg.event_config_file = args.papi_config_file

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
    if instrumented:
        from ..monitor import InstrumentedSolver as Solver
    else:
        from ..solver import MGCFDSolver as Solver
    solver = Solver(mesh, cfg, device=args.platform)
    print(f"mesh {mesh.name}: {mesh.levels[0].num_nodes} nodes, "
          f"{mesh.num_levels} levels; dtype={cfg.dtype} "
          f"accumulate={cfg.accumulate} device={solver.device} "
          f"monitor={cfg.monitor_mode}", flush=True)
    t0 = time.perf_counter()
    solver.run(cfg.num_cycles, verbose=True)
    print(f"{cfg.num_cycles} cycles in {time.perf_counter() - t0:.3f} s "
          "(host clock, set-up excluded)")
    _monitor_reports(args, cfg, mesh, solver, instrumented)
    return 0


def _monitor_reports(args, cfg, mesh, solver, instrumented: bool) -> None:
    """--profile-dir, --measure-ops and the instrumented reports, after
    the run (mgcfd_tpu/cli/main.py:282-362, :460-462)."""
    from ..monitor import opstats
    if args.profile_dir:
        path = opstats.export_trace(solver, args.profile_dir)
        print(f"Profiler trace written to: {path}")
    if args.measure_ops and instrumented:
        m = opstats.measure_instrumented(solver)
        print(f"Measured time captured for {len(m.functions)} functions "
              f"on {m.device} (MEASURED_* rows of KernelCosts.csv)")
    elif args.measure_ops:
        from ..monitor.csvout import CsvIdentification, write_costs_csv
        m = opstats.measure_production(solver)
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
    if instrumented:
        paths = solver.write_reports(cfg.output_file_prefix)
        print(f"Loop runtimes written to: {paths[0]}")
        print(f"Loop stats written to: {paths[1]}")
        print(f"Kernel costs written to: {paths[2]}")


if __name__ == "__main__":
    sys.exit(main())
