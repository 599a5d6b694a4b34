"""Command-line entry point, a subset of mgcfd_tpu's flags:

    python -m mgcfd_tpu_torch.cli.main -i input.dat [-d DIR] [-m M]
        [--renumber] -g 10
    python -m mgcfd_tpu_torch.cli.main --synthetic 68,64,70,4 -g 10

-i/--input-file (the reference's input.dat), -d/--input-directory,
-m/--mesh-duplicate-count, --renumber (RCM, prep/renumber.py) or
--synthetic NX,NY,NZ,L (the flagship box family); -g, --dtype,
--accumulate, --transposed, --no-indirect-rw and --platform (cuda, the
default, or cpu). The mesh is loaded, then duplicated, then renumbered, in
the order of mgcfd_tpu's CLI. Any other flag of the JAX CLI is refused as
not ported yet.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from ..core.config import ACCUMULATE_MODES, DTYPES, SolverConfig


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
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if rest:
        parser.error(f"not ported yet: {' '.join(rest)} (ROADMAP.md "
                     "queue 1, item 8 brings the full CLI)")
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

    from ..solver import MGCFDSolver
    solver = MGCFDSolver(mesh, cfg, device=args.platform)
    print(f"mesh {mesh.name}: {mesh.levels[0].num_nodes} nodes, "
          f"{mesh.num_levels} levels; dtype={cfg.dtype} "
          f"accumulate={cfg.accumulate} device={solver.device}", flush=True)
    t0 = time.perf_counter()
    solver.run(cfg.num_cycles, verbose=True)
    print(f"{cfg.num_cycles} cycles in {time.perf_counter() - t0:.3f} s "
          "(host clock, set-up excluded)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
