"""Command-line entry point, a subset of mgcfd_tpu's flags:

    python -m mgcfd_tpu_torch.cli.main --synthetic 68,64,70,4 -g 10

--synthetic NX,NY,NZ,L (the flagship box family), -g, --dtype,
--accumulate, --transposed, --no-indirect-rw and --platform (cuda, the
default, or cpu). Any other flag of the JAX CLI is refused as not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time

from ..core.config import ACCUMULATE_MODES, DTYPES, SolverConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mgcfd-torch",
        description="Multigrid Euler solver (PyTorch + CUDA port of "
                    "mgcfd_tpu)")
    p.add_argument("--synthetic", required=True, metavar="NX,NY,NZ,L",
                   help="run on a generated box hierarchy")
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
    if args.num_cycles is not None:
        cfg.num_cycles = args.num_cycles
    if args.dtype:
        cfg.dtype = args.dtype
    if args.accumulate:
        cfg.accumulate = args.accumulate
    cfg.transposed |= args.transposed
    if args.no_indirect_rw:
        cfg.include_indirect_rw = False

    from ..bench.flagship import FlagshipSpec, flagship_mesh
    from ..solver import MGCFDSolver
    nx, ny, nz, L = (int(x) for x in args.synthetic.split(","))
    mesh = flagship_mesh(FlagshipSpec(nx=nx, ny=ny, nz=nz, num_levels=L))
    solver = MGCFDSolver(mesh, cfg, device=args.platform)
    print(f"mesh {mesh.name}: {mesh.levels[0].num_nodes} nodes, "
          f"{L} levels; dtype={cfg.dtype} accumulate={cfg.accumulate} "
          f"device={solver.device}", flush=True)
    t0 = time.perf_counter()
    solver.run(cfg.num_cycles, verbose=True)
    print(f"{cfg.num_cycles} cycles in {time.perf_counter() - t0:.3f} s "
          "(host clock, set-up excluded)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
