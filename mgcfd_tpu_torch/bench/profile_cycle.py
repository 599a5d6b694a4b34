"""Where one V-cycle's time goes on the card: torch.profiler over a few
cycles of MGCFDSolver on the box flagship.

    python -m mgcfd_tpu_torch.bench.profile_cycle
        [--dtype float32|float64|bfloat16] [--accumulate auto] [--cycles 5]

--accumulate auto (the default) profiles the path a user's run takes on
the box ('pallas'); --accumulate window profiles the CSR kernels there.

Prints the wall time per cycle (host clock around cycles that end in a
synchronize), the device-busy time per cycle (the sum of the CUDA kernels'
device time: one stream, so kernels do not overlap), the device's idle
share, and the kernels and host operations that take the most time.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time

from ..core.config import ACCUMULATE_MODES, DTYPES


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="float32", choices=DTYPES)
    p.add_argument("--accumulate", default="auto",
                   choices=ACCUMULATE_MODES)
    p.add_argument("--cycles", type=int, default=5)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core.config import SolverConfig
    from ..solver import MGCFDSolver
    from .flagship import flagship_mesh

    solver = MGCFDSolver(flagship_mesh(), SolverConfig(
        dtype=args.dtype, accumulate=args.accumulate))
    solver.run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.run(args.cycles)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.cycles * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return e.self_device_time_total

    kernels = [e for e in events if dev_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / args.cycles / 1e3
    print(f"{torch.cuda.get_device_name(0)}; box flagship, "
          f"{args.dtype}, accumulate={solver.config.accumulate}, "
          f"{args.cycles} "
          f"cycles under the profiler")
    print(f"wall {wall:.3f} ms/cycle; device busy {busy:.3f} ms/cycle; "
          f"device idle share {1 - busy / wall:.3f}")
    print("device time by kernel (us per cycle, launches per cycle):")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"  {dev_us(e) / args.cycles:10.1f}  "
              f"{e.count / args.cycles:6.1f}  {e.key[:90]}")
    print("host time by operation (self CPU us per cycle, calls per "
          "cycle):")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:12]:
        print(f"  {e.self_cpu_time_total / args.cycles:10.1f}  "
              f"{e.count / args.cycles:6.1f}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
