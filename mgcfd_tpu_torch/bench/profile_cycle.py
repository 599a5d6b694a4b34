"""Where one V-cycle's time goes on the card: torch.profiler over a few
cycles of MGCFDSolver.run, then over one replay of run_batched's CUDA
graph of K = 10 cycles (run_batched's default), on the box flagship.

    python -m mgcfd_tpu_torch.bench.profile_cycle
        [--dtype float32|float64|bfloat16] [--accumulate auto] [--cycles 5]

--accumulate auto (the default) profiles the path a user's run takes on
the box ('pallas'); --accumulate window profiles the CSR kernels there.

For each of the two it prints the wall time per cycle (host clock around
cycles that end in a synchronize), the device-busy time per cycle (the
sum of the CUDA kernels' device time: one stream, so kernels do not
overlap), the device's idle share, every kernel's device time, and the
host operations that take the most time.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time

from ..core.config import ACCUMULATE_MODES, DTYPES
from ..monitor.opstats import SETTLE_S

# the cycles of one run_batched replay
K = 10
# one-cycle spin kernels (torch.cuda._sleep) that each profile runs before
# its wait and its work, and that its results leave out: a profile in a
# process that has run and profiled for minutes can lose the records of
# its first few kernels (six on the H100, whatever the wait), which then
# are these
PRELUDE_KERNELS = 16


def profile_cycles(fn, cycles: int):
    """Run fn() (which runs `cycles` cycles) under torch.profiler. Returns
    (wall ms per cycle, device busy ms per cycle, the CUDA kernels' event
    averages, every event average)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PRELUDE_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / cycles * 1e3
        time.sleep(SETTLE_S)
    events = prof.key_averages()
    # the device records, not the device-side copies of the host's
    # ranges (run_batched's spans under a profile), nor the prelude's
    kernels = [e for e in events if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "spin_kernel" not in e.key]
    busy = sum(e.self_device_time_total for e in kernels) / cycles / 1e3
    return wall, busy, kernels, events


def report(what: str, cycles: int, measured) -> None:
    wall, busy, kernels, events = measured
    print(f"{what}: wall {wall:.3f} ms/cycle; device busy {busy:.3f} "
          f"ms/cycle; device idle share {1 - busy / wall:.3f}")
    print("device time by kernel, every kernel (us per cycle, launches "
          "per cycle):")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True):
        print(f"  {e.self_device_time_total / cycles:10.1f}  "
              f"{e.count / cycles:6.1f}  {e.key[:90]}")
    print("host time by operation (self CPU us per cycle, calls per "
          "cycle):")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:12]:
        print(f"  {e.self_cpu_time_total / cycles:10.1f}  "
              f"{e.count / cycles:6.1f}  {e.key[:90]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="float32", choices=DTYPES)
    p.add_argument("--accumulate", default="auto",
                   choices=ACCUMULATE_MODES)
    p.add_argument("--cycles", type=int, default=5)
    args = p.parse_args(argv)

    import torch

    from ..core.config import SolverConfig
    from ..solver import MGCFDSolver
    from .flagship import flagship_mesh

    solver = MGCFDSolver(flagship_mesh(), SolverConfig(
        dtype=args.dtype, accumulate=args.accumulate))
    solver.run(2)
    solver.run_batched(K, K)     # captures the graph of K cycles
    print(f"{torch.cuda.get_device_name(0)}; box flagship, "
          f"{args.dtype}, accumulate={solver.config.accumulate}")
    report(f"run, {args.cycles} cycles under the profiler", args.cycles,
           profile_cycles(lambda: solver.run(args.cycles), args.cycles))
    report(f"run_batched, one replay of {K} cycles under the profiler", K,
           profile_cycles(lambda: solver.run_batched(K, K), K))
    return 0


if __name__ == "__main__":
    sys.exit(main())
