"""Does torch.profiler see every hand-kernel launch of a profile? The two
profiles that chip_smoke.py takes of each timed cell (one run_batched
replay of K = 10 cycles, 10 cycles of run), repeated on the box flagship
for each wait at the profile's start, with the wait after the work fixed
at opstats.SETTLE_S.

    python -m mgcfd_tpu_torch.bench.profile_window [--reps 40]
        [--settle 0 0.25]

Each profile counts the device records of the hand kernels (mgcfd::...)
against the launches the wrappers counted in it. A profile that sees
fewer is printed with where its records went missing: for run, the
positions among the profile's launch calls of those whose kernel left no
record; for both, the time of the first device record after the first
host event (a negative time lies before the profile's window opened).
The last lines tally the short profiles for each cell, span and wait.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import sys
import time

from ..monitor.opstats import SETTLE_S

CELLS = (("float32", "pallas"), ("bfloat16", "pallas"),
         ("float32", "window"))
K = 10
_LAUNCH_RE = re.compile(r"^cu(da)?LaunchKernel")


def profiled(fn, settle: float) -> dict:
    """fn() under torch.profiler as bench/profile_cycle.profile_cycles
    runs it, with `settle` seconds of wait before it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import kernels
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(settle)
        fn()
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
    counted = sum(kernels.launch_counts().values())
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    host = [e for e in events if e.device_type == cpu]
    dev = [e for e in events if e.device_type != cpu]
    t0 = min(e.time_range.start for e in host)
    calls = sorted((e for e in host if _LAUNCH_RE.match(e.name)),
                   key=lambda e: e.time_range.start)
    ids = {e.id for e in dev}
    return {"seen": sum("mgcfd::" in e.name for e in dev),
            "counted": counted,
            "lost_at": [i for i, e in enumerate(calls) if e.id not in ids],
            "first_device_ms": min((e.time_range.start for e in dev),
                                   default=t0) / 1e3 - t0 / 1e3}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=40)
    p.add_argument("--settle", type=float, nargs="+",
                   default=[0.0, SETTLE_S])
    args = p.parse_args(argv)

    import torch

    from ..core.config import SolverConfig
    from ..solver import MGCFDSolver
    from .flagship import flagship_mesh

    mesh = flagship_mesh()
    print(f"{torch.cuda.get_device_name(0)}; box flagship; {args.reps} "
          f"tries of each span at each start wait {args.settle} s, "
          f"{SETTLE_S} s after", flush=True)
    tally = {}
    for dtype, acc in CELLS:
        s = MGCFDSolver(mesh, SolverConfig(dtype=dtype, accumulate=acc))
        s.run(2)
        s.run_batched(K, K)
        spans = (("replay", lambda: s.run_batched(K, K)),
                 ("run", lambda: s.run(K)))
        for rep in range(args.reps):
            for settle in args.settle:     # interleaved, rep by rep
                for span, fn in spans:
                    r = profiled(fn, settle)
                    key = f"{dtype} {acc} {span}, start wait {settle} s"
                    t = tally.setdefault(key, [0, 0, 0])
                    short = r["counted"] - r["seen"]
                    t[0] += 1
                    t[1] += short != 0
                    t[2] += short
                    if short:
                        print(f"short: {key}, try {rep}: saw {r['seen']} "
                              f"of {r['counted']} launches; lost at launch "
                              f"calls {r['lost_at'][:8]}"
                              f"{'...' if len(r['lost_at']) > 8 else ''}"
                              f" ({len(r['lost_at'])}); first device "
                              f"record at {r['first_device_ms']:.3f} ms",
                              flush=True)
        del s
    for key, (n, short, lost) in tally.items():
        print(f"tally: {key}: {short} of {n} profiles short, {lost} "
              f"launch records lost", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
