"""Capacity-scale acceptance criterion (mgcfd_tpu/validate/capacity.py).

An fp64 run at capacity scale is the oracle; the criterion holds the
fp32 production configuration to it after a few cycles:

  (a) every fp32 cycle's RMS is finite (the in-cycle NaN guard has
      already stopped the run if the state went invalid:
      validation.cpp:107-138 semantics);
  (b) max over finest-level variables of |fp32 - fp64| / (|fp64| +
      channel max |fp64|) <= tol after K cycles (default K=2, tol=5e-7);
  (c) per-cycle RMS agrees between the dtypes to `rms_digits`
      significant digits, where the RMS is physical (above 1e-5).

One command runs it:  python -m mgcfd_tpu_torch.validate.capacity
  --preset {smoke,flagship-box,flagship-tet,capacity-box,capacity-tet}
  [--cycles K] [--tol T] [--accumulate MODE] [--platform cpu]
printing a single JSON verdict line and exiting non-zero on failure. The
fp64 oracle runs accumulate='segment' (the plain edge-stream path); the
fp32 leg runs the configuration under test. Both legs run on the card
unless --platform cpu.

The two legs can also run in separate processes (--split leg-fp32,
leg-fp64) and be judged from their npz files (--split judge). The npz
keys (v rms cycles device edges) are mgcfd_tpu's, so either package's
judge reads either package's legs.
"""
from __future__ import annotations

import json
import math
import sys

import numpy as np

# (nx, ny, nz, levels, unstructured?) — mgcfd_tpu's presets
PRESETS = {
    "smoke": (10, 9, 9, 2, False),
    "flagship-box": (68, 64, 70, 4, False),
    "flagship-tet": (68, 64, 70, 4, True),
    "capacity-box": (136, 128, 140, 4, False),
    "capacity-tet": (104, 98, 107, 4, True),
}


def _build(preset: str):
    nx, ny, nz, L, tet = PRESETS[preset]
    if tet:
        from ..mesh.unstructured import generate_unstructured_hierarchy
        from ..prep.renumber import renumber_hierarchy
        return renumber_hierarchy(
            generate_unstructured_hierarchy(nx, ny, nz, L, seed=1))
    from ..mesh.generate import generate_multigrid_box
    return generate_multigrid_box(nx, ny, nz, L, h=(0.1, 0.1, 0.1),
                                  volume_jitter=0.2, seed=0)


def _device_label(platform: str) -> str:
    """The card's name, or "cpu"."""
    import torch
    device = torch.device(platform)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def run_leg(mesh, dtype: str, cycles: int = 2,
            accumulate: str | None = None, plan_cache_dir: str = "",
            device=None) -> tuple:
    """One dtype leg -> (variables0, rms_history). The fp64
    oracle runs accumulate='segment'; the fp32 leg the configuration
    under test (`accumulate`, default the solver's auto choice). `device`
    as MGCFDSolver takes it: None is the card."""
    from ..core.config import SolverConfig
    from ..solver import MGCFDSolver

    if dtype == "float64":
        kw = dict(accumulate="segment")
    else:
        kw = dict(plan_cache_dir=plan_cache_dir)
        if accumulate:
            kw["accumulate"] = accumulate
    s = MGCFDSolver(mesh, SolverConfig(dtype=dtype,
                                       include_indirect_rw=False, **kw),
                    device=device)
    s.run(cycles)
    return s.variables(0), list(s.rms_history)


def judge(v32, rms32, v64, rms64, cycles: int, tol: float = 5e-7,
          rms_digits: int = 3, num_internal_edges: int = 0) -> dict:
    """Apply the (a)/(b)/(c) clauses to the two legs' results
    (mgcfd_tpu's judge, key for key)."""
    rms32 = [float(r) for r in rms32]   # npz legs arrive as np scalars
    rms64 = [float(r) for r in rms64]
    finite = all(math.isfinite(r) for r in rms32)
    # |a-b| <= tol * (|b| + max_channel|b|): the per-channel scale floor
    # covers channels at 0 (v and w momentum at the far field)
    scale = np.abs(v64).max(axis=0, keepdims=True)
    rel = np.abs(v32.astype(np.float64) - v64) / (np.abs(v64) + scale)
    max_rel = float(rel.max())

    def sig_round(x, d):
        if x == 0 or not math.isfinite(x):
            return x
        return round(x, -int(math.floor(math.log10(abs(x)))) + d - 1)

    # clause (c) applies only where the RMS is physical: at roundoff
    # equilibrium the per-cycle RMS is itself dtype noise
    rms_physical = max(rms64) > 1e-5
    rms_agree = (not rms_physical) or all(
        sig_round(a, rms_digits) == sig_round(b, rms_digits)
        for a, b in zip(rms32, rms64))

    return {
        "rms_physical": rms_physical,
        "criterion": "capacity_acceptance",
        "cycles": cycles,
        "tol": tol,
        "rms_finite_fp32": finite,
        "max_rel_fp32_vs_fp64": max_rel,
        "rms_fp32": rms32,
        "rms_fp64": rms64,
        "rms_agree_digits": rms_digits,
        "rms_agree": rms_agree,
        "num_internal_edges": int(num_internal_edges),
        "accepted": bool(finite and max_rel <= tol and rms_agree),
    }


def acceptance(mesh, cycles: int = 2, tol: float = 5e-7,
               rms_digits: int = 3, accumulate: str | None = None,
               plan_cache_dir: str = "", device=None) -> dict:
    """Both legs in one process; returns the verdict dict (key
    "accepted")."""
    v32, rms32 = run_leg(mesh, "float32", cycles, accumulate,
                         plan_cache_dir, device)
    v64, rms64 = run_leg(mesh, "float64", cycles, device=device)
    return judge(v32, rms32, v64, rms64, cycles, tol, rms_digits,
                 mesh.levels[0].num_internal_edges)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="flagship-box",
                   choices=sorted(PRESETS))
    p.add_argument("--cycles", type=int, default=2)
    p.add_argument("--tol", type=float, default=5e-7)
    p.add_argument("--accumulate", default=None,
                   help="fp32 mode under test (default: the solver's auto "
                        "choice)")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="where the legs run (default: the card)")
    p.add_argument("--plan-cache", default="")
    p.add_argument("--split", default=None,
                   choices=["leg-fp32", "leg-fp64", "judge"],
                   help="run one dtype leg and save it (--out), or judge "
                        "two saved legs (--fp32/--fp64)")
    p.add_argument("--out", default=None, help="npz path for a leg")
    p.add_argument("--fp32", default=None, help="saved fp32 leg (judge)")
    p.add_argument("--fp64", default=None, help="saved fp64 leg (judge)")
    args = p.parse_args(argv)

    if args.split == "judge":
        a = np.load(args.fp32)
        b = np.load(args.fp64)
        assert int(a["cycles"]) == int(b["cycles"]), "leg cycle mismatch"
        verdict = judge(a["v"], list(a["rms"]), b["v"], list(b["rms"]),
                        int(a["cycles"]), tol=args.tol,
                        num_internal_edges=int(a["edges"]))
        verdict["preset"] = args.preset
        verdict["fp32_device"] = str(a["device"])
        verdict["fp64_device"] = str(b["device"])
        print(json.dumps(verdict))
        return 0 if verdict["accepted"] else 1

    mesh = _build(args.preset)
    if args.split in ("leg-fp32", "leg-fp64"):
        dtype = "float32" if args.split == "leg-fp32" else "float64"
        v, rms = run_leg(mesh, dtype, cycles=args.cycles,
                         accumulate=args.accumulate,
                         plan_cache_dir=args.plan_cache,
                         device=args.platform)
        where = _device_label(args.platform)
        np.savez_compressed(
            args.out, v=np.asarray(v), rms=np.asarray(rms),
            cycles=args.cycles, device=where,
            edges=mesh.levels[0].num_internal_edges)
        print(json.dumps({"leg": args.split, "preset": args.preset,
                          "out": args.out, "device": where}))
        return 0

    verdict = acceptance(mesh, cycles=args.cycles, tol=args.tol,
                         accumulate=args.accumulate,
                         plan_cache_dir=args.plan_cache,
                         device=args.platform)
    verdict["preset"] = args.preset
    print(json.dumps(verdict))
    return 0 if verdict["accepted"] else 1


if __name__ == "__main__":
    sys.exit(main())
