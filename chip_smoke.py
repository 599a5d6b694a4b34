#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (mgcfd_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

What it does, in order, printing each step with the elapsed seconds:
  1. arms a watchdog that dumps every thread's traceback and exits
     non-zero after 8 minutes (the run takes under one);
  2. prints the card (torch and nvidia-smi);
  3. builds the CUDA kernels with one nvcc call;
  4. holds every kernel (edge_csr in flux, rw and wsum modes, fused_stage)
     against its plain PyTorch version on the card, at the box flagship's
     level-0 shapes, in fp64 and fp32;
  5. drives the main path, MGCFDSolver(...).run() on the box flagship
     (304,640 nodes, 4 levels): fp64 through the kernels against fp64
     through the plain path, then fp32 through the kernels with the
     launch counts read around the run;
  6. runs the same box undamped (the FVCORR variant) from a perturbed
     state, where every node moves by O(0.1) per cycle: fp64 kernels
     against fp64 plain, and the fp32 kernel RMS against the fp64 RMS;
  7. runs a 32^3, 3-level tet hierarchy through both paths at fp64;
  8. times the V-cycle and each kernel beside its byte bound, its plain
     version and a library call where one computes the same function;
  9. prints the card's name and power limit, one JSON line of kernel
     records, and last the JSON line {"ok": true, "device": {...}}.
Any failed check raises, and the exit code is then non-zero. Without a
CUDA device, or without the package beside this file, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import json
import math
import subprocess
import sys
import time
from pathlib import Path

WATCHDOG_S = 480
T0 = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# the Pallas kernels the CUDA kernels replace
_WINDOW = "mgcfd_tpu/pallas/flux_window.py"
REPLACES = {"edge_csr": f"{_WINDOW}:222", "fused_stage": f"{_WINDOW}:359"}
SOURCES = {"edge_csr": "mgcfd_tpu_torch/csrc/edge_csr.cu",
           "fused_stage": "mgcfd_tpu_torch/csrc/fused_stage.cu"}

# operations per CSR entry and per row, counted from the kernel source
# (each add, multiply, divide and square root is one operation)
FLUX_OPS_PER_ENTRY = 80   # neighbour completion (~17) + flux_math (~63)
FLUX_OPS_PER_ROW = 17     # owner completion
FUSED_EXTRA_OPS_PER_ROW = 60  # boundary/wall flux, update, validity
RW_OPS_PER_ENTRY = 25
WSUM_OPS_PER_ENTRY = 10

# Tolerances of the kernel-against-plain checks, relative to each
# channel's largest magnitude. fp64: both sides round each operation to
# double and sum each row in the same order, but the kernel may contract
# a multiply and an add into one FMA and the plain version's index_add_
# adds in another order on the card; a row of ~6 entries of ~80
# operations stays below 1e-13. fp32: the same argument at fp32's 6e-8
# rounding gives ~1e-6; 1e-5 leaves a margin of ten.
TOL_FP64 = 1e-12
TOL_FP32 = 1e-5
# fp32 against fp64 after two cycles on the flagship: the repo's capacity
# criterion (mgcfd_tpu/validate/capacity.py:88-130), |a-b| <= tol (|b| +
# channel max|b|) with tol 5e-7. Its M6-wing edge weights are damped by
# 5e-8, so a cycle moves the state by ~1e-7, below fp32's resolution of
# the O(1) state: the fp32 RMS there is rounding and is not compared.
CAPACITY_TOL = 5e-7
# the fp32 RMS against the fp64 RMS where the state moves (the undamped
# box): 3 significant digits, read as a relative difference of 1e-3 so
# that the check does not hinge on where a rounding boundary falls
RMS_DIGITS_TOL = 1e-3
# relative noise on the far-field state that the undamped box starts from
PERTURBATION = 0.01


def log(msg: str) -> None:
    print(f"{time.perf_counter() - T0:8.1f}s  {msg}", flush=True)


class CheckFailed(AssertionError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def rel_err(got, want) -> float:
    """Max over channels of max|got - want| / max|want|; (5, N) tensors."""
    g, w = got.double(), want.double()
    scale = w.abs().amax(dim=1).clamp_min(1e-300)
    return float(((g - w).abs().amax(dim=1) / scale).max())


def sig(x: float, digits: int = 3) -> float:
    if x == 0 or not math.isfinite(x):
        return x
    return round(x, -int(math.floor(math.log10(abs(x)))) + digits - 1)


def capacity_rel(v32, v64) -> float:
    import numpy as np
    scale = np.abs(v64).max(axis=0, keepdims=True)
    return float((np.abs(v32 - v64) / (np.abs(v64) + scale)).max())


def card() -> tuple[str, str]:
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return name, smi.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call: CUDA events around `reps` calls queued while
    the card sleeps, so host launch gaps do not enter the span."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)   # ~50 ms of card time to queue into
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_state(n: int, seed: int, dtype, device):
    """Far-field gas plus seeded noise of 0.05 per channel, (5, n)."""
    import numpy as np
    import torch
    from mgcfd_tpu_torch.core.constants import far_field_state
    rng = np.random.default_rng(seed)
    q = far_field_state()[0][:, None] + 0.05 * rng.standard_normal((5, n))
    return torch.as_tensor(q).to(device=device, dtype=dtype)


def check_kernels(s64, s32) -> None:
    """Each kernel against its plain version at level-0 shapes."""
    import torch
    from mgcfd_tpu_torch.kernels import edge_csr
    from mgcfd_tpu_torch.kernels.fused_stage import (fused_stage,
                                                     fused_stage_plain)
    from mgcfd_tpu_torch.solver.solver import t_step_factor
    plain = edge_csr.edge_csr_plain
    for solver, tol in ((s64, TOL_FP64), (s32, TOL_FP32)):
        dt = solver.dtype
        L0, L1 = solver.dmesh.levels[0], solver.dmesh.levels[1]
        n0, n1 = L0.num_nodes, L1.num_nodes
        dev = L0.volumes.device
        q = random_state(n0, 1, dt, dev)
        old = q + 1e-3 * random_state(n0, 2, dt, dev)
        fac = t_step_factor(L0, q, False) / 3.0
        xf = random_state(n0, 3, dt, dev)
        rc = random_state(n1, 4, dt, dev) - random_state(n1, 5, dt, dev)
        cases = [
            ("edge_csr.flux", edge_csr.flux(L0.csr, q),
             plain("flux", L0.csr, q)),
            ("edge_csr.rw", edge_csr.rw(L0.csr, q), plain("rw", L0.csr, q)),
            ("edge_csr.wsum.restrict", edge_csr.restrict(L0.restrict_csr,
                                                         xf),
             plain("wsum", L0.restrict_csr, xf)),
            ("edge_csr.wsum.prolong", edge_csr.prolong(L0.prolong_csr, rc),
             plain("wsum", L0.prolong_csr, rc)),
        ]
        k_out, k_inv = fused_stage(L0.csr, L0.nc, q, old, fac)
        p_out, p_inv = fused_stage_plain(L0.csr, L0.nc, q, old, fac)
        cases.append(("fused_stage", k_out, p_out))
        torch.cuda.synchronize()
        for name, got, want in cases:
            err = rel_err(got, want)
            log(f"check {name:24s} {str(dt):14s} max rel err {err:.3e} "
                f"(tol {tol:.0e})")
            require(err <= tol, f"{name} {dt}: {err:.3e} > {tol:.0e}")
        require(int(k_inv) == int(p_inv) == 0,
                f"fused_stage invalid counts {int(k_inv)} / {int(p_inv)}")
        bad_q = q.clone()
        bad_q[0, n0 // 2] = float("nan")
        bad_q[4, n0 // 3] = -1.0
        k_inv = int(fused_stage(L0.csr, L0.nc, bad_q, old, fac)[1])
        p_inv = int(fused_stage_plain(L0.csr, L0.nc, bad_q, old, fac)[1])
        log(f"check fused_stage invalid count with a planted NaN and "
            f"E<0: kernel {k_inv}, plain {p_inv}")
        require(k_inv == p_inv > 0, "fused_stage invalid counts differ")


def per_cycle(counts: dict, cycles: int) -> dict:
    return {k: v / cycles for k, v in counts.items()}


def perturbed_state(mesh, seed: int):
    """Node-major start state: the far field times (1 + PERTURBATION x
    standard normal noise) on every level, zero residuals."""
    import numpy as np
    from mgcfd_tpu_torch.convert import state_from_arrays
    from mgcfd_tpu_torch.core.constants import far_field_state
    rng = np.random.default_rng(seed)
    ff = far_field_state()[0]
    return state_from_arrays(
        [ff * (1.0 + PERTURBATION * rng.standard_normal((lv.num_nodes, 5)))
         for lv in mesh.levels],
        [np.zeros((lv.num_nodes, 5)) for lv in mesh.levels])


def same_as_plain(kern, plain, mesh, what: str) -> None:
    """Kernel-path and plain-path solvers after the same cycles: every
    level's variables and the per-cycle RMS within identify_differences
    (relative 1e-8). The RMS is the size of the update itself, so it
    holds the update to 1e-8 even where the update is small beside the
    state."""
    import numpy as np
    from mgcfd_tpu_torch.validate import identify_differences
    for lev in range(mesh.num_levels):
        nbad = identify_differences(kern.variables(lev),
                                    plain.variables(lev), mesh.variant,
                                    raise_on_fail=False)
        require(nbad == 0, f"{what} level {lev}: {nbad} values differ")
    require(identify_differences(np.array(kern.rms_history),
                                 np.array(plain.rms_history), mesh.variant,
                                 raise_on_fail=False) == 0,
            f"{what}: RMS differs from the plain path")
    log(f"{what}: kernels == plain path within identify_differences on "
        f"all levels; RMS {kern.rms_history} plain {plain.rms_history}")


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if not (here / "mgcfd_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: mgcfd_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    from mgcfd_tpu_torch import kernels
    from mgcfd_tpu_torch.bench import FLAGSHIP_SPEC, flagship_mesh
    from mgcfd_tpu_torch.core.config import SolverConfig
    from mgcfd_tpu_torch.core.constants import MeshVariant
    from mgcfd_tpu_torch.kernels import build, edge_csr
    from mgcfd_tpu_torch.kernels.fused_stage import (fused_stage,
                                                     fused_stage_plain)
    from mgcfd_tpu_torch.mesh import generate_unstructured_hierarchy
    from mgcfd_tpu_torch.solver import MGCFDSolver

    # no matrix product or convolution runs in fp32 on the paths timed
    # here; keep any that might at full fp32 all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, smi = card()
    log(f"device: {name} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    path, secs = build.build()
    log(f"built {path.name} with one nvcc call in {secs:.1f} s")
    build.library()

    def solver(mesh, dtype, accumulate):
        return MGCFDSolver(mesh, SolverConfig(dtype=dtype,
                                              accumulate=accumulate))

    mesh = flagship_mesh()
    lv0 = mesh.levels[0]
    log(f"box flagship: {lv0.num_nodes} nodes, {lv0.num_internal_edges} "
        f"internal edges, {mesh.num_levels} levels")
    k64 = solver(mesh, "float64", "window")
    k32 = solver(mesh, "float32", "window")
    log("kernel-path solvers ready (fp64, fp32)")

    check_kernels(k64, k32)

    # --- main path, fp64: kernels against the plain path ---
    p64 = solver(mesh, "float64", "segment")
    k64.run(2)
    p64.run(2)
    same_as_plain(k64, p64, mesh, "box fp64, 2 cycles")

    # --- main path, fp32 through the kernels, launches counted ---
    kernels.reset_launch_counts()
    k32.run(2)
    v2 = k32.variables(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    k32.run(10)
    end.record()
    torch.cuda.synchronize()
    cycle_ms = start.elapsed_time(end) / 10
    counts = kernels.launch_counts()
    main_cycles = k32.completed_cycles
    launches_per_cycle = per_cycle(counts, main_cycles)
    log(f"box fp32, {main_cycles} cycles through the kernels; launches "
        f"{counts}; per cycle {launches_per_cycle}")
    want = {"edge_csr.flux": 0, "edge_csr.rw": 18,
            "edge_csr.wsum.restrict": 3, "edge_csr.wsum.prolong": 3,
            "fused_stage": 18}
    require(launches_per_cycle == want,
            f"launch counts per cycle {launches_per_cycle} != {want}")
    rms32 = k32.rms_history
    require(all(math.isfinite(r) for r in rms32), f"fp32 RMS {rms32}")
    cap = capacity_rel(v2, k64.variables(0))
    log(f"box fp32 vs fp64 after 2 cycles: capacity max rel {cap:.3e} "
        f"(tol {CAPACITY_TOL:.0e}); fp32 RMS {rms32}")
    require(cap <= CAPACITY_TOL, f"fp32 vs fp64 {cap:.3e}")

    # --- the same box undamped, from a perturbed state ---
    umesh = flagship_mesh(dataclasses.replace(FLAGSHIP_SPEC,
                                              variant=MeshVariant.FVCORR))
    ustart = perturbed_state(umesh, seed=11)
    u64, up64, u32 = (solver(umesh, "float64", "window"),
                      solver(umesh, "float64", "segment"),
                      solver(umesh, "float32", "window"))
    for u in (u64, up64, u32):
        u.load_state(ustart)
        u.run(2)
    moved = float(abs(u64.variables(0) - ustart["variables"][0]).max())
    log(f"undamped box (FVCORR) from the far field with {PERTURBATION} "
        f"relative noise, 2 cycles: max change of a variable {moved:.3e}")
    require(moved > 1e-2, "the undamped box did not move")
    same_as_plain(u64, up64, umesh, "undamped box fp64, 2 cycles")
    rms_rel = [abs(a - b) / abs(b)
               for a, b in zip(u32.rms_history, u64.rms_history)]
    log(f"undamped box fp32 kernel RMS {u32.rms_history} vs fp64 "
        f"{u64.rms_history}: relative differences {rms_rel}")
    require(all(math.isfinite(r) for r in u32.rms_history)
            and max(rms_rel) <= RMS_DIGITS_TOL,
            "fp32 RMS does not agree with fp64 to 3 digits")

    # --- tet hierarchy, fp64: kernels against the plain path ---
    tmesh = generate_unstructured_hierarchy(32, 32, 32, 3, seed=0)
    log(f"tet {tmesh.levels[0].num_nodes} nodes, "
        f"{tmesh.levels[0].num_internal_edges} edges, 3 levels")
    kt = solver(tmesh, "float64", "window")
    pt = solver(tmesh, "float64", "segment")
    kt.run(2)
    pt.run(2)
    same_as_plain(kt, pt, tmesh, "tet fp64, 2 cycles")

    # --- times at the main path's fp32 level-0 shapes ---
    L0, L1 = k32.dmesh.levels[0], k32.dmesh.levels[1]
    q = k32.state["variables"][0]
    old = q + 1e-6 * q
    fac = torch.full_like(L0.volumes, 1e-3)
    res1 = k32.state["residuals"][1]
    sz = q.element_size()
    n0, n1 = L0.num_nodes, L1.num_nodes

    def csr_bytes(csr, wrows):
        return 4 * (csr.num_rows + 1) + 4 * csr.num_entries \
            + sz * wrows * csr.num_entries

    def sparse(csr):
        return torch.sparse_csr_tensor(
            csr.row_ptr, csr.col, csr.w[0].contiguous(),
            (csr.num_rows, csr.num_cols), check_invariants=True)

    xf_t = q.T.contiguous()
    rc_t = res1.T.contiguous()
    sp_r, sp_p = sparse(L0.restrict_csr), sparse(L0.prolong_csr)
    plain = edge_csr.edge_csr_plain
    rows = [
        # name, kernel family, kernel fn, plain fn, library fn, bytes,
        # operations
        ("fused_stage", "fused_stage",
         lambda: fused_stage(L0.csr, L0.nc, q, old, fac)[0],
         lambda: fused_stage_plain(L0.csr, L0.nc, q, old, fac)[0], None,
         csr_bytes(L0.csr, 4) + sz * n0 * (5 + 5 + 1 + 11 + 5) + 4,
         FLUX_OPS_PER_ENTRY * L0.csr.num_entries
         + (FLUX_OPS_PER_ROW + FUSED_EXTRA_OPS_PER_ROW) * n0),
        ("edge_csr.flux", "edge_csr",
         lambda: edge_csr.flux(L0.csr, q), lambda: plain("flux", L0.csr, q),
         None, csr_bytes(L0.csr, 4) + sz * n0 * 10,
         FLUX_OPS_PER_ENTRY * L0.csr.num_entries + FLUX_OPS_PER_ROW * n0),
        ("edge_csr.rw", "edge_csr",
         lambda: edge_csr.rw(L0.csr, q), lambda: plain("rw", L0.csr, q),
         None, csr_bytes(L0.csr, 3) + sz * n0 * 10,
         RW_OPS_PER_ENTRY * L0.csr.num_entries),
        ("edge_csr.wsum.restrict", "edge_csr",
         lambda: edge_csr.restrict(L0.restrict_csr, q),
         lambda: plain("wsum", L0.restrict_csr, q),
         lambda: torch.sparse.mm(sp_r, xf_t),
         csr_bytes(L0.restrict_csr, 1) + sz * 5 * (n0 + n1),
         WSUM_OPS_PER_ENTRY * L0.restrict_csr.num_entries),
        ("edge_csr.wsum.prolong", "edge_csr",
         lambda: edge_csr.prolong(L0.prolong_csr, res1),
         lambda: plain("wsum", L0.prolong_csr, res1),
         lambda: torch.sparse.mm(sp_p, rc_t),
         csr_bytes(L0.prolong_csr, 1) + sz * 5 * (n1 + n0),
         WSUM_OPS_PER_ENTRY * L0.prolong_csr.num_entries),
    ]
    records = []
    for (rname, family, kfn, pfn, lfn, nbytes, nops) in rows:
        launches = counts[rname]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_FLOP_PER_S * 1e3
        rec = {
            "name": rname, "route": "cuda", "source": SOURCES[family],
            "replaces": REPLACES[family], "launches": launches,
            "max_abs_err": float((kfn() - pfn()).abs().max()),
            "ms": device_ms(kfn), "plain_ms": device_ms(pfn),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if lfn is None else device_ms(lfn),
            "launches_per_cycle": launches_per_cycle[rname],
        }
        # the kernels line holds the main path's kernels; the flux mode is
        # checked and timed all the same, and its row loop runs inside
        # fused_stage
        if want[rname]:
            records.append(rec)
        lib = "-" if lfn is None else f"{rec['library_ms'] * 1e3:.1f} us"
        log(f"time {rname:24s} {rec['ms'] * 1e3:9.1f} us  plain "
            f"{rec['plain_ms'] * 1e3:9.1f} us  bound "
            f"{rec['bound_ms'] * 1e3:7.1f} us ({rec['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB)  library {lib}  launches per cycle "
            f"{launches_per_cycle[rname]:g}  [{name}, {smi}]")
    log(f"V-cycle, box flagship fp32 through the kernels: {cycle_ms:.3f} "
        f"ms per cycle (CUDA events over 10 cycles after 2) [{name}, {smi}]")

    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
