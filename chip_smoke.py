#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (mgcfd_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

What it does, in order, printing each step with the elapsed seconds:
  1. arms a watchdog that dumps every thread's traceback and exits
     non-zero after 8 minutes, and starts a child process that generates
     the tet flagship (68x64x70, 4 levels), writes it as the
     reference's files and parses them once, which fills their npz
     cache, while the box phases run (bench/tet_flagship.py, into a
     temporary directory removed at the end);
  2. prints the card (torch and nvidia-smi);
  3. builds the CUDA kernels (an nvcc process a source, all started
     together, then one link), and checks that each C entry point
     refuses a dtype code it does not know;
  4. holds every kernel against its plain PyTorch version on the card, in
     fp64, fp32 and bf16, printing the share of bit-equal elements:
     edge_csr in flux and rw modes at the box flagship's level-0 shapes,
     its wsum transfers, shift in flux and rw modes, shift.fused_stage
     (with and without a spill operand) and fused_stage at every level's
     shapes, with the launch shapes of the span kernel (channel split,
     unrolled span loop), of the wsum transfers (channel split, loads)
     and of edge_csr's rw mode (row, tile, lane groups) and flux mode
     (row, tile) read from their C entry points and held to the Python
     mirrors, rw mode at every level of the box flagship and every rw
     shape at its level 0, each bit-equal to the chosen one, flux mode at
     every level in every flux shape, each bit-equal to the chosen one
     and to the row kernel; the span kernels and the two tiled stage
     kernels also at shapes that stress their tiling and launch shapes (the flagship's
     plans cut to one span, a box whose two longer strides exceed the
     halo, a box whose node count is odd, the 32^3 tet's levels with
     16-span plans, and the tet's wsum transfers), the stage kernels
     launched twice (bit-equal) and with planted invalid values (counts
     equal); at bf16 every element within one bf16 spacing; and
     step_factor at every level of the box flagship in both variants,
     from a random state and with planted invalid values: bit-equal to
     its plain version at fp64, fp32 and bf16;
  5. drives the main path, MGCFDSolver(...).run() on the box flagship
     (304,640 nodes, 4 levels) with accumulate='auto', which takes the
     span kernels ('pallas') there: fp64 through the kernels against fp64
     through the plain path, then fp32 and bf16 through the kernels with
     the launch counts set to 0 just before each run and read just after;
  6. drives the CSR kernel path ('window', slice 1's path) on the same box
     the same way, and the span path unfused (fuse_stage=False) at fp64
     and bf16;
  7. runs the same box undamped (the FVCORR variant) from a perturbed
     state, where every node moves by O(0.1) per cycle, through 'pallas'
     and 'window': fp64 kernels against fp64 plain, the fp32 kernel RMS
     against the fp64 RMS, and bf16 through the kernels and through the
     plain path against fp64 (per channel and per-cycle RMS); the legacy
     step factor (FVCORR's) in one launch a visit, 6 a cycle;
  8. runs the box through run_batched(23, 10), two replays of a CUDA
     graph of 10 cycles and a tail of 3 through run, on 'pallas' at fp32
     and bf16 and on 'window' at fp32: every level's state bit-equal to
     run(23) from the same state, the RMS equal, the launches equal; then
     a NaN planted with load_state must raise FloatingPointError;
  9. writes the box flagship as the reference's files (.dat, .coords,
     .mg, input.dat), reads them back cold and through the npz cache
     (arrays equal to the generated mesh's), and runs them through `auto`
     (the RMS equal to the generated mesh's), with the host seconds;
 10. runs the box with every shift plan cut to one span, so that two
     thirds of its edges are spill edges: their flux goes through the
     edge_csr flux kernel into the fused stage's spill operand; fp64
     against the plain path, and bf16, launches counted;
 11. writes a 32^3, 3-level tet hierarchy as files, loads and renumbers
     it (RCM), and runs it through the CLI (-i ... --renumber) and, where
     `auto` sends it to 'window', through both paths at fp64, through
     `auto` at bf16, and through 'pallas' at fp64 (span plans that cover
     little, spill edges);
 12. loads the tet flagship that the child wrote, through the npz
     cache, and renumbers it (RCM), the CLI's -i ... --renumber path;
     then fp64 through `auto`
     ('window') against fp64 plain, and fp32 and bf16 through run_batched
     against run as in 8; edge_csr's rw mode at every level and every rw
     shape at level 0, and its flux mode at every level in every flux
     shape, as on the box in 4, at fp64, fp32 and bf16;
 13. the unfused window stage and the monitor (mgcfd_tpu_torch/monitor/):
     on the tet flagship, 'window' with fuse_window_stage=False at fp64,
     fp32 and bf16, edge_csr.flux over level 0's whole owner CSR held to
     its plain version, 18 flux and 18 rw launches a cycle and no
     fused_stage, fp64 against the fused path on every level; then the
     InstrumentedSolver on the tet flagship ('window') and the box
     flagship ('pallas') at fp32: every (function, level) timed, its
     calls equal to the launch counts, and measure_instrumented's kernels
     by family equal to the launch counts, charging at least 98% of the
     profiler's device time to the functions and the cycle's bookkeeping,
     the state unchanged;
     measure_production on one cycle of run on both flagships (device
     time per function and level, hand kernels and eager ops apart); the
     CLI's --monitor instrumented -o DIR/ --measure-ops -p FILE on the
     32^3 tet's files, its three reports' headers those of the reference;
 14. the reference's kernel variants, checkpoints, dumps, -v and the
     capacity legs (every tet flagship solver's plans through one plan
     cache), printing the phase's seconds beside the watchdog:
     mg_gather=False on the tet flagship ('window'): fp64 within
     identify_differences of the wsum transfers on every level, 18
     fused_stage and 18 rw launches a cycle and no wsum, and at fp32
     run_batched bit-equal to run (torch's deterministic index_add_ in
     both); flux_cripple on the box ('pallas') and the tet flagship
     ('window') at fp32: every level bit-equal to the run without it,
     the launches equal, the crippled twin's device time a cycle from
     measure_production (outside every function); the edge-stream
     variants on the box at fp64 ('scatter', 'ell', 'segment' with
     flux_fission and with flux_precompute_edge_weights) within
     identify_differences of 'segment' on every level, each timed in ms
     a cycle; on the tet flagship at fp32, run(2) with a checkpoint a
     cycle, then a new solver resumed from it (its plans all loaded from
     the cache, equal to the built ones, with both builds' host seconds)
     and run(1), bit-equal to run(3) with an equal RMS history; the CLI
     on the 32^3 tet's files with -c FILE and --output-variables at fp64,
     then -v against that dump (PASS, exit 0) and against a perturbed one
     (exit 1); and capacity.acceptance on the box flagship (fp32 auto,
     fp64 'segment') accepted;
 15. the native mesh parser and the sharded solver (parallel/), with the
     phase's seconds beside the watchdog: the tet flagship's files as the
     child parsed them through the native parser (its host seconds, no
     sidecar written, beside PR 10's 12.4 s Python read), and the 32^3
     tet's files through both readers, every array equal and timed; one NCCL
     rank (world size 1) at full width on the RCM tet flagship ('window'):
     fp64 within 1e-10 of the single-device port on every level, 3
     edge_csr.flux, 18 rw, 15 fused_stage and 3 of each transfer a cycle,
     fp32 run_batched (one CUDA graph of 10 cycles, NCCL collectives
     captured) bit-equal to run, ms a cycle through both beside the
     single device's, the profiler's launches by family equal to the
     counts, and level 0's edge_csr.flux over the [block | pool] operand
     beside its bound; then 2 gloo ranks sharing the card (the tet
     flagship) and 4 (the 32^3 tet) at fp64 within 1e-10 of the
     single-device port with live separators and rank 0's launches a
     cycle as counted (correctness legs: they measure no collective of
     the card); edge_csr.flux over shard
     0's level-0 CSR at P = 1, 2 and 4, RCM and shuffled, with `own`, in
     every flux shape (each bit-equal to the chosen one and to the row
     kernel), each shape timed beside its bound; and the CLI's
     --partitions 4 --partition-2d auto --shard-levels 2 on the 32^3 tet's files in 4 gloo ranks on the
     card, -v against the single-device CLI's fp64 dump;
 16. times each V-cycle (fp32 beside bf16) and each kernel at fp32, fp64
     and bf16 (each held to its plain version at the tolerance of 4
     first; step_factor bit-equal) beside its bound, its plain
     version, a library call where
     one computes the same function, and the launch floor (a one-element
     in-place add, timed the same way); the tet flagship's level-0 kernels
     in its RCM order and in the generator's shuffled order, its level-0
     edge_csr.rw at bf16 and fp64 too, and its level-0 edge_csr.flux
     (the unfused window stage's) at fp32, bf16 and fp64, every flux
     shape timed beside the chosen one; and ms per
     cycle through run_batched beside run, with device busy per cycle
     from torch.profiler, for the box ('pallas' fp32 and bf16, 'window'
     fp32) and the tet flagship ('window' fp32, RCM and shuffled); the
     profiler's count of each kernel family's launches must equal the
     launch counts, in one replay (the capture's, added by run_batched)
     and in the cycles of run (the wrappers');
 17. prints the card's name and power limit, one JSON line of kernel
     records, and last the JSON line {"ok": true, "device": {...}}.
Any failed check raises, and the exit code is then non-zero. Without a
CUDA device, or without the package beside this file, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import functools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WATCHDOG_S = 480
T0 = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12   # also the rate of the bf16 kernels' float32 math
FP64_FLOP_PER_S = 34e12

# the Pallas kernels the CUDA kernels replace
_WINDOW = "mgcfd_tpu/pallas/flux_window.py"
_SHIFT = "mgcfd_tpu/pallas/flux_shift.py"
REPLACES = {"edge_csr": f"{_WINDOW}:222", "fused_stage": f"{_WINDOW}:359",
            "shift_flux": f"{_SHIFT}:152",
            "shift_fused_stage": f"{_SHIFT}:380",
            # no Pallas kernel: jnp ops, which XLA fuses on the TPU
            "step_factor": "eager ops (mgcfd_tpu/solver/solver.py:590)"}
SOURCES = {"edge_csr": "mgcfd_tpu_torch/csrc/edge_csr.cu",
           "fused_stage": "mgcfd_tpu_torch/csrc/fused_stage.cu",
           "shift_flux": "mgcfd_tpu_torch/csrc/shift_flux.cu",
           "shift_fused_stage": "mgcfd_tpu_torch/csrc/shift_fused_stage.cu",
           "step_factor": "mgcfd_tpu_torch/csrc/step_factor.cu"}

# each kernel's bytes and operations: mgcfd_tpu_torch/monitor/costs.py,
# which the monitor's cost file reads too

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
# bf16 through the kernels and through the plain path against fp64 on the
# undamped box after 2 cycles: max |bf16 - fp64| per channel over the
# channel's fp64 scale, max |rho| for the density, max |rho u| (the
# momentum's magnitude) for each momentum channel, max |rho E| for the
# energy. The far field has no v or w momentum, so those channels' own
# maxima are 0.3-0.6% of the momentum, while bf16 rounds the O(|rho u|)
# terms that form them. The port's plain bf16 path on the CPU, same mesh
# family, variant and start, cut to 17x16x18 and 34x32x35 (a full-size run
# is for the card), reached at most 1.66e-2 (density); the kernel paths
# 1.63e-2. Twice that, rounded up:
BF16_TOL = 3e-2
# and each cycle's bf16 RMS within 2% of the fp64 RMS (the same CPU runs:
# at most 0.71%; bf16 holds 8 significant bits, 0.39% per rounding)
BF16_RMS_TOL = 2e-2
# a box whose two longer strides, 200 and 28,800, both exceed the span
# stage's halo: one is evaluated directly, the other marched
STRESS_BOX = (6, 144, 200)
# a box with an odd node count (47,565)
ODD_BOX = (7, 45, 151)
# launches per cycle of each path on the 4-level flagship: 6 visits of 3
# RK stages and of the step factor's 2 launches, 3 restrictions and 3
# prolongations
MG = {"edge_csr.wsum.restrict": 3, "edge_csr.wsum.prolong": 3}
WANT_MAIN = {"shift.fused_stage": 18, "shift.rw": 18, "step_factor": 12,
             **MG}
WANT_WINDOW = {"fused_stage": 18, "edge_csr.rw": 18, "step_factor": 12,
               **MG}
WANT_UNFUSED = {"shift.flux": 18, "shift.rw": 18, "step_factor": 12, **MG}
WANT_WINDOW_UNFUSED = {"edge_csr.flux": 18, "edge_csr.rw": 18,
                       "step_factor": 12, **MG}
# mg_gather=False: the plain scatter transfers, no wsum launch
WANT_NO_GATHER = {"fused_stage": 18, "edge_csr.rw": 18, "step_factor": 12}
# the instrumented solver's functions and the launch counter of the kernel
# each call launches once, by path
INSTRUMENTED_COUNTERS = {
    "window": {"flux": "edge_csr.flux", "indirect_rw": "edge_csr.rw",
               "restrict": "edge_csr.wsum.restrict",
               "prolong": "edge_csr.wsum.prolong"},
    "pallas": {"flux": "shift.flux", "indirect_rw": "shift.rw",
               "restrict": "edge_csr.wsum.restrict",
               "prolong": "edge_csr.wsum.prolong"}}
# the measured device time charged to the solver functions against all the
# profiler's device time in the same cycles
MEASURED_SHARE_MIN = 0.98
# kernel-against-plain tolerances by dtype; bf16 is held to one bf16
# spacing per element instead (mgcfd_tpu_torch/validate/rounding.py)
TOLS = {"torch.float64": TOL_FP64, "torch.float32": TOL_FP32}
TAGS = {"torch.float64": "fp64", "torch.float32": "fp32",
        "torch.bfloat16": "bf16"}
# run_batched against run: 23 cycles at K = 10 are two graph replays and a
# tail of 3 cycles through run
BATCH_CYCLES = 23
BATCH_K = 10
# the kernel family of each hand-written kernel's symbol, as the profiler
# names it (mgcfd::<symbol><...>), and of each launch counter
SYMBOL_FAMILY = {"edge_csr_kernel": "edge_csr", "rw_tile_kernel": "edge_csr",
                 "rw_group_kernel": "edge_csr",
                 "flux_tile_kernel": "edge_csr", "wsum_row_kernel": "wsum",
                 "wsum_split_kernel": "wsum",
                 "fused_stage_kernel": "fused_stage",
                 "shift_flux_kernel": "shift_flux",
                 "shift_rw_split_kernel": "shift_flux",
                 "shift_fused_stage_kernel": "shift_fused_stage",
                 "step_min_kernel": "step_factor",
                 "stage_factor_kernel": "step_factor",
                 "legacy_step_kernel": "step_factor"}
COUNTER_FAMILY = {"edge_csr.flux": "edge_csr", "edge_csr.rw": "edge_csr",
                  "edge_csr.wsum.restrict": "wsum",
                  "edge_csr.wsum.prolong": "wsum",
                  "fused_stage": "fused_stage", "shift.flux": "shift_flux",
                  "shift.rw": "shift_flux",
                  "shift.fused_stage": "shift_fused_stage",
                  "step_factor": "step_factor"}


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


def check_cases(cases, dt) -> None:
    """Kernel against plain: within TOLS[dt] of each channel's largest
    magnitude, or at bf16 within one bf16 spacing of each element."""
    import torch
    from mgcfd_tpu_torch.validate.rounding import bf16_agreement
    torch.cuda.synchronize()
    for name, got, want in cases:
        if dt == torch.bfloat16:
            ratio, same = bf16_agreement(got, want)
            log(f"check {name:30s} {str(dt):14s} max diff {ratio:.3f} of "
                f"the allowed one bf16 spacing; bit-equal {same:.4f}")
            require(ratio <= 1.0, f"{name} {dt}: {ratio:.3f} spacings")
            continue
        tol = TOLS[str(dt)]
        err = rel_err(got, want)
        same = float((got == want).double().mean())
        log(f"check {name:30s} {str(dt):14s} max rel err {err:.3e} "
            f"(tol {tol:.0e}); bit-equal {same:.4f}")
        require(err <= tol, f"{name} {dt}: {err:.3e} > {tol:.0e}")


def planted(q):
    """q with a NaN density, a negative density and a negative energy
    planted."""
    bad = q.clone()
    n = q.shape[1]
    bad[0, n // 2] = float("nan")
    bad[0, n // 4] = -1.0
    bad[4, n // 3] = -1.0
    return bad


def hold_stage(name, kernel, plain, args, q, dt) -> None:
    """A redesigned RK-stage kernel against its plain version on one
    input (check_cases, with the share of bit-equal elements), two
    launches bit-equal, invalid counts equal, and with a planted NaN,
    rho < 0 and E < 0 the counts equal and above 0."""
    import torch
    k1, i1 = kernel(*args(q))
    k2, i2 = kernel(*args(q))
    p, pi = plain(*args(q))
    torch.cuda.synchronize()
    require(torch.equal(k1, k2) and int(i1) == int(i2),
            f"{name} {dt}: two launches on the same input differ")
    check_cases([(name, k1, p)], dt)
    require(int(i1) == int(pi), f"{name} {dt}: invalid counts "
            f"{int(i1)} / {int(pi)}")
    bad = planted(q)
    ki, pi = int(kernel(*args(bad))[1]), int(plain(*args(bad))[1])
    require(ki == pi > 0, f"{name} {dt}: planted invalid counts {ki} / "
            f"{pi}")


def hold_stage_epilogues(name, kernel, plain, args, q, old, dt) -> None:
    """A fused stage as the solver's visits launch its last RK stage: the
    count added into an int64 counter that holds a value already, and the
    residual stored. The state and the residual bit-equal to the same
    kernel's without the epilogues followed by the eager q_next - old, the
    counter its start plus that launch's count; the state against the
    plain version's with the same epilogues (check_cases) and the counts
    equal to its; again with a planted NaN, rho < 0 and E < 0 (bits and
    counts only), the count then above 0."""
    import torch
    for label, x in (("", q), (" planted", planted(q))):
        what = f"{name}+epilogues{label}"
        start = torch.full((1,), 5, dtype=torch.int64, device=q.device)
        count, pcount = start.clone(), start.clone()
        k, kc, kres = kernel(*args(x), count=count, residual=True)
        p, pc, _ = plain(*args(x), count=pcount, residual=True)
        bare, binv = kernel(*args(x))
        torch.cuda.synchronize()
        require(kc is count and pc is pcount, f"{what} {dt}: the count "
                "was not added into the caller's counter")
        require(same_bits(k, bare) and same_bits(kres, bare - old),
                f"{what} {dt}: the state or the residual differ from the "
                "kernel's without the epilogues and the eager q - old")
        added = int(count) - int(start)
        require(added == int(binv) == int(pcount) - int(start)
                and (added > 0) == bool(label),
                f"{what} {dt}: counts {added} / {int(binv)} / "
                f"{int(pcount) - int(start)}")
        if not label:
            check_cases([(what, k, p)], dt)
        log(f"check {what:30s} {str(dt):14s} state and residual bit-equal "
            f"to the eager ops; count {added} into the int64 counter")


def wsum_epilogue_case(label: str, kern, csr, x, dt, keep=None,
                       correct=None):
    """A wsum transfer as the solver's visits launch it, with its
    epilogue, edge_csr.restrict(keep=vars_c) or edge_csr.prolong(correct=
    (vars_f, res_f)): bit-equal to the same kernel without it followed by
    the eager op it replaces (the torch.where of the rows with entries;
    vars_f + (res_f - P)). Returns its (name, kernel, plain) case against
    edge_csr_plain with the same epilogue, for check_cases."""
    import torch
    from mgcfd_tpu_torch.kernels import edge_csr
    got = kern(csr, x, keep=keep, correct=correct)
    bare = kern(csr, x)
    if keep is not None:
        empty = (csr.row_ptr[1:] == csr.row_ptr[:-1])[None]
        want = torch.where(empty, keep, bare)
    else:
        base, res = correct
        want = base + (res - bare)
    torch.cuda.synchronize()
    name = f"{kern.name}+epilogue {label}"
    require(same_bits(got, want), f"{name} {dt}: differs from the kernel "
            f"without its epilogue and the eager ops at "
            f"{int((got != want).sum())} of {got.numel()}")
    return (name, got, edge_csr.edge_csr_plain("wsum", csr, x, keep=keep,
                                               correct=correct))


def level_nc(lv, dt, dev):
    """The aggregated boundary/wall normals (11, N) of a host level."""
    import numpy as np
    import torch
    from mgcfd_tpu_torch.core.constants import far_field_state
    from mgcfd_tpu_torch.ops.tops import build_dense_boundary_wall
    bdn, wln, wlc = build_dense_boundary_wall(
        lv.num_nodes, lv.bedge_b, lv.bedge_w, lv.wedge_b, lv.wedge_w,
        far_field_state(np.float64)[1])
    return torch.as_tensor(np.concatenate([bdn, wln, wlc])).to(dev, dt)


def check_span_kernels(sh, q, dt, label: str) -> None:
    """shift.flux and shift.rw against their plain versions on one input,
    with the launch shape the C entry point picks held to the Python
    mirror (kernels/shift.py launch_shape)."""
    from mgcfd_tpu_torch.kernels import shift
    n = sh.num_nodes
    cases, shapes = [], []
    for mode, kern in (("flux", shift.flux), ("rw", shift.rw)):
        got = kern.shape(sh)
        want = shift.launch_shape(mode, dt, n, len(sh.deltas))
        require(got == want, f"shift.{mode} {label} {dt}: the C entry "
                f"point picks {got}, the mirror {want}")
        shapes.append(f"{mode}: split {int(got.split)} unroll "
                      f"{int(got.unroll)}")
        cases.append((f"shift.{mode} {label}", kern(sh, q),
                      shift.shift_plain(mode, sh, q)))
    log(f"shift shapes {label} {TAGS[str(dt)]}: " + "; ".join(shapes))
    check_cases(cases, dt)


def wsum_case(label: str, kern, csr, x, dt):
    """A wsum transfer's (name, kernel, plain) case, with the launch shape
    the C entry point picks for the CSR held to the Python mirror
    (kernels/edge_csr.py wsum_shape)."""
    from mgcfd_tpu_torch.kernels import edge_csr
    got = kern.shape(csr)
    want = edge_csr.wsum_shape(csr.num_rows, csr.num_entries, dt)
    require(got == want, f"{kern.name} {label} {dt}: the C entry point "
            f"picks {got}, the mirror {want}")
    log(f"wsum shape {label} {TAGS[str(dt)]}: {csr.num_rows} rows, "
        f"{csr.num_entries} entries: split {int(got.split)} loads "
        f"{got.loads}")
    return (f"{kern.name} {label}", kern(csr, x),
            edge_csr.edge_csr_plain("wsum", csr, x))


def check_rw(solver, label: str) -> None:
    """edge_csr.rw against its plain version on every level's CSR of a
    'window' solver, with the shape the C entry point picks held to the
    Python mirror (kernels/edge_csr.py rw_shape); at level 0 every rw shape
    too (EdgeCSR.at), each bit-equal to the chosen one."""
    import torch
    from mgcfd_tpu_torch.kernels import edge_csr
    dt = solver.dtype
    for lev, L in enumerate(solver.dmesh.levels):
        csr = L.csr
        got = edge_csr.rw.shape(csr)
        want = edge_csr.rw_shape(csr.num_rows, csr.num_entries, dt)
        require(got == want, f"edge_csr.rw {label} L{lev} {dt}: the C entry "
                f"point picks {got}, the mirror {want}")
        log(f"rw shape {label} L{lev} {TAGS[str(dt)]}: {csr.num_rows} rows, "
            f"{csr.num_entries} entries: {edge_csr.RW_SHAPES[got]}")
        q = random_state(L.num_nodes, 80 + lev, dt, L.volumes.device)
        plain = edge_csr.edge_csr_plain("rw", csr, q)
        chosen = edge_csr.rw(csr, q)
        cases = [(f"edge_csr.rw {label} L{lev}", chosen, plain)]
        if lev == 0:
            for shape, name in edge_csr.RW_SHAPES.items():
                out = edge_csr.rw.at(csr, q, shape)
                require(torch.equal(out, chosen), f"edge_csr.rw {label} L0 "
                        f"{dt}: shape {name} differs from the chosen one")
                cases.append((f"edge_csr.rw {label} L0 {name}", out, plain))
        check_cases(cases, dt)


def check_flux_shapes(csr, x, own, what: str) -> None:
    """edge_csr.flux over one CSR (own: the owners' values where the
    neighbour space is wider): the shape the C entry point picks held to
    the Python mirror (kernels/edge_csr.py flux_shape), every flux shape
    (EdgeCSR.at) bit-equal to the chosen one and to the row kernel, and
    each against the plain version (check_cases)."""
    import torch
    from mgcfd_tpu_torch.kernels import edge_csr
    dt = x.dtype
    got = edge_csr.flux.shape(csr)
    want = edge_csr.flux_shape(csr.num_rows, csr.num_entries, dt)
    require(got == want, f"edge_csr.flux {what} {dt}: the C entry point "
            f"picks {got}, the mirror {want}")
    log(f"flux shape {what} {TAGS[str(dt)]}: {csr.num_rows} rows, "
        f"{csr.num_entries} entries: {edge_csr.FLUX_SHAPES[got]}")
    plain = edge_csr.edge_csr_plain("flux", csr, x, own)
    chosen = edge_csr.flux(csr, x, own)
    outs = {s: edge_csr.flux.at(csr, x, s, own) for s in edge_csr.FLUX_SHAPES}
    cases = [(f"edge_csr.flux {what}", chosen, plain)]
    for shape, name in edge_csr.FLUX_SHAPES.items():
        require(torch.equal(outs[shape], chosen)
                and torch.equal(outs[shape], outs[edge_csr.FLUX_ROW]),
                f"edge_csr.flux {what} {dt}: shape {name} differs from the "
                "chosen one or the row kernel")
        cases.append((f"edge_csr.flux {what} {name}", outs[shape], plain))
    check_cases(cases, dt)


def check_flux(solver, label: str) -> None:
    """check_flux_shapes on every level's CSR of a 'window' solver."""
    dt = solver.dtype
    for lev, L in enumerate(solver.dmesh.levels):
        q = random_state(L.num_nodes, 85 + lev, dt, L.volumes.device)
        check_flux_shapes(L.csr, q, None, f"{label} L{lev}")


def flux_shape_times(csr, x, own, bound_ms: float, what: str,
                     card_label: str) -> dict:
    """Device time of edge_csr.flux at every flux shape over one CSR,
    beside the bound: {shape name: {"ms", "share"}}; the chosen one
    marked in the log."""
    from mgcfd_tpu_torch.kernels import edge_csr
    chosen = edge_csr.flux.shape(csr)
    out, parts = {}, []
    for shape, name in edge_csr.FLUX_SHAPES.items():
        ms = device_ms(lambda s=shape: edge_csr.flux.at(csr, x, s, own))
        out[name] = {"ms": ms, "share": bound_ms / ms}
        parts.append(f"{name}{'*' if shape == chosen else ''} "
                     f"{ms * 1e3:.1f} us ({bound_ms / ms:.2f})")
    log(f"flux shapes {what} {TAGS[str(x.dtype)]}: " + "; ".join(parts)
        + f"; bound {bound_ms * 1e3:.1f} us (* = chosen; share of the "
        f"bound) [{card_label}]")
    return out


def check_stage_shapes(mesh, tmesh, dtypes, dev) -> None:
    """The span kernels and the two redesigned stage kernels at shapes
    that stress their tiling and launch shapes, for each dtype: shift.flux,
    shift.rw and shift.fused_stage with the box flagship's plans cut to
    one span (spill operand), on a box whose two longer strides both
    exceed the halo (200 evaluated directly, 28,800 marched), on a box
    whose node count is odd, and on the 32^3 tet's levels with plans of
    16 spans (min_density 0.0005: halo, direct and marched spans, 0.2-8%
    coverage); fused_stage on those boxes and on the tet's levels; the
    wsum transfers between the tet's levels (irregular rows)."""
    import torch
    from mgcfd_tpu_torch.kernels import DeviceCSR, DeviceShift, edge_csr, \
        shift
    from mgcfd_tpu_torch.kernels.fused_stage import (fused_stage,
                                                     fused_stage_plain)
    from mgcfd_tpu_torch.mesh.generate import generate_box_mesh
    from mgcfd_tpu_torch.prep.csr import (build_flux_csr, build_prolong_csr,
                                          build_restrict_csr)
    from mgcfd_tpu_torch.prep.shift import build_shift_plan
    cases = [(f"flagship L{i} one-span", lv, {"max_deltas": 1}, False)
             for i, lv in enumerate(mesh.levels)]
    for dims in (STRESS_BOX, ODD_BOX):
        cases.append((f"box {'x'.join(map(str, dims))}",
                      generate_box_mesh(*dims), {}, True))
    cases += [(f"tet32 L{i}", lv, {"min_density": 0.0005}, True)
              for i, lv in enumerate(tmesh.levels)]
    transfers = []
    for i in range(tmesh.num_levels - 1):
        fine, coarse = tmesh.levels[i], tmesh.levels[i + 1]
        transfers += [
            (f"tet32 L{i}", edge_csr.restrict, build_restrict_csr(
                fine.mg_mapping, fine.num_nodes, coarse.num_nodes)[0]),
            (f"tet32 L{i}", edge_csr.prolong,
             build_prolong_csr(fine, coarse))]
    for dt in dtypes:
        wsum = []
        for label, kern, plan in transfers:
            csr = DeviceCSR.from_plan(plan, dev, dt)
            x = random_state(csr.num_cols, 34, dt, dev)
            wsum.append(wsum_case(label, kern, csr, x, dt))
        check_cases(wsum, dt)
        for label, lv, kw, with_csr in cases:
            n = lv.num_nodes
            nc = level_nc(lv, dt, dev)
            q = random_state(n, 31, dt, dev)
            old = q + 1e-3 * random_state(n, 32, dt, dev)
            fac = torch.full((n,), 1e-3, dtype=dt, device=dev)
            spill = 1e-3 * random_state(n, 33, dt, dev)
            plan = build_shift_plan(lv, **kw)
            sh = DeviceShift.from_plan(plan, n, dev, dt)
            sch = sh.schedule
            log(f"{label}: {n} nodes, spans {sh.deltas}, kinds {sch.kinds} "
                f"(0 halo, 1 marched, 2 direct), H {sch.halo}, "
                f"{sch.pencils} pencils x {sch.steps} steps, M "
                f"{sch.chunk}, spill edges {plan.spill_a.size}")
            check_span_kernels(sh, q, dt, label)
            hold_stage(f"shift.fused_stage+spill {label}",
                       shift.fused_stage, shift.shift_fused_stage_plain,
                       lambda x: (sh, nc, x, old, fac, spill), q, dt)
            if with_csr:
                csr = DeviceCSR.from_plan(build_flux_csr(lv), dev, dt)
                hold_stage(f"fused_stage {label}",
                           fused_stage, fused_stage_plain,
                           lambda x: (csr, nc, x, old, fac), q, dt)


def check_csr_kernels(solvers) -> None:
    """Each CSR kernel against its plain version at level-0 shapes, and
    fused_stage and the wsum transfers at every level's, for each
    solver's dtype: also as the solver's visits launch them, with their
    epilogues (hold_stage_epilogues, wsum_epilogue_case)."""
    from mgcfd_tpu_torch.kernels import edge_csr
    from mgcfd_tpu_torch.kernels.fused_stage import (fused_stage,
                                                     fused_stage_plain)
    from mgcfd_tpu_torch.kernels.step_factor import step_factor_plain
    plain = edge_csr.edge_csr_plain
    for solver in solvers:
        dt = solver.dtype
        L0, L1 = solver.dmesh.levels[0], solver.dmesh.levels[1]
        n0, n1 = L0.num_nodes, L1.num_nodes
        dev = L0.volumes.device
        q = random_state(n0, 1, dt, dev)
        old = q + 1e-3 * random_state(n0, 2, dt, dev)
        fac = step_factor_plain(q, L0.volumes, L0.cbrt_volumes, False) / 3.0
        xf = random_state(n0, 3, dt, dev)
        rc = random_state(n1, 4, dt, dev) - random_state(n1, 5, dt, dev)
        k_out, k_inv = fused_stage(L0.csr, L0.nc, q, old, fac)
        p_out, p_inv = fused_stage_plain(L0.csr, L0.nc, q, old, fac)
        check_cases([
            ("edge_csr.flux", edge_csr.flux(L0.csr, q),
             plain("flux", L0.csr, q)),
            ("edge_csr.rw", edge_csr.rw(L0.csr, q), plain("rw", L0.csr, q)),
            ("edge_csr.wsum.restrict", edge_csr.restrict(L0.restrict_csr,
                                                         xf),
             plain("wsum", L0.restrict_csr, xf)),
            ("edge_csr.wsum.prolong", edge_csr.prolong(L0.prolong_csr, rc),
             plain("wsum", L0.prolong_csr, rc)),
            ("fused_stage", k_out, p_out)], dt)
        require(int(k_inv) == int(p_inv) == 0,
                f"fused_stage invalid counts {int(k_inv)} / {int(p_inv)}")
        bad_q = planted(q)
        k_inv = int(fused_stage(L0.csr, L0.nc, bad_q, old, fac)[1])
        p_inv = int(fused_stage_plain(L0.csr, L0.nc, bad_q, old, fac)[1])
        log(f"check fused_stage invalid count with a planted NaN, rho<0 "
            f"and E<0: kernel {k_inv}, plain {p_inv}")
        require(k_inv == p_inv > 0, "fused_stage invalid counts differ")
        # every level: ragged last tiles; the wsum transfers of each level
        for lev, L in enumerate(solver.dmesh.levels):
            if L.restrict_csr is not None:
                xl = random_state(L.num_nodes, 50 + lev, dt, dev)
                m = L.prolong_csr.num_cols
                rl = random_state(m, 60 + lev, dt, dev) \
                    - random_state(m, 70 + lev, dt, dev)
                check_cases([
                    wsum_case(f"L{lev}", edge_csr.restrict, L.restrict_csr,
                              xl, dt),
                    wsum_case(f"L{lev}", edge_csr.prolong, L.prolong_csr,
                              rl, dt)], dt)
                # the update the visits make: restrict onto a coarse
                # state, prolong onto a fine state and residual
                mc, nf = L.restrict_csr.num_rows, L.num_nodes
                rf = random_state(nf, 90 + lev, dt, dev) \
                    - random_state(nf, 91 + lev, dt, dev)
                check_cases([
                    wsum_epilogue_case(
                        f"L{lev}", edge_csr.restrict, L.restrict_csr, xl,
                        dt, keep=random_state(mc, 92 + lev, dt, dev)),
                    wsum_epilogue_case(
                        f"L{lev}", edge_csr.prolong, L.prolong_csr, rl, dt,
                        correct=(random_state(nf, 93 + lev, dt, dev), rf))],
                    dt)
            ql = random_state(L.num_nodes, 40 + lev, dt, dev)
            oldl = ql + 1e-3 * random_state(L.num_nodes, 2, dt, dev)
            facl = step_factor_plain(ql, L.volumes, L.cbrt_volumes,
                                     False) / 3.0
            hold_stage(f"fused_stage L{lev}", fused_stage,
                       fused_stage_plain,
                       lambda x: (L.csr, L.nc, x, oldl, facl), ql, dt)
            hold_stage_epilogues(f"fused_stage L{lev}", fused_stage,
                                 fused_stage_plain,
                                 lambda x: (L.csr, L.nc, x, oldl, facl), ql,
                                 oldl, dt)


def same_bits(a, b) -> bool:
    """Equal, with NaN at the same places."""
    import torch
    return torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(), b.nan_to_num())


def check_step_factor(solvers) -> None:
    """step_factor against its plain version on every level of each
    solver, in both variants, from a random state and with planted
    invalid values (a NaN spoils every factor of the corrected variant):
    bit-equal at every dtype, with 2 launches (1 legacy)."""
    import torch
    from mgcfd_tpu_torch import kernels
    from mgcfd_tpu_torch.kernels.step_factor import (stage_factors_plain,
                                                     step_factor)
    for solver in solvers:
        dt = solver.dtype
        for lev, L in enumerate(solver.dmesh.levels):
            q = random_state(L.num_nodes, 80 + lev, dt, L.volumes.device)
            for legacy in (False, True):
                name = f"step_factor L{lev}{' legacy' if legacy else ''}"
                for label, x in (("", q), (" planted", planted(q))):
                    before = kernels.launch_counts()["step_factor"]
                    got = step_factor(x, L.volumes, L.cbrt_volumes, legacy,
                                      L.step)
                    launched = kernels.launch_counts()["step_factor"] - before
                    want = stage_factors_plain(x, L.volumes, L.cbrt_volumes,
                                               legacy)
                    torch.cuda.synchronize()
                    require(launched == (1 if legacy else 2),
                            f"{name}{label} {dt}: {launched} launches")
                    require(same_bits(got, want), f"{name}{label} {dt}: "
                            "the kernel's factors differ from the plain "
                            f"version's at {int((got != want).sum())} of "
                            f"{got.numel()}")
                log(f"check {name:30s} {str(dt):14s} {L.num_nodes} nodes: "
                    "bit-equal, and with a planted NaN, rho<0 and E<0")


def check_shift_kernels(solvers) -> None:
    """Each span kernel against its plain version at every level's shapes
    (levels 1-3: 38,080, 4,896 and 648 nodes, no multiple of the
    256-node tile, spans up to 1120 reach across tiles), for each
    solver's dtype; the fused stage also launched twice (bit-equal), and
    with and without spill with its epilogues (hold_stage_epilogues)."""
    from mgcfd_tpu_torch.kernels import shift
    from mgcfd_tpu_torch.kernels.step_factor import step_factor_plain
    for solver in solvers:
        dt = solver.dtype
        for lev in range(len(solver.dmesh.levels)):
            L = solver.dmesh.levels[lev]
            sh, n, dev = L.shift, L.num_nodes, L.volumes.device
            q = random_state(n, 11 + lev, dt, dev)
            old = q + 1e-3 * random_state(n, 13, dt, dev)
            fac = step_factor_plain(q, L.volumes, L.cbrt_volumes, False) / 3.0
            spill = 1e-3 * random_state(n, 14, dt, dev)
            k0, k0_inv = shift.fused_stage(sh, L.nc, q, old, fac)
            p0, p0_inv = shift.shift_fused_stage_plain(sh, L.nc, q, old,
                                                       fac)
            again, _ = shift.fused_stage(sh, L.nc, q, old, fac)
            require(bool((again == k0).all()),
                    f"shift.fused_stage L{lev} {dt}: two launches differ")
            sch = sh.schedule
            log(f"shift.fused_stage L{lev}: kinds {sch.kinds}, H "
                f"{sch.halo}, {sch.pencils} pencils x {sch.steps} steps, "
                f"M {sch.chunk}")
            k1, _ = shift.fused_stage(sh, L.nc, q, old, fac, spill)
            p1, _ = shift.shift_fused_stage_plain(sh, L.nc, q, old, fac,
                                                  spill)
            check_span_kernels(sh, q, dt, f"L{lev} spans {sh.deltas}")
            check_cases([
                (f"shift.fused_stage L{lev}", k0, p0),
                (f"shift.fused_stage+spill L{lev}", k1, p1)], dt)
            require(int(k0_inv) == int(p0_inv) == 0,
                    f"shift.fused_stage invalid counts {int(k0_inv)} / "
                    f"{int(p0_inv)}")
            bad_q = planted(q)
            k_inv = int(shift.fused_stage(sh, L.nc, bad_q, old, fac)[1])
            p_inv = int(shift.shift_fused_stage_plain(sh, L.nc, bad_q, old,
                                                      fac)[1])
            log(f"check shift.fused_stage L{lev} invalid count with a "
                f"planted NaN, rho<0 and E<0: kernel {k_inv}, plain "
                f"{p_inv}")
            require(k_inv == p_inv > 0,
                    "shift.fused_stage invalid counts differ")
            for what, extra in (("", ()), ("+spill", (spill,))):
                hold_stage_epilogues(
                    f"shift.fused_stage{what} L{lev}", shift.fused_stage,
                    shift.shift_fused_stage_plain,
                    lambda x, e=extra: (sh, L.nc, x, old, fac, *e), q, old,
                    dt)


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


def counted_run(solver, cycles: int, what: str, want: dict | None = None):
    """Run `cycles` cycles with every launch count set to 0 just before
    and read just after. With `want` (launches per cycle of the kernels
    the path runs) every other count must stay 0."""
    from mgcfd_tpu_torch import kernels
    kernels.reset_launch_counts()
    solver.run(cycles)
    counts = kernels.launch_counts()
    pc = per_cycle(counts, cycles)
    log(f"{what}: {cycles} cycles, launches {counts}")
    if want is not None:
        full = {k: want.get(k, 0) for k in counts}
        require(pc == full, f"{what}: launches per cycle {pc} != {full}")
    return counts, pc


def timed_run(solver, what: str):
    """fp32 path: 2 cycles then 10 timed by CUDA events, all with launches
    counted. Returns (counts, per cycle, ms per cycle, level-0 variables
    after the first 2 cycles)."""
    import torch
    from mgcfd_tpu_torch import kernels
    kernels.reset_launch_counts()
    solver.run(2)
    v2 = solver.variables(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    solver.run(10)
    end.record()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cycles = solver.completed_cycles
    log(f"{what}: {cycles} cycles through the kernels; launches {counts}")
    return counts, per_cycle(counts, cycles), \
        start.elapsed_time(end) / 10, v2


def same_arrays(got, want, what: str) -> None:
    """Two hierarchies hold equal arrays on every level (a round trip
    through %.17e text is exact)."""
    import numpy as np
    from mgcfd_tpu_torch.core.types import LEVEL_ARRAYS
    require(got.variant == want.variant
            and got.num_levels == want.num_levels, f"{what}: variant or "
            "level count differs")
    for lev, (g, w) in enumerate(zip(got.levels, want.levels)):
        for f in LEVEL_ARRAYS:
            a, b = getattr(g, f), getattr(w, f)
            require((a is None and b is None) or (
                a is not None and b is not None and np.array_equal(a, b)),
                f"{what}: level {lev} {f} differs")


def counted_batched(solver, cycles: int, k: int, what: str):
    """counted_run through run_batched(cycles, k): every launch count set
    to 0 just before and read just after (a replay adds the launches its
    capture recorded; the capture's warm-up adds none)."""
    from mgcfd_tpu_torch import kernels
    kernels.reset_launch_counts()
    solver.run_batched(cycles, k)
    counts = kernels.launch_counts()
    log(f"{what}: {cycles} cycles through run_batched (K = {k}), launches "
        f"{counts}")
    return counts, per_cycle(counts, cycles)


def batched_equals_run(make, what: str, want: dict | None = None,
                       exact: bool = True) -> None:
    """run_batched(BATCH_CYCLES, BATCH_K) (two graph replays and a tail of
    three through run) against run(BATCH_CYCLES), each on a solver from
    make() from the same state: every level's variables and residuals
    bit-equal, the RMS history equal, the launches equal (and, with
    `want`, those per cycle of the path). Without `exact` (the plain
    paths, whose index_add_ sums with atomics on the card) the variables
    and RMS within identify_differences instead. Then a state with a
    planted NaN, installed with load_state, must make run_batched raise
    FloatingPointError naming its first batch."""
    import numpy as np
    import torch
    a, b = make(), make()
    counts_a, _ = counted_run(a, BATCH_CYCLES, f"{what} run", want)
    counts_b, pc_b = counted_batched(b, BATCH_CYCLES, BATCH_K, what)
    require(counts_a == counts_b, f"{what}: run_batched launched {counts_b}, "
            f"run {counts_a}")
    require(a.completed_cycles == b.completed_cycles == BATCH_CYCLES
            and len(b.rms_history) == BATCH_CYCLES,
            f"{what}: cycle counts differ")
    if exact:
        for key in ("variables", "residuals"):
            for lev, (x, y) in enumerate(zip(a.state[key], b.state[key])):
                require(torch.equal(x, y), f"{what}: {key} of level {lev} "
                        "differ between run_batched and run")
        require(a.rms_history == b.rms_history, f"{what}: RMS differs")
        how = "bit for bit on every level, RMS equal"
    else:
        same_as_plain(b, a, a.mesh, f"{what}: run_batched against run")
        how = "within identify_differences"
    healthy(b, f"{what} run_batched")
    log(f"{what}: run_batched({BATCH_CYCLES}, {BATCH_K}) == run("
        f"{BATCH_CYCLES}) {how}, launches per cycle {pc_b}")
    bad = {"variables": [b.variables(lev) for lev in
                         range(len(b.dmesh.levels))],
           "residuals": [np.zeros_like(b.variables(lev)) for lev in
                         range(len(b.dmesh.levels))]}
    bad["variables"][0][len(bad["variables"][0]) // 2, 0] = np.nan
    b.load_state(bad)
    try:
        b.run_batched(BATCH_K, BATCH_K)
    except FloatingPointError as e:
        require(f"within cycles 1..{BATCH_K}" in str(e),
                f"{what}: the NaN guard named no batch: {e}")
        log(f"{what}: planted NaN -> FloatingPointError: {e}")
    else:
        raise CheckFailed(f"{what}: run_batched did not raise on a NaN")


def by_family(counts: dict) -> dict:
    """Launch counts {counter: n} summed by kernel family."""
    out = {}
    for counter, n in counts.items():
        fam = COUNTER_FAMILY[counter]
        out[fam] = out.get(fam, 0) + n
    return {f: n for f, n in out.items() if n}


def profiled_launches(kernel_events) -> dict:
    """The launches of each hand-written kernel family that torch.profiler
    saw: its CUDA kernel events, counted by symbol."""
    import re
    out = {}
    for e in kernel_events:
        m = re.search(r"mgcfd::(\w+)<", e.key)
        if m and m.group(1) in SYMBOL_FAMILY:
            fam = SYMBOL_FAMILY[m.group(1)]
            out[fam] = out.get(fam, 0) + e.count
    return out


def batched_timing(solver, what: str, card_label: str) -> dict:
    """ms per cycle through run_batched (K = BATCH_K; CUDA events over two
    replays after a warm one) beside run (10 cycles after 2), and device
    busy per cycle from torch.profiler over one replay and over BATCH_K
    cycles of run. The profiler's kernel events also give an independent
    count of the launches, which must equal the launch counts each kernel
    family's wrappers report for the same span: in the replay the counts
    that the graph's capture recorded and run_batched adds, in the cycles
    of run the wrappers' own."""
    import torch
    from mgcfd_tpu_torch import kernels
    from mgcfd_tpu_torch.bench.profile_cycle import profile_cycles
    k = BATCH_K

    def events_ms(fn, cycles):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / cycles

    solver.run(2)
    run_ms = events_ms(lambda: solver.run(10), 10)
    solver.run_batched(k, k)
    graph_ms = events_ms(lambda: solver.run_batched(2 * k, k), 2 * k)
    def profiled(fn, span: str):
        kernels.reset_launch_counts()
        wall, busy, kern, _ = profile_cycles(fn, k)
        seen = profiled_launches(kern)
        counted = by_family(kernels.launch_counts())
        require(seen == counted, f"{what}: in {span} the profiler saw "
                f"launches {seen}, the counts say {counted}")
        return wall, busy, seen

    wall_g, busy_g, seen = profiled(lambda: solver.run_batched(k, k),
                                    "one replay")
    wall_r, busy_r, seen_r = profiled(lambda: solver.run(k),
                                      f"{k} cycles of run")
    rec = {"cell": what, "run_ms": run_ms, "run_batched_ms": graph_ms,
           "busy_ms_graph": busy_g, "idle_graph": 1 - busy_g / wall_g,
           "wall_ms_graph_profiled": wall_g, "busy_ms_run": busy_r,
           "idle_run": 1 - busy_r / wall_r, "wall_ms_run_profiled": wall_r}
    log(f"timing {what}: run_batched (K = {k}) {graph_ms:.3f} ms/cycle, "
        f"run {run_ms:.3f} ms/cycle (CUDA events); one replay under the "
        f"profiler: busy {busy_g:.3f} ms/cycle of {wall_g:.3f}, idle share "
        f"{rec['idle_graph']:.3f}; run under the profiler: busy "
        f"{busy_r:.3f} of {wall_r:.3f}, idle {rec['idle_run']:.3f}; "
        f"launches by family, profiler == counts: one replay {seen}, "
        f"{k} cycles of run {seen_r} "
        f"[{card_label}]")
    healthy(solver, what)
    return rec


def refuse_unknown_dtype(lib) -> None:
    """Every C entry point returns nonzero for a dtype code it does not
    know (here 7), before it reads any pointer or launches anything."""
    import ctypes
    deltas = (ctypes.c_int64 * 1)(1)
    kinds = (ctypes.c_int64 * 1)(0)   # one halo span
    shape = (ctypes.c_int64 * 2)()
    rcs = {
        "mgcfd_edge_csr": lib.mgcfd_edge_csr(7, 0, None, None, None, 0,
                                             None, None, 1, None, 1, None,
                                             None, None, None),
        "mgcfd_fused_stage": lib.mgcfd_fused_stage(
            7, None, None, None, 0, None, None, None, None, None, None, None,
            1, None),
        "mgcfd_shift_flux": lib.mgcfd_shift_flux(
            7, 0, ctypes.addressof(deltas), 1, None, None, None, 1, None),
        "mgcfd_shift_flux_at": lib.mgcfd_shift_flux_at(
            7, 0, 0, 0, ctypes.addressof(deltas), 1, None, None, None, 1,
            None),
        "mgcfd_shift_flux_shape": lib.mgcfd_shift_flux_shape(
            7, 0, 1, 1, ctypes.addressof(shape)),
        "mgcfd_wsum_at": lib.mgcfd_wsum_at(7, 0, 0, None, None, None, 0,
                                           None, 1, None, 1, None, None,
                                           None, None),
        "mgcfd_wsum_shape": lib.mgcfd_wsum_shape(7, 1, 1,
                                                 ctypes.addressof(shape)),
        "mgcfd_rw_at": lib.mgcfd_rw_at(7, 0, None, None, None, 0, None, None,
                                       1, None, 1, None),
        "mgcfd_rw_shape": lib.mgcfd_rw_shape(7, 1, 1,
                                             ctypes.addressof(shape)),
        "mgcfd_flux_at": lib.mgcfd_flux_at(7, 0, None, None, None, 0, None,
                                           None, 1, None, 1, None),
        "mgcfd_flux_shape": lib.mgcfd_flux_shape(7, 1, 1,
                                                 ctypes.addressof(shape)),
        "mgcfd_shift_fused_stage": lib.mgcfd_shift_fused_stage(
            7, ctypes.addressof(deltas), ctypes.addressof(kinds), 1, 8, 1,
            None, None, None, None, None, None, None, None, None, 1, None),
        "mgcfd_step_factor": lib.mgcfd_step_factor(
            7, 0, None, None, None, None, 0, None, None, 1, None),
    }
    log(f"dtype code 7 refused: {rcs}")
    require(all(rc != 0 for rc in rcs.values()),
            f"an entry point took an unknown dtype code: {rcs}")


def healthy(solver, what: str) -> None:
    """Every level's variables finite with a positive density, and every
    RMS read finite."""
    import numpy as np
    for lev in range(len(solver.dmesh.levels)):
        v = solver.variables(lev)
        require(bool(np.isfinite(v).all()) and bool((v[:, 0] > 0).all()),
                f"{what}: level {lev} not finite or density not positive")
    require(all(math.isfinite(r) for r in solver.rms_history),
            f"{what}: RMS {solver.rms_history}")
    log(f"{what}: {solver.completed_cycles} cycles, finite, density "
        f"positive on every level; RMS {solver.rms_history}")


def bf16_tracks_fp64(s16, s64, what: str) -> None:
    """bf16 against fp64 after the same cycles from the same start: each
    channel's max |difference| over its fp64 scale (BF16_TOL; the
    momentum channels share the momentum's magnitude as their scale) and
    each cycle's RMS (BF16_RMS_TOL)."""
    import numpy as np
    healthy(s16, what)
    v16, v64 = s16.variables(0), s64.variables(0)
    mom = np.sqrt((v64[:, 1:4] ** 2).sum(axis=1)).max()
    scale = np.array([np.abs(v64[:, 0]).max(), mom, mom, mom,
                      np.abs(v64[:, 4]).max()])
    err = np.abs(v16 - v64).max(axis=0) / scale
    rms = [abs(a / b - 1) for a, b in zip(s16.rms_history,
                                          s64.rms_history)]
    log(f"{what} vs fp64, 2 cycles: per-channel max diff over scale "
        f"{np.array2string(err, precision=3)} (tol {BF16_TOL:.0e}); RMS "
        f"{s16.rms_history} vs {s64.rms_history}, relative "
        f"{np.array2string(np.array(rms), precision=4)} (tol "
        f"{BF16_RMS_TOL:.0e})")
    require(bool((err <= BF16_TOL).all()), f"{what}: {err} > {BF16_TOL}")
    require(max(rms) <= BF16_RMS_TOL, f"{what}: RMS {rms}")


def launch_floor_ms(dev) -> float:
    """The launch floor: a one-element in-place add, timed as the
    kernels are."""
    import torch
    one = torch.zeros(1, device=dev)
    return device_ms(lambda: one.add_(1))


def sparse_csr(csr):
    """The CSR's first weight row as a torch sparse CSR matrix."""
    import torch
    return torch.sparse_csr_tensor(
        csr.row_ptr, csr.col, csr.w[0].contiguous(),
        (csr.num_rows, csr.num_cols), check_invariants=True)


def affine_rw(rows, cols, vals, const, n: int, q):
    """The rw twins are affine in q: out^T = C + M q^T with M sparse (the
    (row, col, value) triplets given, duplicates summed) and C (n, 5).
    Returns the one PyTorch call that computes it, torch.sparse.addmm on
    q^T, with M, C and q^T made here, outside the call."""
    import numpy as np
    import torch
    dev, dt = q.device, q.dtype
    m = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([rows, cols])),
        torch.as_tensor(vals), (n, n)).coalesce().to(dev, dt) \
        .to_sparse_csr()
    c = torch.as_tensor(const).to(dev, dt)
    qt = q.T.contiguous()
    return lambda: torch.sparse.addmm(c, m, qt)


def csr_rw_library(csr, q):
    """edge_csr's rw mode as one library call: row i sums q_i + q_j + w0 +
    w1 + w2 over its entries, so M = adjacency + diag(row length) and C_i
    = the row's weight sums."""
    import numpy as np
    owner = csr.owner.cpu().numpy()
    col = csr.col.cpu().numpy().astype(np.int64)
    n = csr.num_rows
    deg = np.bincount(owner, minlength=n).astype(np.float64)
    wsum = csr.w[:3].double().sum(dim=0).cpu().numpy()
    const = np.zeros((n, 5))
    const += np.bincount(owner, weights=wsum, minlength=n)[:, None]
    idx = np.arange(n)
    return affine_rw(np.concatenate([owner, idx]), np.concatenate([col, idx]),
                     np.concatenate([np.ones(col.size), deg]), const, n, q)


def shift_rw_library(sh, q):
    """shift's rw mode as one library call: per span d, node i adds
    val_d(i) - val_d(i - d) with val_d(j) = q_j + q_{j+d} + S_d(j), so the
    q_i terms cancel: M has +1 at (i, i + d) and -1 at (i, i - d) where
    those lie in [0, N), and C holds the weight sums S and the quiescent
    state (rho = 1, E = 1) that stands in for an end outside [0, N)."""
    import numpy as np
    n = sh.num_nodes
    quiet = np.array([1.0, 0.0, 0.0, 0.0, 1.0])
    w = sh.w.double().cpu().numpy()
    rows, cols, vals = [], [], []
    const = np.zeros((n, 5))
    idx = np.arange(n)
    for k, d in enumerate(sh.deltas):
        s = w[k, :3].sum(axis=0)
        hi, lo = idx[idx + d < n], idx[idx >= d]
        rows += [hi, lo]
        cols += [hi + d, lo - d]
        vals += [np.ones(hi.size), -np.ones(lo.size)]
        const[idx + d >= n] += quiet
        const[idx < d] -= quiet
        const[:, :] += s[:, None]
        const[lo] -= s[lo - d][:, None]
    return affine_rw(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals), const, n, q)


def time_rows(rows, runs, dt, floor_ms: float, card_label: str,
              suffix: str = ""):
    """Time each row (name, which is also its launch counter, kernel
    family, path whose run gives the launches, kernel fn, plain fn, library
    fn or None, bytes, operations) as one record, after holding the kernel
    to its plain version on the same inputs (check_cases): device time
    beside the bound for this dtype's bytes and operations, the plain
    version's time and the library call's. runs: path -> (launch counts, per cycle).
    Record names take `suffix`, and a dtype other than fp32 as a further
    suffix."""
    import torch
    tag = TAGS[str(dt)]
    flops = FP64_FLOP_PER_S if dt == torch.float64 else FP32_FLOP_PER_S
    records = []
    for (rname, family, run, kfn, pfn, lfn, nbytes, nops) in rows:
        counter = rname
        counts, pc = runs[run]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / flops * 1e3
        require(counts[counter] > 0, f"{rname}: no launch in the {tag} "
                f"{run} run")
        lib_ms, lib_note = None, "-"
        if lfn is not None:
            try:
                lib_ms = device_ms(lfn)
                lib_note = f"{lib_ms * 1e3:.1f} us"
            except RuntimeError as e:   # no such library call for dt
                lib_note = f"none ({str(e).splitlines()[0][:60]})"
        name = rname + suffix + ("" if tag == "fp32" else f".{tag}")
        got, want = kfn(), pfn()
        check_cases([(name, got, want)], dt)
        rec = {
            "name": name, "route": "cuda", "source": SOURCES[family],
            "replaces": REPLACES[family], "launches": counts[counter],
            "max_abs_err": float((got.double() - want.double()).abs()
                                 .max()),
            "ms": device_ms(kfn), "plain_ms": device_ms(pfn),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "floor_ms": floor_ms,
            "dtype": str(dt).split(".")[-1],
            "path": run, "launches_per_cycle": pc[counter],
        }
        records.append(rec)
        log(f"time {rec['name']:29s} {rec['ms'] * 1e3:9.1f} us  plain "
            f"{rec['plain_ms'] * 1e3:9.1f} us  bound "
            f"{rec['bound_ms'] * 1e3:7.1f} us ({rec['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB)  floor {floor_ms * 1e3:.1f} us  "
            f"library {lib_note}  launches per "
            f"cycle {pc[counter]:g} ({tag} {run} run)  [{card_label}]")
    return records


def check_library(name: str, lfn, pfn, dt) -> None:
    """A library row computes the kernel's function: its node-major result
    against the plain version (fp32 and fp64; other dtypes may have no
    such call)."""
    import torch
    if dt == torch.bfloat16:
        return
    check_cases([(f"{name} library call", lfn().T.contiguous(), pfn())], dt)


def window_rows(W0, q, old, fac, res1, run: str, transfer_run: str):
    """time_rows rows of the CSR kernels at level 0 of a 'window' solver:
    fused_stage and edge_csr.rw (launches from the `run` path's run), the
    restriction and the prolongation (from `transfer_run`'s)."""
    import torch
    from mgcfd_tpu_torch.kernels import edge_csr
    from mgcfd_tpu_torch.kernels.fused_stage import (fused_stage,
                                                     fused_stage_plain)
    from mgcfd_tpu_torch.monitor.costs import edge_csr_cost, fused_stage_cost
    plain = edge_csr.edge_csr_plain
    sz = q.element_size()
    sp_r, sp_p = sparse_csr(W0.restrict_csr), sparse_csr(W0.prolong_csr)
    xf_t, rc_t = q.T.contiguous(), res1.T.contiguous()
    lib_crw = csr_rw_library(W0.csr, q)
    check_library(f"edge_csr.rw ({run})", lib_crw,
                  lambda: plain("rw", W0.csr, q), q.dtype)
    # name and counter, kernel family, path whose run gives the launches,
    # kernel fn, plain fn, library fn, bytes, operations
    return [
        ("edge_csr.wsum.restrict", "edge_csr", transfer_run,
         lambda: edge_csr.restrict(W0.restrict_csr, q),
         lambda: plain("wsum", W0.restrict_csr, q),
         lambda: torch.sparse.mm(sp_r, xf_t),
         *edge_csr_cost("wsum", W0.restrict_csr, sz)),
        ("edge_csr.wsum.prolong", "edge_csr", transfer_run,
         lambda: edge_csr.prolong(W0.prolong_csr, res1),
         lambda: plain("wsum", W0.prolong_csr, res1),
         lambda: torch.sparse.mm(sp_p, rc_t),
         *edge_csr_cost("wsum", W0.prolong_csr, sz)),
        ("fused_stage", "fused_stage", run,
         lambda: fused_stage(W0.csr, W0.nc, q, old, fac)[0],
         lambda: fused_stage_plain(W0.csr, W0.nc, q, old, fac)[0], None,
         *fused_stage_cost(W0.csr, sz)),
        ("edge_csr.rw", "edge_csr", run,
         lambda: edge_csr.rw(W0.csr, q), lambda: plain("rw", W0.csr, q),
         lib_crw, *edge_csr_cost("rw", W0.csr, sz)),
    ]


def kernel_records(s_main, s_win, spill_csr, runs, card_label: str):
    """Each kernel's record at the level-0 shapes and dtype of s_main
    ('pallas') and s_win ('window'); see time_rows. The library call, where
    one PyTorch call computes the same function, is torch.sparse.mm for
    the transfers and torch.sparse.addmm for the rw twins (affine in q);
    the flux and the stages have none (nonlinear in q)."""
    import torch
    from mgcfd_tpu_torch.kernels import edge_csr, shift
    from mgcfd_tpu_torch.kernels.step_factor import (stage_factors_plain,
                                                     step_factor)
    from mgcfd_tpu_torch.monitor.costs import (edge_csr_cost, shift_cost,
                                               shift_fused_stage_cost,
                                               step_factor_cost)
    dt = s_main.dtype
    M0 = s_main.dmesh.levels[0]
    q = s_main.state["variables"][0]
    old = q + 1e-6 * q
    fac = torch.full_like(M0.volumes, 1e-3)
    sz = q.element_size()
    sh = M0.shift
    # the spill edges of the one-span level 0, in this dtype
    spill = dataclasses.replace(spill_csr, w=spill_csr.w.to(dt))
    lib_srw = shift_rw_library(sh, q)
    check_library("shift.rw", lib_srw, lambda: shift.shift_plain(
        "rw", sh, q), dt)
    rows = [
        ("shift.fused_stage", "shift_fused_stage", "main",
         lambda: shift.fused_stage(sh, M0.nc, q, old, fac)[0],
         lambda: shift.shift_fused_stage_plain(sh, M0.nc, q, old, fac)[0],
         None, *shift_fused_stage_cost(sh, sz)),
        ("shift.rw", "shift_flux", "main", lambda: shift.rw(sh, q),
         lambda: shift.shift_plain("rw", sh, q), lib_srw,
         *shift_cost("rw", sh, sz)),
        ("shift.flux", "shift_flux", "unfused", lambda: shift.flux(sh, q),
         lambda: shift.shift_plain("flux", sh, q), None,
         *shift_cost("flux", sh, sz)),
        *window_rows(s_win.dmesh.levels[0], q, old, fac,
                     s_main.state["residuals"][1], "window", "main"),
        ("edge_csr.flux", "edge_csr", "spill",
         lambda: edge_csr.flux(spill, q),
         lambda: edge_csr.edge_csr_plain("flux", spill, q), None,
         *edge_csr_cost("flux", spill, sz)),
    ]
    rows.append((
        "step_factor", "step_factor", "main",
        lambda: step_factor(q, M0.volumes, M0.cbrt_volumes, False, M0.step),
        lambda: stage_factors_plain(q, M0.volumes, M0.cbrt_volumes, False),
        None, *step_factor_cost(M0.num_nodes, sz)))
    return time_rows(rows, runs, dt, launch_floor_ms(q.device), card_label)


def tet_records(solvers, runs, card_label: str, only: str | None = None):
    """Level-0 records of the tet flagship's window path for each of
    solvers {suffix: 'window' solver} (fp32: its RCM order, the generator's
    shuffled order): fused_stage, edge_csr.rw and the two transfers, or
    the one named `only`, timed as kernel_records times them, names
    suffixed."""
    import torch
    records = []
    for suffix, s in solvers.items():
        W0 = s.dmesh.levels[0]
        q = s.state["variables"][0]
        rows = window_rows(W0, q, q + 1e-6 * q,
                           torch.full_like(W0.volumes, 1e-3),
                           s.state["residuals"][1], suffix, suffix)
        rows = [r for r in rows if only in (None, r[0])]
        records += time_rows(rows, runs, s.dtype, launch_floor_ms(q.device),
                             card_label, suffix)
    return records


def kernel_family(name: str):
    """The family of a hand-written kernel's profiler name, else None."""
    import re
    m = re.search(r"mgcfd::(\w+)<", name)
    return SYMBOL_FAMILY.get(m.group(1)) if m else None


def hand_split(rec: dict):
    """(launches by family, hand-kernel us, eager-kernel us, eager count)
    of one measured record {"kernels": {name: [count, us]}}."""
    fams, hand_us, eager_us, eager_n = {}, 0.0, 0.0, 0
    for kname, (count, us) in rec["kernels"].items():
        fam = kernel_family(kname)
        if fam is None:
            eager_us += us
            eager_n += count
        else:
            fams[fam] = fams.get(fam, 0) + count
            hand_us += us
    return fams, hand_us, eager_us, eager_n


def check_instrumented(ins, what: str, cycles: int) -> None:
    """An InstrumentedSolver for `cycles` cycles with the launch counts
    set to 0 just before: every (function, level) of the walk timed,
    calls equal to the launch counters of the kernels each call launches
    once; then measure_instrumented over one more cycle: the kernels it
    charged to the functions, counted by family, equal to the wrappers'
    launch counts in that cycle, and the device time it charged to the
    functions (the report's and the cycle's bookkeeping: invalid_count,
    residual, rms) at least MEASURED_SHARE_MIN of the profiler's whole
    device time there. The state after the measurement is the state
    before."""
    import torch
    from mgcfd_tpu_torch import kernels
    from mgcfd_tpu_torch.monitor import opstats
    L = len(ins.dmesh.levels)
    kernels.reset_launch_counts()
    ins.run(cycles, warmup=False)
    counts = kernels.launch_counts()
    st = ins.stats
    want = {(f, lev) for lev in range(L) for f in
            ("compute_step", "flux", "time_step", "indirect_rw")}
    want |= {(f, lev) for lev in range(L - 1) for f in ("restrict",
                                                        "prolong")}
    require(set(st.calls) == want and all(st.times[k] > 0 for k in want),
            f"{what}: timed {sorted(st.calls)}")
    for function, counter in INSTRUMENTED_COUNTERS[
            ins.config.accumulate].items():
        calls = sum(n for (f, _), n in st.calls.items() if f == function)
        require(calls == counts[counter], f"{what}: {calls} {function} "
                f"calls, {counts[counter]} {counter} launches")
    log(f"{what}: {cycles} cycles, {sum(st.calls.values())} timed calls "
        f"in {st.total_time:.3f} s (host), calls equal to the launch "
        f"counts {counts}; us per call by function and level: " + ", ".join(
            f"{f}{lev} {st.times[(f, lev)] / st.calls[(f, lev)] * 1e6:.1f}"
            for f, lev in sorted(st.calls, key=lambda k: (k[1], k[0]))))
    before = [t.clone() for t in ins.state["variables"]]
    kernels.reset_launch_counts()
    m = opstats.measure_instrumented(ins, cycles=1)
    counted = by_family(kernels.launch_counts())
    seen = {}
    for rec in m.functions.values():
        for fam, n in hand_split(rec)[0].items():
            seen[fam] = seen.get(fam, 0) + n
    share = 1 - m.other["time_us"] / max(m.total_us, 1e-9)
    top = sorted(m.other["kernels"].items(), key=lambda kv: -kv[1][1])[:6]
    log(f"{what}: measure_instrumented, 1 cycle on {m.device}: "
        f"{m.total_us:.1f} us of device time, {share:.4f} of it charged to "
        f"the functions (outside them {m.other['time_us']:.1f} us in "
        f"{m.other['occurrences']} kernels, the most {top}); hand-kernel "
        f"launches by family {seen}, the counts say {counted}")
    require(seen == counted, f"{what}: measured launches by family {seen}, "
            f"the counts say {counted}")
    require(share >= MEASURED_SHARE_MIN, f"{what}: only {share:.4f} of the "
            f"device time charged to the functions")
    require(all(torch.equal(a, b) for a, b in
                zip(before, ins.state["variables"])),
            f"{what}: measure_instrumented changed the state")


def log_split(m, what: str, card_label: str) -> None:
    """A measurement's device time per (function, level): hand kernels and
    the eager PyTorch ops apart."""
    parts = []
    for (f, lev), rec in sorted(m.functions.items(),
                                key=lambda kv: (kv[0][1], kv[0][0])):
        fams, hand, eager, n = hand_split(rec)
        parts.append(f"{f}{lev} {rec['time_us']:.1f} (hand {hand:.1f} in "
                     f"{sum(fams.values())}, eager {eager:.1f} in {n})")
    log(f"{what}: device us per cycle by function and level: "
        + "; ".join(parts) + f"; outside the functions "
        f"{m.other['time_us']:.1f} in {m.other['occurrences']}; total "
        f"{m.total_us:.1f} [{card_label}]")


def monitor_phase(solver, tr, tf64, t32, box, m32, tet_input, scratch,
                  card_label: str):
    """The unfused window stage and the monitor (mgcfd_tpu_torch/monitor/)
    on the tet flagship tr, the box flagship `box` and the 32^3 tet's
    files. Returns ({dtype: unfused 'window' solver on tr}, {dtype: its
    launch counts}) for the edge_csr.flux records."""
    import torch
    from mgcfd_tpu_torch.cli.main import main as cli_main
    from mgcfd_tpu_torch.core.config import SolverConfig
    from mgcfd_tpu_torch.kernels import edge_csr
    from mgcfd_tpu_torch.monitor import InstrumentedSolver, csvout, opstats
    t0 = time.perf_counter()
    unfused, runs = {}, {}
    for dt in ("float64", "float32", "bfloat16"):
        u = solver(tr, dt, "window", fuse_window_stage=False)
        W0 = u.dmesh.levels[0]
        q = random_state(W0.num_nodes, 90, u.dtype, W0.volumes.device)
        check_cases([("edge_csr.flux tet flagship L0",
                      edge_csr.flux(W0.csr, q),
                      edge_csr.edge_csr_plain("flux", W0.csr, q))], u.dtype)
        runs[dt] = counted_run(u, 2, f"tet flagship {dt} unfused window",
                               WANT_WINDOW_UNFUSED)
        unfused[dt] = u
    same_as_plain(unfused["float64"], tf64, tr,
                  "tet flagship fp64 unfused window against the fused one")
    for mesh, what, cycles in ((tr, "tet flagship", 2), (box, "box", 2)):
        ins = InstrumentedSolver(mesh, SolverConfig(dtype="float32"))
        log(f"instrumented {what} fp32: accumulate={ins.config.accumulate}")
        check_instrumented(ins, f"instrumented {what} fp32", cycles)
        healthy(ins, f"instrumented {what} fp32")
    for s_, what in ((t32, "tet flagship RCM 'window' fp32"),
                     (m32, "box 'pallas' fp32")):
        before = [t.clone() for t in s_.state["variables"]]
        m = opstats.measure_production(s_, cycles=1)
        log_split(m, f"measure_production {what}, 1 cycle of run",
                  card_label)
        require(all(torch.equal(a, b) for a, b in
                    zip(before, s_.state["variables"])),
                f"{what}: measure_production changed the state")
    out = scratch / "monitor"
    conf = scratch / "events.conf"
    conf.write_text("# the cost file's events\nCALLS\nMODEL_BYTES\n"
                    "MODEL_OPERATIONS\n")
    require(cli_main(["-i", tet_input, "--renumber", "--monitor",
                      "instrumented", "-o", f"{out}/", "--measure-ops",
                      "-p", str(conf), "-g", "2"]) == 0,
            "the CLI's monitor failed on the tet's files")
    ident = csvout.ID_COLUMNS
    cols = [f"{k}{lev}" for lev in range(3) for k in csvout.KERNEL_COLUMNS]
    for fname, extra, tail in (("Times.csv", [], ["Total"]),
                               ("LoopNumIters.csv", [], []),
                               (csvout.COSTS_FILE, ["Event"], [])):
        lines = (out / fname).read_text().splitlines()
        got = lines[0].split(",")[:-1]
        require(got == ident + ["ThreadNum", "CpuId"] + extra + cols + tail,
                f"CLI monitor: {fname} header {got}")
        log(f"CLI monitor: {fname}: {len(lines) - 1} rows, header of "
            f"{len(got)} columns as the reference's")
    log(f"monitor phase: {time.perf_counter() - t0:.1f} s (watchdog "
        f"{WATCHDOG_S} s)")
    return unfused, runs


def snapshot(solver):
    """A solver's state (cloned), RMS history and cycle count."""
    return ({k: [t.clone() for t in v] for k, v in solver.state.items()},
            list(solver.rms_history), solver.completed_cycles)


def restore(solver, snap) -> None:
    st, rms, done = snap
    solver.state = {k: [t.clone() for t in v] for k, v in st.items()}
    solver.rms_history, solver.completed_cycles = list(rms), done


def same_state(a, b, what: str) -> None:
    """Two solvers' states bit-equal on every level, the RMS histories
    equal."""
    import torch
    for key in ("variables", "residuals"):
        for lev, (x, y) in enumerate(zip(a.state[key], b.state[key])):
            require(torch.equal(x, y), f"{what}: {key} of level {lev} "
                    "differ")
    require(a.rms_history == b.rms_history, f"{what}: RMS {a.rms_history} "
            f"!= {b.rms_history}")


def device_plans(s) -> dict:
    """Every plan tensor a solver uploaded, by (level, plan, field)."""
    out = {}
    for i, lv in enumerate(s.dmesh.levels):
        for name in ("csr", "spill_csr", "restrict_csr", "prolong_csr"):
            plan = getattr(lv, name)
            if plan is not None:
                for f in ("row_ptr", "col", "owner", "w"):
                    out[(i, name, f)] = getattr(plan, f)
        if lv.restrict_mapped is not None:
            out[(i, "restrict_mapped")] = lv.restrict_mapped
    return out


def options_phase(solver, box, m32, p64, tr, tf64, t32, tet_input, scratch,
                  card_label: str) -> float:
    """The reference's kernel variants, checkpoints, dumps, -v and the
    capacity legs (module docstring, phase 14) on the box flagship `box`
    (m32: its 'pallas' fp32 solver; p64: its fp64 'segment' solver after
    2 cycles), the tet flagship tr (tf64: fp64 'window' after 2 cycles;
    t32: fp32 'window') and the 32^3 tet's files. Every tet flagship
    solver here builds its plans through one plan cache. Returns the
    phase's seconds."""
    import contextlib
    import io
    import numpy as np
    import torch
    from mgcfd_tpu_torch.cli.main import main as cli_main
    from mgcfd_tpu_torch.monitor import opstats
    from mgcfd_tpu_torch.utils import spans
    from mgcfd_tpu_torch.validate import capacity
    t0 = time.perf_counter()
    plans = str(scratch / "plans")

    # a. mg_gather=False: the plain scatter transfers in place of wsum
    g64 = solver(tr, "float64", "window", mg_gather=False,
                 plan_cache_dir=plans)
    counted_run(g64, 2, "tet flagship fp64 'window' mg_gather=False",
                WANT_NO_GATHER)
    same_as_plain(g64, tf64, tr, "tet flagship fp64 mg_gather=False "
                  "against the wsum transfers")
    # the plain transfers' index_add_ sums with float atomics unless torch
    # is asked for its deterministic index_add, which both runs take
    a, b = (solver(tr, "float32", "window", mg_gather=False,
                   plan_cache_dir=plans) for _ in range(2))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        counts_a, _ = counted_run(a, BATCH_K, "tet flagship fp32 "
                                  "mg_gather=False run", WANT_NO_GATHER)
        counts_b, _ = counted_batched(b, BATCH_K, BATCH_K, "tet flagship "
                                      "fp32 mg_gather=False")
    finally:
        torch.use_deterministic_algorithms(was)
    require(counts_a == counts_b, f"mg_gather=False: run_batched launched "
            f"{counts_b}, run {counts_a}")
    same_state(a, b, "tet flagship fp32 mg_gather=False run_batched "
               "against run")
    log(f"tet flagship fp32 mg_gather=False: run_batched({BATCH_K}, "
        f"{BATCH_K}) == run({BATCH_K}) bit for bit (torch's deterministic "
        f"index_add_ on both)")

    # b. flux_cripple: the crippled twin runs and changes nothing
    for base, what, kw in ((m32, "box 'pallas' fp32", {}),
                           (t32, "tet flagship 'window' fp32",
                            {"plan_cache_dir": plans})):
        c = solver(base.mesh, "float32", base.config.accumulate,
                   flux_cripple=True, **kw)
        snap = snapshot(base)
        restore(c, snap)
        counts, _ = counted_run(base, 2, f"{what} without the twin")
        counts_c, _ = counted_run(c, 2, f"{what} flux_cripple")
        require(counts == counts_c, f"{what}: flux_cripple launched "
                f"{counts_c}, without it {counts}")
        same_state(base, c, f"{what}: flux_cripple")
        restore(base, snap)
        m = opstats.measure_production(c, cycles=1)
        require(m.other["occurrences"] > 0, f"{what}: the twin ran no "
                "kernel outside the functions")
        log(f"{what} flux_cripple: every level bit-equal to the run "
            f"without it, launches equal {by_family(counts)}; the crippled "
            f"twin {m.other['time_us']:.1f} us of device time a cycle in "
            f"{m.other['occurrences']} kernels, outside every function "
            f"(measure_production) [{card_label}]")

    # c. the edge-stream variants against 'segment' (p64) after the same 2
    # cycles, then timed, with 'segment' timed before and after them
    variants = []
    for kw in ({"accumulate": "scatter"}, {"accumulate": "ell"},
               {"accumulate": "segment", "flux_fission": True},
               {"accumulate": "segment",
                "flux_precompute_edge_weights": True}):
        v = solver(box, "float64", **kw)
        v.run(2)
        same_as_plain(v, p64, box, f"box fp64 {kw} against 'segment'")
        variants.append((v, f"box fp64 {kw}"))
    seg = (p64, "box fp64 {'accumulate': 'segment'}")
    for v, what in [seg, *variants, seg]:
        variant_ms(v, what, card_label)

    # d. checkpoints and resume, and the plan cache's second build
    ck = str(scratch / "checkpoints")
    t1 = time.perf_counter()
    spans.reset()
    first = solver(tr, "float32", "window", checkpoint_dir=ck,
                   checkpoint_every=1, plan_cache_dir=plans)
    first_s, first_stats = time.perf_counter() - t1, spans.counters("plans.")
    first.run(2)
    t1 = time.perf_counter()
    spans.reset()
    resumed = solver(tr, "float32", "window", checkpoint_dir=ck,
                     resume=True, plan_cache_dir=plans)
    second_s = time.perf_counter() - t1
    want_plans = {"torch-flux": 4, "torch-restrict": 3, "torch-prolong": 3}
    require(spans.counters("plans.loaded.") == want_plans
            and not spans.counters("plans.built."),
            f"the second build did not load every plan from the cache: "
            f"{spans.counters('plans.')}")
    p1, p2 = device_plans(first), device_plans(resumed)
    require(p1.keys() == p2.keys() and all(torch.equal(p1[k], p2[k])
                                           for k in p1),
            "plans loaded from the cache differ from the built ones")
    log(f"tet flagship 'window' fp32 solver build through the plan cache: "
        f"{first_s:.2f} s ({first_stats}), then {second_s:.2f} s loading "
        f"all {len(p2)} plan arrays, equal (host)")
    require(resumed.completed_cycles == 2
            and resumed.rms_history == first.rms_history,
            f"resumed at cycle {resumed.completed_cycles}, RMS "
            f"{resumed.rms_history} against {first.rms_history}")
    first.run(1)
    resumed.run(1)
    same_state(first, resumed, "tet flagship fp32 resumed at cycle 2")
    log(f"tet flagship fp32 'window': run(2) with a checkpoint a cycle, "
        f"then a new solver resumed from ckpt-000002 and run(1) == run(3) "
        f"bit for bit on every level, RMS history equal "
        f"{resumed.rms_history}")

    # e. the CLI's -c, --output-variables and -v on the 32^3 tet's files,
    # and the capacity criterion on the box flagship
    files = Path(tet_input).parent
    conf = files / "smoke.conf"
    conf.write_text("# chip_smoke.py\ninput_file = input.dat\n"
                    "input_file_directory = ./\ncycles = 2\n"
                    "dtype = float64\n")
    out = scratch / "cli"
    cli = ["-c", str(conf), "--renumber", "--plan-cache",
           str(scratch / "plans32")]
    require(cli_main(cli + ["--output-variables", "-o", f"{out}/"]) == 0,
            "the CLI's dump failed")
    name = "variables.size=1x.cycles=2.level=0"
    sol = files / f"solution.{name}"
    shutil.copy(out / name, sol)

    def validate():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(cli + ["-v"])
        return rc, buf.getvalue()

    rc, text = validate()
    require(rc == 0 and "PASS: variables[] validated successfully" in text,
            f"-v against the port's own fp64 dump: rc {rc}\n{text}")
    v = np.loadtxt(sol)
    v[100, 4] *= 1 + 1e-6
    np.savetxt(sol, v, fmt="%.17e")
    rc_bad, text_bad = validate()
    require(rc_bad == 1 and "Validation of variables[] failed" in text_bad,
            f"-v against a perturbed solution: rc {rc_bad}\n{text_bad}")
    log(f"CLI -c FILE --output-variables, then -v: PASS, exit 0; against "
        f"a perturbed solution file: exit 1 "
        f"({text_bad.strip().splitlines()[-1][:100]})")
    verdict = capacity.acceptance(box, plan_cache_dir=plans)
    require(verdict["accepted"], f"capacity criterion: {verdict}")
    log(f"capacity.acceptance on the box flagship (fp32 auto, fp64 "
        f"'segment'): accepted, max rel {verdict['max_rel_fp32_vs_fp64']:.3e}"
        f" (tol {verdict['tol']:.0e}), RMS fp32 {verdict['rms_fp32']} fp64 "
        f"{verdict['rms_fp64']}")
    secs = time.perf_counter() - t0
    log(f"options phase: {secs:.1f} s (watchdog {WATCHDOG_S} s)")
    return secs


def variant_ms(solver, what: str, card_label: str) -> float:
    """ms per cycle of `solver` through run: CUDA events over 5 cycles
    after a warm one."""
    import torch
    solver.run(1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    solver.run(5)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    log(f"variant {what}: {ms:.3f} ms a cycle through run (CUDA events "
        f"over 5 cycles after 1) [{card_label}]")
    return ms


def flux_records(u, run, card_label: str):
    """The record of edge_csr.flux over level 0's whole owner CSR of an
    unfused 'window' solver on the tet flagship (name suffixed .tet),
    timed as kernel_records times them; launches from its counted run;
    every flux shape's time and share under "shapes"."""
    from mgcfd_tpu_torch.kernels import edge_csr
    from mgcfd_tpu_torch.monitor.costs import edge_csr_cost
    W0 = u.dmesh.levels[0]
    q = u.state["variables"][0]
    rows = [("edge_csr.flux", "edge_csr", "unfused",
             lambda: edge_csr.flux(W0.csr, q),
             lambda: edge_csr.edge_csr_plain("flux", W0.csr, q), None,
             *edge_csr_cost("flux", W0.csr, q.element_size()))]
    recs = time_rows(rows, {"unfused": run}, u.dtype,
                     launch_floor_ms(q.device), card_label, ".tet")
    recs[0]["shapes"] = flux_shape_times(
        W0.csr, q, None, recs[0]["bound_ms"], "tet flagship L0",
        card_label)
    return recs




def want_sharded(levels: int) -> dict:
    """Launches per cycle of the sharded solver at shard_levels=1
    ('window') on a mesh of `levels` levels: the V-cycle visits level 0
    and the coarsest once, the others twice; level 0's 3 RK stages
    through edge_csr.flux and rw over each rank's owner CSR, the
    replicated levels' through fused_stage and rw and their step factors
    through step_factor (level 0's is the sharded solver's own); a
    restriction and a prolongation a coarse level."""
    visits = 2 * levels - 2
    return {"edge_csr.flux": 3, "edge_csr.rw": 3 * visits,
            "fused_stage": 3 * (visits - 1),
            "step_factor": 2 * (visits - 1),
            "edge_csr.wsum.restrict": levels - 1,
            "edge_csr.wsum.prolong": levels - 1}


# the 4-level tet flagship's: 3 edge_csr.flux, 18 rw, 15 fused_stage, 10
# step_factor and 3 of each transfer
WANT_SHARDED = want_sharded(4)
# the sharded solver against the single-device port at fp64: every value
# within this relative difference (mgcfd_tpu's tests/test_parallel.py
# holds its sharded solver to rtol 1e-10 with multigrid)
SHARDED_REL = 1e-10
# the PR 10 Python read of the tet flagship's files, host seconds on the
# H100 machine (chip_smoke.py's phase 12 then; PERF.md)
PYTHON_READ_PR10_S = 12.4


def _share_rank(rank, mesh, cfg_kw: dict, cycles: int, out: str) -> None:
    """One gloo rank of several on card 0 (parallel/launch.py): `cycles`
    cycles of ShardedSolver, launches counted; rank 0 writes every level's
    variables, the RMS, the separator size and its counts."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from mgcfd_tpu_torch import kernels
    from mgcfd_tpu_torch.core.config import SolverConfig
    from mgcfd_tpu_torch.parallel import ShardedSolver
    s = ShardedSolver(mesh, SolverConfig(
        **cfg_kw, num_partitions=dist.get_world_size()))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(cycles)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    vs = [s.variables(lev) for lev in range(mesh.num_levels)]
    if rank == 0:
        np.savez(out, *vs, rms=np.asarray(s.rms_history), secs=secs,
                 sep=float(s.smesh.level0.sep_mask.sum()),
                 sharded=len(s.smesh.levels), acc=s.config.accumulate,
                 counts=json.dumps(counts))


def _cli_rank(rank, argv: list) -> None:
    """One gloo rank on card 0 running the CLI inside the process group."""
    from mgcfd_tpu_torch.cli.main import main as cli_main
    rc = cli_main(argv)
    if rc:
        sys.exit(rc)


def sharded_phase(solver, tr, ts, tf64, tet_input, secs, scratch,
                  card_label: str):
    """Phase 15 (module docstring): the native parser and the sharded
    solver (parallel/) at full width on the tet flagship tr (ts: in the
    generator's order; tf64: tr's fp64 'window' single-device solver after
    2 cycles; secs: the child's host seconds). Returns (the sharded level 0's edge_csr.flux record,
    its run_batched timing, the phase's seconds)."""
    import shutil as sh
    import numpy as np
    import torch
    import torch.distributed as dist
    from mgcfd_tpu_torch.cli.main import main as cli_main
    from mgcfd_tpu_torch.core.config import SolverConfig
    from mgcfd_tpu_torch.kernels import DeviceCSR, edge_csr
    from mgcfd_tpu_torch.mesh import load_multigrid_mesh
    from mgcfd_tpu_torch.monitor.costs import edge_csr_cost
    from mgcfd_tpu_torch.native import native_available
    from mgcfd_tpu_torch.parallel import ShardedSolver, comm, partition
    from mgcfd_tpu_torch.parallel.launch import run_ranks
    from mgcfd_tpu_torch.parallel.sharded import conditioned
    from mgcfd_tpu_torch.utils import spans
    t0 = time.perf_counter()
    plans = str(scratch / "plans")

    # a. the native parser: the child's read of the flagship, and the
    # 32^3 tet's files through both readers
    require(native_available(), "the native mesh parser did not build")
    require(secs["reader"] == "native", f"the tet flagship's files were "
            f"read by the {secs['reader']} reader")
    log(f"tet flagship files parsed by the native parser in "
        f"{secs['parse_s']:.2f} s, no sidecar written (host, the child "
        f"process; PR 10's Python read: {PYTHON_READ_PR10_S} s) "
        f"[{card_label}]")
    before = spans.counters().get("mesh.reads.native", 0)
    t1 = time.perf_counter()
    nat = load_multigrid_mesh(tet_input, use_cache=False, use_native=True)
    t2 = time.perf_counter()
    py = load_multigrid_mesh(tet_input, use_cache=False, use_native=False)
    t3 = time.perf_counter()
    require(spans.counters().get("mesh.reads.native", 0) - before
            == nat.num_levels,
            "the 32^3 tet's levels did not all go through the native parser")
    same_arrays(nat, py, "32^3 tet: native parser against the Python reader")
    log(f"32^3 tet files: native parser {t2 - t1:.3f} s, Python reader "
        f"{t3 - t2:.3f} s (host), every level's arrays equal "
        f"[{card_label}]")

    # b. one NCCL rank at full width on the tet flagship
    require(tf64.completed_cycles == 2, "the fp64 reference is not at "
            "cycle 2")
    comm.init_process_group(0, 1, f"file://{scratch}/nccl_store",
                            torch.device("cuda", 0))
    try:
        def sharded(dtype, **kw):
            s = ShardedSolver(tr, SolverConfig(
                dtype=dtype, num_partitions=1, plan_cache_dir=plans, **kw))
            log(f"sharded solver ready: {tr.name} {dtype} P=1 "
                f"{s.comm.backend} accumulate -> {s.config.accumulate}, "
                f"{s.S} sharded level(s), level-0 block {s.shards[0].B} "
                f"rows, CSR {s.shards[0].dev.csr.num_entries} entries")
            return s

        s64 = sharded("float64")
        require(s64.config.accumulate == "window", "auto did not take "
                "'window' on the tet flagship")
        counted_run(s64, 2, "tet flagship sharded P=1 NCCL fp64",
                    WANT_SHARDED)
        close_to(s64, tf64, tr.num_levels, "tet flagship sharded P=1 fp64")
        s32 = sharded("float32")
        counts, pc = counted_run(s32, 2, "tet flagship sharded P=1 fp32",
                                 WANT_SHARDED)
        healthy(s32, "tet flagship sharded P=1 fp32")
        batched_equals_run(lambda: sharded("float32"),
                           "tet flagship sharded P=1 fp32", WANT_SHARDED)
        timing = batched_timing(s32, "tet flagship RCM sharded P=1 NCCL "
                                "'window' fp32", card_label)
        # level 0's flux kernel over the [block | pool] operand the cycle
        # gathers (the gather itself is not timed)
        csr0 = s32.shards[0].dev.csr
        q = s32.state["variables"][0]
        comb = s32._exchange(s32.shards[0], q)
        rows = [("edge_csr.flux", "edge_csr", "sharded",
                 lambda: edge_csr.flux(csr0, comb, q),
                 lambda: edge_csr.edge_csr_plain("flux", csr0, comb, q),
                 None, *edge_csr_cost("flux", csr0, q.element_size()))]
        records = time_rows(rows, {"sharded": (counts, pc)}, s32.dtype,
                            launch_floor_ms(q.device), card_label,
                            ".sharded_tet")
        records[0]["shapes"] = flux_shape_times(
            csr0, comb, q, records[0]["bound_ms"], "sharded level 0 P=1",
            card_label)
    finally:
        dist.destroy_process_group()

    # c. gloo ranks that share the card: correctness legs, no collective
    # of the card is measured here. 2 ranks run the tet flagship, 4 the
    # 32^3 tet (their set-up is host time that grows with the mesh: 4
    # ranks on the flagship took 42.5 s of a 397 s run in PR 13's call
    # f1, against the 480 s watchdog)
    nat.name = "tet 32^3"
    small = solver(nat, "float64", "window")
    small.run(2)
    for P, share_mesh, ref in ((2, tr, tf64), (4, nat, small)):
        # the partitions through the plan cache once, for every rank
        partition.partition_mesh(conditioned(share_mesh), P,
                                 plan_cache_dir=plans)
        out = str(scratch / f"share{P}.npz")
        t4 = time.perf_counter()
        run_ranks(_share_rank, P, (share_mesh, {
            "dtype": "float64", "accumulate": "window",
            "plan_cache_dir": plans}, 2, out), share_card=True,
                  timeout_s=240)
        with np.load(out) as z:
            got = dict(z.items())
        require(float(got["sep"]) > 0, f"{P} ranks: no separator")
        pcs = {k: v / 2 for k, v in json.loads(str(got["counts"])).items()}
        want = want_sharded(share_mesh.num_levels)
        want = {k: want.get(k, 0) for k in pcs.keys() | want.keys()}
        require({k: pcs.get(k, 0) for k in want} == want, f"{P} ranks: "
                f"rank 0's launches per cycle {pcs} != {want}")
        for lev in range(share_mesh.num_levels):
            rel = close_arrays(got[f"arr_{lev}"], ref.variables(lev))
            require(rel <= SHARDED_REL, f"{P} gloo ranks level {lev}: "
                    f"relative difference {rel:.3e}")
        log(f"{share_mesh.name} over {P} gloo ranks sharing the card, fp64 "
            f"'window', 2 cycles: every level within {SHARDED_REL:.0e} of "
            f"the single-device port; separator {float(got['sep']):.0f} "
            f"nodes; rank 0's launches per cycle {pcs}; 2 cycles in "
            f"{float(got['secs']):.2f} s on rank 0 (host clock, a "
            f"correctness leg: gloo copies every collective through host "
            f"memory, no collective of the card is measured); the leg took "
            f"{time.perf_counter() - t4:.1f} s")

    # d. edge_csr.flux over rank 0's level-0 [block | pool] CSR at each P,
    # in RCM and in the generator's shuffled order: a kernel timing of the
    # card alone (random states, no collective)
    dev = tf64.dmesh.levels[0].volumes.device
    for label, m in (("RCM", tr), ("shuffled", ts)):
        lvl = conditioned(m).levels[0]
        for P in (1, 2, 4):
            sl = partition.partition_level(lvl, P)
            csr = DeviceCSR.from_plan(partition.shard_flux_csr(lvl, sl, 0),
                                      dev, torch.float32)
            comb = random_state(csr.num_cols, 90 + P, torch.float32, dev)
            own = comb[:, :csr.num_rows].contiguous()
            what = f"shard 0 of {P} ({label})"
            check_flux_shapes(csr, comb, own, what)
            if label == "RCM" and P > 1:
                # at bfloat16 too: a shard's CSR may hold an odd entry
                # count (2,261,087 at P = 2), whose weight rows 1 and 3 the
                # tile stages entry by entry (csr_tile.cuh stage_chunk)
                bcsr = DeviceCSR.from_plan(
                    partition.shard_flux_csr(lvl, sl, 0), dev, torch.bfloat16)
                bcomb = comb.to(torch.bfloat16)
                parity = "odd" if csr.num_entries % 2 else "even"
                check_flux_shapes(bcsr, bcomb,
                                  bcomb[:, :csr.num_rows].contiguous(),
                                  f"{what}, {parity} entry count")
            nbytes, nops = edge_csr_cost("flux", csr, 4)
            bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOP_PER_S)
            times = flux_shape_times(csr, comb, own, bound * 1e3, what,
                                     card_label)
            shape = edge_csr.FLUX_SHAPES[edge_csr.flux.shape(csr)]
            us = times[shape]["ms"] * 1e3
            log(f"edge_csr.flux, tet flagship level 0 {label}, shard 0 of "
                f"{P}: {csr.num_rows} rows, {sl.P * sl.smax} pool columns, "
                f"{csr.num_entries} entries: {us:.1f} us a launch ({shape}),"
                f" bound {bound * 1e6:.1f} us (bytes {nbytes / 1e6:.1f} MB), "
                f"share {bound * 1e6 / us:.2f} fp32 [{card_label}]")

    # e. the CLI: --partitions 4 --partition-2d auto --shard-levels 2 on
    # the 32^3 tet's files in 4 gloo ranks on the card, -v against the
    # single-device CLI's fp64 dump
    files = scratch / "tet32_sharded"
    files.mkdir()
    for f in Path(tet_input).parent.iterdir():
        if f.is_file():
            sh.copy(f, files / f.name)
    base = ["-i", str(files / "input.dat"), "-g", "2", "--dtype", "float64"]
    require(cli_main(base + ["--output-variables", "-o",
                             f"{scratch}/cli_single/"]) == 0,
            "the single-device CLI failed on the 32^3 tet")
    name = "variables.size=1x.cycles=2.level=0"
    sh.copy(scratch / "cli_single" / name, files / f"solution.{name}")
    argv = base + ["-d", str(files), "--partitions", "4", "--partition-2d",
                   "auto", "--shard-levels", "2", "-v"]
    t5 = time.perf_counter()
    run_ranks(_cli_rank, 4, (argv,), share_card=True, timeout_s=240)
    log(f"CLI {' '.join(argv[4:])} over 4 gloo ranks on the card: -v PASS "
        f"against the single-device CLI's dump ({time.perf_counter() - t5:.1f}"
        f" s, host)")
    secs_phase = time.perf_counter() - t0
    log(f"phase 15 (native parser, sharded solver) took {secs_phase:.1f} s; "
        f"the run has spent {time.perf_counter() - T0:.1f} s of the "
        f"{WATCHDOG_S} s watchdog")
    return records, timing, secs_phase


def close_arrays(got, want) -> float:
    """max |got - want| / |want| over the elements (the state is O(1) and
    never near zero: density, energy and the far-field momentum)."""
    import numpy as np
    scale = np.maximum(np.abs(want), np.abs(want).max(axis=0) * 1e-3)
    return float((np.abs(got - want) / scale).max())


def close_to(a, b, levels: int, what: str) -> None:
    """Two solvers' every level within SHARDED_REL (close_arrays), RMS
    histories too."""
    import numpy as np
    rels = [close_arrays(a.variables(lev), b.variables(lev))
            for lev in range(levels)]
    rms = close_arrays(np.asarray(a.rms_history), np.asarray(b.rms_history))
    require(max(rels) <= SHARDED_REL and rms <= SHARDED_REL,
            f"{what}: relative differences {rels}, RMS {rms}")
    log(f"{what}: every level within {SHARDED_REL:.0e} of the single-device "
        f"port (relative differences {rels}; RMS {rms:.2e})")


def start_tet_flagship(here: Path, scratch: Path):
    """Generate, renumber, write and parse the tet flagship in a child
    process (bench/tet_flagship.py), so that its minutes of host time
    overlap the box phases. Returns (process, its output directory)."""
    out = scratch / "tet_flagship"
    proc = subprocess.Popen(
        [sys.executable, "-m", "mgcfd_tpu_torch.bench.tet_flagship",
         "--out", str(out)], cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out


def finish_tet_flagship(job):
    """Wait for the child, load the hierarchy from its files through the
    npz cache it filled, and renumber it (RCM). Returns (the RCM-ordered
    mesh, the generator-ordered one, the child's JSON line of host
    seconds plus those of the cached load and of RCM)."""
    from mgcfd_tpu_torch.bench.tet_flagship import input_path
    from mgcfd_tpu_torch.mesh import load_multigrid_mesh
    from mgcfd_tpu_torch.prep.renumber import renumber_hierarchy
    proc, out = job
    left = WATCHDOG_S - (time.perf_counter() - T0)
    stdout, stderr = proc.communicate(timeout=max(1.0, left))
    require(proc.returncode == 0, f"tet flagship generation failed "
            f"(rc {proc.returncode}):\n{stderr[-2000:]}")
    secs = json.loads(stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    shuffled = load_multigrid_mesh(input_path(str(out)))
    t1 = time.perf_counter()
    rcm = renumber_hierarchy(shuffled)
    secs.update(cached_load_s=t1 - t0, renumber_s=time.perf_counter() - t1)
    shuffled.name, rcm.name = "tet-flagship-shuffled", "tet-flagship-rcm"
    return rcm, shuffled, secs


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
    scratch = Path(tempfile.mkdtemp(prefix="mgcfd_smoke_"))
    job = start_tet_flagship(here, scratch)
    try:
        return smoke(job, scratch)
    finally:
        if job[0].poll() is None:
            job[0].kill()
            job[0].communicate()
        # the ranks' forkserver and resource tracker would otherwise
        # outlive this process for a while
        from mgcfd_tpu_torch.parallel.launch import stop_servers
        stop_servers()
        shutil.rmtree(scratch, ignore_errors=True)


def smoke(tet_job, scratch: Path) -> int:
    """Every phase in order (module docstring); raises on a failed check."""
    import torch
    from mgcfd_tpu_torch.bench import FLAGSHIP_SPEC, flagship_mesh
    from mgcfd_tpu_torch.cli.main import main as cli_main
    from mgcfd_tpu_torch.core.config import SolverConfig
    from mgcfd_tpu_torch.core.constants import MeshVariant
    from mgcfd_tpu_torch.kernels import build, edge_csr
    from mgcfd_tpu_torch.mesh import (generate_unstructured_hierarchy,
                                      load_multigrid_mesh,
                                      write_multigrid_mesh)
    from mgcfd_tpu_torch.prep.renumber import (locality_stats,
                                               renumber_hierarchy)
    from mgcfd_tpu_torch.prep.shift import build_shift_plan
    from mgcfd_tpu_torch.solver import MGCFDSolver
    from mgcfd_tpu_torch.solver import solver as solver_mod

    # no matrix product or convolution runs in fp32 on the paths timed
    # here; keep any that might at full fp32 all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, smi = card()
    log(f"device: {name} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    path, secs = build.build()
    log(f"built {path.name} with nvcc (a process a source, in parallel, "
        f"then one link) in {secs:.1f} s")
    refuse_unknown_dtype(build.library())

    def solver(mesh, dtype, accumulate="auto", **kw):
        s = MGCFDSolver(mesh, SolverConfig(dtype=dtype,
                                           accumulate=accumulate, **kw))
        log(f"solver ready: {mesh.name} {mesh.variant.name} {dtype} "
            f"accumulate={accumulate} -> {s.config.accumulate} {kw or ''}")
        return s

    mesh = flagship_mesh()
    lv0 = mesh.levels[0]
    log(f"box flagship: {lv0.num_nodes} nodes, {lv0.num_internal_edges} "
        f"internal edges, {mesh.num_levels} levels")
    m64, m32, m16 = (solver(mesh, dt) for dt in
                     ("float64", "float32", "bfloat16"))
    require(m64.config.accumulate == m32.config.accumulate
            == m16.config.accumulate == "pallas",
            "auto did not take the span kernels on the box flagship")
    log("span plans: " + "; ".join(
        f"L{i} spans {lv.shift.deltas} spill "
        f"{0 if lv.spill_csr is None else lv.spill_csr.num_entries // 2}"
        for i, lv in enumerate(m64.dmesh.levels)))
    w64, w32, w16 = (solver(mesh, dt, "window") for dt in
                     ("float64", "float32", "bfloat16"))

    check_csr_kernels((w64, w32, w16))
    check_step_factor((w64, w32, w16))
    for w in (w64, w32, w16):
        check_rw(w, "box flagship")
        check_flux(w, "box flagship")
    check_shift_kernels((m64, m32, m16))
    tmesh = generate_unstructured_hierarchy(32, 32, 32, 3, seed=0)
    check_stage_shapes(mesh, tmesh, (torch.float64, torch.float32,
                                     torch.bfloat16),
                       m64.dmesh.levels[0].volumes.device)

    # --- fp64: both kernel paths and the unfused span path against the
    # plain path, launches counted ---
    p64 = solver(mesh, "float64", "segment")
    p64.run(2)
    runs64 = {"main": counted_run(m64, 2, "main path ('pallas') fp64",
                                  WANT_MAIN)}
    same_as_plain(m64, p64, mesh, "box fp64 'pallas', 2 cycles")
    runs64["window"] = counted_run(w64, 2, "window path fp64", WANT_WINDOW)
    same_as_plain(w64, p64, mesh, "box fp64 'window', 2 cycles")
    u64 = solver(mesh, "float64", "pallas", fuse_stage=False)
    runs64["unfused"] = counted_run(u64, 2, "unfused span path fp64",
                                    WANT_UNFUSED)
    same_as_plain(u64, p64, mesh, "box fp64 'pallas' unfused, 2 cycles")

    # --- fp32 and bf16, timed, launches counted: the main path, then
    # 'window'; bf16 launches as many kernels per cycle as fp32 ---
    cycle_ms = {}
    runs32, runs16 = {}, {}
    for s_main, s_win, runs in ((m32, w32, runs32), (m16, w16, runs16)):
        tag = TAGS[str(s_main.dtype)]
        for path, s_, want in (("main", s_main, WANT_MAIN),
                               ("window", s_win, WANT_WINDOW)):
            counts, pc, ms, v2 = timed_run(s_, f"{path} path "
                                           f"('{s_.config.accumulate}') "
                                           f"{tag}")
            full = {k: want.get(k, 0) for k in counts}
            require(pc == full, f"{path} {tag} launches per cycle {pc} "
                    f"!= {full}")
            runs[path] = (counts, pc)
            cycle_ms[(s_.config.accumulate, tag)] = ms
            healthy(s_, f"box {tag} '{s_.config.accumulate}'")
            if tag == "fp32":
                ref = m64 if path == "main" else w64
                cap = capacity_rel(v2, ref.variables(0))
                log(f"box fp32 '{s_.config.accumulate}' vs fp64 after 2 "
                    f"cycles: capacity max rel {cap:.3e} (tol "
                    f"{CAPACITY_TOL:.0e}); fp32 RMS {s_.rms_history}")
                require(cap <= CAPACITY_TOL, f"fp32 vs fp64 {cap:.3e}")
    u16 = solver(mesh, "bfloat16", "pallas", fuse_stage=False)
    runs16["unfused"] = counted_run(u16, 2, "unfused span path bf16",
                                    WANT_UNFUSED)
    healthy(u16, "box bf16 'pallas' unfused")

    # --- run_batched (a CUDA graph of K cycles) against run ---
    for dt, acc, want in (("float32", "auto", WANT_MAIN),
                          ("bfloat16", "auto", WANT_MAIN),
                          ("float32", "window", WANT_WINDOW)):
        batched_equals_run(functools.partial(solver, mesh, dt, acc),
                           f"box {dt} '{acc}'", want)
    batched_equals_run(functools.partial(solver, mesh, "float64", "segment"),
                       "box float64 'segment'", exact=False)

    # --- the reference's files: write, parse, then the npz cache ---
    t0 = time.perf_counter()
    box_input = write_multigrid_mesh(str(scratch / "box"), mesh)
    t1 = time.perf_counter()
    cold = load_multigrid_mesh(box_input)
    t2 = time.perf_counter()
    cached = load_multigrid_mesh(box_input)
    t3 = time.perf_counter()
    for what, got in (("parsed", cold), ("cached", cached)):
        same_arrays(got, mesh, f"box flagship {what} from .dat files")
    log(f"box flagship as .dat/.mg/input.dat: write {t1 - t0:.2f} s, "
        f"parse {t2 - t1:.2f} s, cached load {t3 - t2:.2f} s (host)")
    f32 = solver(cold, "float32")
    f32.run(2)
    require(f32.config.accumulate == "pallas"
            and f32.rms_history == m32.rms_history[:2],
            f"box from files: RMS {f32.rms_history} against the generated "
            f"mesh's {m32.rms_history[:2]}")
    log(f"box flagship from files through auto ('pallas') fp32, 2 cycles: "
        f"RMS {f32.rms_history} == the generated mesh's")

    # --- the same box undamped, from a perturbed state ---
    umesh = flagship_mesh(dataclasses.replace(FLAGSHIP_SPEC,
                                              variant=MeshVariant.FVCORR))
    ustart = perturbed_state(umesh, seed=11)
    up64 = solver(umesh, "float64", "segment")
    up16 = solver(umesh, "bfloat16", "segment")
    for u in (up64, up16):
        u.load_state(ustart)
        u.run(2)
    moved = float(abs(up64.variables(0) - ustart["variables"][0]).max())
    log(f"undamped box (FVCORR) from the far field with {PERTURBATION} "
        f"relative noise, 2 cycles: max change of a variable {moved:.3e}")
    require(moved > 1e-2, "the undamped box did not move")
    bf16_tracks_fp64(up16, up64, "undamped box bf16 plain ('segment')")
    for mode in ("pallas", "window"):
        k64, k32, k16 = (solver(umesh, dt, mode) for dt in
                         ("float64", "float32", "bfloat16"))
        for u in (k64, k32, k16):
            u.load_state(ustart)
            _, pc = counted_run(u, 2, f"undamped box {TAGS[str(u.dtype)]} "
                                f"'{mode}'")
            require(pc["step_factor"] == 6, f"undamped box '{mode}' "
                    f"{u.dtype}: {pc['step_factor']} step_factor launches a "
                    "cycle, not 6 (the legacy variant's one a visit)")
        same_as_plain(k64, up64, umesh,
                      f"undamped box fp64 '{mode}', 2 cycles")
        rms_rel = [abs(a - b) / abs(b)
                   for a, b in zip(k32.rms_history, k64.rms_history)]
        log(f"undamped box '{mode}' fp32 kernel RMS {k32.rms_history} vs "
            f"fp64 {k64.rms_history}: relative differences {rms_rel}")
        require(all(math.isfinite(r) for r in k32.rms_history)
                and max(rms_rel) <= RMS_DIGITS_TOL,
                f"'{mode}' fp32 RMS does not agree with fp64 to 3 digits")
        bf16_tracks_fp64(k16, up64, f"undamped box bf16 '{mode}'")

    # --- spill edges: every plan cut to one span ---
    solver_mod.build_shift_plan = functools.partial(build_shift_plan,
                                                    max_deltas=1)
    try:
        s64 = solver(mesh, "float64", "pallas")
        s16 = solver(mesh, "bfloat16", "pallas")
    finally:
        solver_mod.build_shift_plan = build_shift_plan
    log("one-span plans: " + "; ".join(
        f"L{i} spans {lv.shift.deltas} spill edges "
        f"{lv.spill_csr.num_entries // 2}"
        for i, lv in enumerate(s64.dmesh.levels)))
    L0 = s64.dmesh.levels[0]
    for sp in (s64, s16):
        q = random_state(L0.num_nodes, 21, sp.dtype, L0.volumes.device)
        csr = sp.dmesh.levels[0].spill_csr
        check_cases([("edge_csr.flux over spill edges",
                      edge_csr.flux(csr, q),
                      edge_csr.edge_csr_plain("flux", csr, q))], sp.dtype)
    runs64["spill"] = counted_run(s64, 2, "spill-forced 'pallas' fp64")
    runs16["spill"] = counted_run(s16, 2, "spill-forced 'pallas' bf16")
    for runs in (runs64, runs16):
        counts_spill = runs["spill"][0]
        for k in ("shift.fused_stage", "shift.rw", "edge_csr.flux",
                  "edge_csr.rw"):
            require(counts_spill[k] > 0, f"spill run launched no {k}")
        require(counts_spill["shift.flux"] == counts_spill["fused_stage"]
                == 0, "spill run launched a kernel off its path")
    same_as_plain(s64, p64, mesh, "box fp64 'pallas' with spill, 2 cycles")
    healthy(s16, "box bf16 'pallas' with spill")
    # fp32 has no runs of its own off the main and window paths: its
    # records read the fp64 runs' launches for those
    runs32["unfused"], runs32["spill"] = runs64["unfused"], runs64["spill"]

    # --- tet hierarchy, through its files and RCM (the CLI's -i ...
    # --renumber path): auto takes 'window' there, fp64 and bf16; and
    # 'pallas' at fp64 (span plans that cover little, spill edges)
    tet_input = write_multigrid_mesh(str(scratch / "tet32"), tmesh)
    tloaded = load_multigrid_mesh(tet_input)
    same_arrays(tloaded, tmesh, "tet 32^3 from .dat files")
    tmesh = renumber_hierarchy(tloaded)
    log(f"tet {tmesh.levels[0].num_nodes} nodes, "
        f"{tmesh.levels[0].num_internal_edges} edges, 3 levels, from "
        f"files, RCM: level-0 index span {locality_stats(tloaded.levels[0])}"
        f" -> {locality_stats(tmesh.levels[0])}")
    require(cli_main(["-i", tet_input, "--renumber", "-g", "2"]) == 0,
            "the CLI failed on the tet's files")
    kt, kt16 = solver(tmesh, "float64"), solver(tmesh, "bfloat16")
    require(kt.config.accumulate == kt16.config.accumulate == "window",
            "auto did not take the CSR kernels on the tet")
    pt = solver(tmesh, "float64", "segment")
    kt.run(2)
    pt.run(2)
    same_as_plain(kt, pt, tmesh, "tet fp64, 2 cycles")
    ktp = solver(tmesh, "float64", "pallas")
    counts, _ = counted_run(ktp, 2, "tet fp64 'pallas'")
    require(counts["shift.fused_stage"] > 0 and counts["fused_stage"] == 0,
            "tet 'pallas' run missed the span stage")
    same_as_plain(ktp, pt, tmesh, "tet fp64 'pallas', 2 cycles")
    counted_run(kt16, 2, "tet bf16 ('window', auto)",
                {"fused_stage": 12, "edge_csr.rw": 12, "step_factor": 8,
                 "edge_csr.wsum.restrict": 2, "edge_csr.wsum.prolong": 2})
    healthy(kt16, "tet bf16 'window'")

    # --- the tet flagship, generated and renumbered by the child ---
    tr, ts, secs = finish_tet_flagship(tet_job)
    log(f"tet flagship {secs['nodes']} nodes, {secs['internal_edges']} "
        f"internal edges: generated in {secs['generate_s']:.1f} s, "
        f"written as files in {secs['write_s']:.1f} s and parsed in "
        f"{secs['parse_s']:.1f} s (host, a child process); loaded here "
        f"through the npz cache in {secs['cached_load_s']:.2f} s, RCM in "
        f"{secs['renumber_s']:.1f} s; level-0 index span "
        f"{locality_stats(ts.levels[0])} -> {locality_stats(tr.levels[0])}")
    tf64, tfp = solver(tr, "float64"), solver(tr, "float64", "segment")
    require(tf64.config.accumulate == "window",
            "auto did not take the CSR kernels on the tet flagship")
    runs_tet64 = {".tet": counted_run(tf64, 2, "tet flagship fp64 (auto)",
                                      WANT_WINDOW)}
    tfp.run(2)
    same_as_plain(tf64, tfp, tr, "tet flagship fp64 'window' (auto)")
    for dt in ("float32", "bfloat16"):
        batched_equals_run(functools.partial(solver, tr, dt),
                           f"tet flagship {dt} (auto)", WANT_WINDOW)
    tets32, runs_tet = {}, {}
    for suffix, m in ((".tet", tr), (".tet_shuffled", ts)):
        tets32[suffix] = solver(m, "float32")
        runs_tet[suffix] = counted_run(tets32[suffix], 2,
                                       f"tet flagship fp32{suffix}",
                                       WANT_WINDOW)
    t16 = solver(tr, "bfloat16")
    runs_tet16 = {".tet": counted_run(t16, 2, "tet flagship bf16 (auto)",
                                      WANT_WINDOW)}
    for s_ in (tf64, tets32[".tet"], t16):
        check_rw(s_, "tet flagship")
        check_flux(s_, "tet flagship")

    # --- the unfused window stage and the monitor ---
    unfused, runs_unfused = monitor_phase(
        solver, tr, tf64, tets32[".tet"], mesh, m32, tet_input, scratch,
        f"{name}, {smi}")

    # --- the kernel variants, checkpoints, dumps, -v, capacity ---
    options_phase(solver, mesh, m32, p64, tr, tf64, tets32[".tet"],
                  tet_input, scratch, f"{name}, {smi}")

    # --- the native parser and the sharded solver ---
    shard_records, shard_timing, _ = sharded_phase(
        solver, tr, ts, tf64, tet_input, secs, scratch, f"{name}, {smi}")

    # --- times at the level-0 shapes, for each dtype ---
    records = []
    for s_main, s_win, runs in ((m32, w32, runs32), (m64, w64, runs64),
                                (m16, w16, runs16)):
        records += kernel_records(s_main, s_win, L0.spill_csr, runs,
                                  f"{name}, {smi}")
    records += tet_records(tets32, runs_tet, f"{name}, {smi}")
    for s_, runs in ((t16, runs_tet16), (tf64, runs_tet64)):
        records += tet_records({".tet": s_}, runs, f"{name}, {smi}",
                               only="edge_csr.rw")
    for dt, u in unfused.items():
        records += flux_records(u, runs_unfused[dt], f"{name}, {smi}")
    timings = [batched_timing(s_, what, f"{name}, {smi}") for s_, what in (
        (m32, "box 'pallas' fp32"), (m16, "box 'pallas' bf16"),
        (w32, "box 'window' fp32"),
        (tets32[".tet"], "tet flagship RCM 'window' fp32"),
        (tets32[".tet_shuffled"], "tet flagship shuffled 'window' fp32"))]
    log(f"V-cycle, box flagship, main path ('pallas', auto): fp32 "
        f"{cycle_ms[('pallas', 'fp32')]:.3f} ms, bf16 "
        f"{cycle_ms[('pallas', 'bf16')]:.3f} ms per cycle; 'window': fp32 "
        f"{cycle_ms[('window', 'fp32')]:.3f} ms, bf16 "
        f"{cycle_ms[('window', 'bf16')]:.3f} ms per cycle (CUDA events "
        f"over 10 cycles after 2) [{name}, {smi}]")

    records += shard_records
    timings.append(shard_timing)
    log(f"V-cycle, tet flagship RCM 'window' fp32 through run_batched "
        f"(K = {BATCH_K}): single device "
        f"{timings[3]['run_batched_ms']:.3f} ms, sharded P=1 (NCCL) "
        f"{shard_timing['run_batched_ms']:.3f} ms; through run: "
        f"{timings[3]['run_ms']:.3f} and {shard_timing['run_ms']:.3f} ms "
        f"[{name}, {smi}]")

    log("run_batched timings: " + json.dumps(timings))
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
