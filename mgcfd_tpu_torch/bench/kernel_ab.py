"""The kernels of this tree against those of another tree, on the card, at
the box flagship's shapes and two RCM-ordered tets' CSRs.

    python mgcfd_tpu_torch/bench/kernel_ab.py [--parent TREE] [--out DIR]
        [--shapes] [--only NAME[,NAME]] [--levels NPZ[,NPZ]]

TREE is the root of another checkout of the repository, for example an
earlier commit unpacked with `git archive <commit> mgcfd_tpu_torch | tar
-x -C build/parent_tree` into a gitignored directory. Each side runs in
a process of its own that imports mgcfd_tpu_torch from its tree and calls
its wrappers, so any version of the kernels whose wrappers take the same
operands can be compared:
  - the two fused RK-stage kernels, shift.fused_stage and fused_stage, at
    every level of the flagship (plan, the boundary operand the tree's
    wrappers take: the compact BoundaryRows where the tree has
    kernels/boundary.py, else the dense nc; q, old, fac), each also as a
    visit's last stage: with the parent's eager ops after it (suffix
    +eager: q - old and the int64 add of the count) and, where the
    tree's wrappers take them, with its epilogues instead (suffix
    +epilogue: the residual and the count stored by the kernel); and all
    of these again from a state with invalid values planted (suffix +bad,
    not timed), whose counts are compared too;
  - shift.rw and shift.flux (plan, q) at every level;
  - edge_csr.rw and edge_csr.flux (CSR, q) at every level, and the wsum
    transfers,
    edge_csr.restrict and edge_csr.prolong (CSR, x), at every level that
    has them, on the flagship and on two tets in RCM order (irregular
    rows): a 64^3 tet of 4 levels (suffix .tet64) and the tet flagship
    (suffix .tetflag); their CSRs made once, before the turns, in
    processes of their own, and loaded by each side; each transfer also
    with the solver's update around it, as eager ops (suffix +eager: the
    restriction's torch.where of the rows with entries, the
    prolongation's vars + (res - P)) and, where the wrappers take them,
    as the kernel's epilogue (suffix +epilogue);
  - with --levels, one level visit's four launches on each level of each
    .npz given (suffix .<the file's stem>; a configuration's levels as
    cfdbench/level_npz.py writes them): the step factor (visit.step) and
    the three fused RK stages
    (visit.stage1-3), each from the input the launch before it gave, as
    the solver chains them; where the tree's wrappers take the stored
    primitives (kernels/fused_stage.py primitives) with them, the step
    factor's first pass and the first two stages storing them into a
    buffer and each stage gathering what the launch before it stored,
    each row from a buffer of its own, so that a row can be launched
    again alone; each held to the same launch without them (the "plain"
    column), and again from a state with invalid values planted (+bad).
The processes run in turns, parent, new, new, parent (new alone without
--parent), after both trees' kernels are built in parallel.

What each process does, for fp32, bf16 and fp64:
  1. on its tree's first turn, prints nvcc -Xptxas -v for the kernels'
     sources (registers, spills, shared memory), the whole report into
     --out (default build/kernel_ab), and the SASS of each fused_stage
     kernel, its instructions counted by kind (loads, the special-function
     unit's, calls of the divide and square-root slow paths, float
     operations), the listing into --out too;
  2. holds each kernel to its plain version (the share of bit-equal
     elements, the largest difference; for the stage kernels the invalid
     counts) and two launches to each other; a +epilogue row to its
     +eager row (the eager ops after the kernel on the card, the residual
     too), which must be bit-equal;
  3. times each kernel warm (CUDA events around REPS back-to-back
     launches, so the operands that fit stay in the 50 MB L2) and cold
     (a 128 MB buffer written before each launch, each launch timed by
     its own event pair, the median), beside the byte bound at 3.35
     TB/s; and the launch floor, a one-element in-place add timed warm
     the same way;
  4. with --shapes, where its wrappers can launch at a given shape
     (ShiftFlux.at, EdgeCSR.at), times shift.rw, shift.flux, edge_csr.rw,
     edge_csr.flux and the wsum transfers (the tets' too) at every shape
     their kernels are built for, at every level, warm, and keeps each rw
     and flux shape's output.
Then the main process prints each side's times and shares and whether
the two trees' outputs are bit-equal (every rw and flux shape's against
the parent's kernel in that mode). Needs a CUDA device. Prints the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import re
import statistics
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 128 * 2 ** 20
REPS = 20
SOURCES = ("fused_stage.cu", "shift_fused_stage.cu", "shift_flux.cu",
           "edge_csr.cu")
DTYPES = ("fp32", "bf16", "fp64")
TREE = Path(__file__).resolve().parents[2]
WORKER_TIMEOUT_S = 900
RECORD = "KERNEL_AB "
# the tets whose CSRs are timed beside the flagship's ('window's and
# `auto`'s workload on unstructured meshes), suffix -> (generator spec,
# seed), each renumbered by RCM (renumber_hierarchy) as the CLI's
# --renumber orders it: 64^3 nodes, 4 levels, so that its levels span the
# full level (262,144 rows) down to chip_smoke.py's 32^3 tet's (32,768 at
# level 1); and the tet flagship's generator (bench/tet_flagship.py;
# renumbered here without its round trip through files, so some edges
# keep the other orientation)
TETS = {".tet64": ((64, 64, 64, 4), 0), ".tetflag": ((68, 64, 70, 4), 1)}
# CSR plan fields kept per level in a tet's .npz
PLAN_KEYS = ("num_rows", "num_cols", "row_ptr", "owner", "col", "w")
# SASS opcodes counted per fused_stage kernel, by kind
SASS_KINDS = {"ldg": ("LDG",), "mufu": ("MUFU",), "call": ("CALL",),
              "fp32": ("FFMA", "FMUL", "FADD", "FSETP", "FSEL"),
              "fp64": ("DFMA", "DMUL", "DADD", "DSETP")}
# level 0's flux CSR is also timed with each row cut to its first FIRST
# entries (suffix FIRST_SUFFIX), the box's row length: the row kernel's
# time per entry there against the full rows' tests whether the row
# length itself slows it down
FIRST = 6
FIRST_SUFFIX = ".first6"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip()


# --- one side, in its own process ------------------------------------------

def ptxas_report(build, label: str, out: Path | None) -> None:
    """nvcc -Xptxas -v of the kernels: one line per instantiation."""
    text = []
    for name in SOURCES:
        r = subprocess.run(
            [build._nvcc(), *[f for f in build.NVCC_FLAGS
                              if f not in ("-shared", "-Xcompiler", "-fPIC")],
             "-Xptxas", "-v", "-cubin", "-o", "/dev/null",
             str(build.CSRC / name)], capture_output=True, text=True,
            timeout=300)
        if r.returncode != 0:
            raise RuntimeError(r.stderr)
        text.append(r.stderr)
        entry = None
        for line in r.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry and ("spill" in line or "registers" in line):
                print(f"{label} ptxas {name:22s} {entry}: {line.strip()}")
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / f"ptxas_{label}.txt").write_text("\n".join(text))


def sass_report(build, label: str, out: Path | None) -> None:
    """The SASS of fused_stage.cu (cuobjdump -sass of its cubin): each
    kernel's instructions, all and by SASS_KINDS, one line a kernel; the
    listing into out."""
    cubin = (out or TREE / "build" / "kernel_ab") / f"fused_stage_{label}.cubin"
    cubin.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run(
        [build._nvcc(), *[f for f in build.NVCC_FLAGS
                          if f not in ("-shared", "-Xcompiler", "-fPIC")],
         "-cubin", "-o", str(cubin), str(build.CSRC / "fused_stage.cu")],
        capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(r.stderr)
    dump = subprocess.run(
        [str(Path(build._nvcc()).parent / "cuobjdump"), "-sass",
         str(cubin)], capture_output=True, text=True, timeout=300)
    if dump.returncode != 0:
        raise RuntimeError(dump.stderr)
    if out is not None:
        (out / f"sass_fused_stage_{label}.txt").write_text(dump.stdout)
    counts, name = {}, None
    for line in dump.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(("all", *SASS_KINDS), 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     line)
        if name is None or m is None:
            continue
        op = m.group(1)
        c = counts[name]
        c["all"] += 1
        for kind, ops in SASS_KINDS.items():
            c[kind] += op in ops
    for name, c in counts.items():
        print(f"{label} sass {name}: " + ", ".join(f"{k} {v}"
                                                   for k, v in c.items()))


def event_ms(fn, reps: int) -> float:
    """Warm: CUDA events around reps back-to-back launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def cold_ms(fn, reps: int, flush) -> float:
    """Cold: FLUSH_BYTES written before each launch, each launch timed by
    its own event pair, queued behind a wait on the card so that no host
    gap enters the span; the median."""
    import torch
    times = []
    for _ in range(reps):
        flush.fill_(1)
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def same_share(a, b) -> float:
    """The share of elements of a equal to b's, bit for bit, a NaN equal
    to a NaN (0 where the shapes or dtypes differ)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return 0.0
    if a.numel() == 0:
        return 1.0
    eq = a == b
    if a.is_floating_point():
        eq |= a.isnan() & b.isnan()
    return int(eq.sum()) / eq.numel()


def takes_epilogues(fn) -> bool:
    """Whether a wrapper of this tree takes the epilogues' operands."""
    import inspect
    params = inspect.signature(fn).parameters
    return "residual" in params or "keep" in params


def stage_operand(nc64, dt, dev):
    """The boundary operand this tree's fused-stage wrappers take: the
    compact BoundaryRows where the tree has kernels/boundary.py (built
    from the values cast on the host, as the solver builds it), else the
    dense (11, N) nc; and its bytes."""
    import torch
    sz = torch.empty((), dtype=dt).element_size()
    try:
        from mgcfd_tpu_torch.kernels.boundary import boundary_rows
    except ImportError:
        return torch.as_tensor(nc64).to(dev, dt), sz * 11 * nc64.shape[1]
    bnd = boundary_rows(torch.as_tensor(nc64).to(dt)).to(dev)
    return bnd, 8 * int(bnd.mask.shape[0]) + sz * 11 * bnd.stored


def stage_rows(dt, lev, lv, splan, cplan, nc64, q64, dev):
    """The two stage kernels at one level: (name, level, kernel, plain,
    bytes); each returns (out, invalid count), the +eager and +epilogue
    rows (out, invalid count, residual); the +bad rows (bytes None: not
    timed) the same from a state with a NaN, an Inf, rho < 0 and E < 0
    planted at a boundary node and an interior one each."""
    import torch
    from mgcfd_tpu_torch.kernels import DeviceCSR, DeviceShift, shift
    from mgcfd_tpu_torch.kernels.fused_stage import (fused_stage,
                                                     fused_stage_plain)
    n = lv.num_nodes
    sz = torch.empty((), dtype=dt).element_size()
    sh = DeviceShift.from_plan(splan, n, dev, dt)
    csr = DeviceCSR.from_plan(cplan, dev, dt)
    nc, nc_bytes = stage_operand(nc64, dt, dev)
    q = torch.as_tensor(q64).to(dev, dt)
    old = q + 1e-6 * q
    fac = torch.full((n,), 1e-3, dtype=dt, device=dev)
    edge = int(nc64.any(axis=0).argmax())
    inner = int((~nc64.any(axis=0)).argmax())
    bad = q.clone()
    bad[1, edge], bad[3, inner] = float("nan"), float("inf")
    bad[0, inner], bad[4, edge] = -2.0, -2.0
    D = len(sh.deltas)
    stages = [
        ("shift.fused_stage",
         lambda x, **e: shift.fused_stage(sh, nc, x, old, fac, **e),
         lambda x: shift.shift_fused_stage_plain(sh, nc, x, old, fac),
         sz * n * (5 + 4 * D + 5 + 1 + 5) + nc_bytes + 8, shift.fused_stage),
        ("fused_stage",
         lambda x, **e: fused_stage(csr, nc, x, old, fac, **e),
         lambda x: fused_stage_plain(csr, nc, x, old, fac),
         4 * (n + 1) + 4 * csr.num_entries + sz * 4 * csr.num_entries
         + sz * n * (5 + 5 + 1 + 5) + nc_bytes + 8, fused_stage),
    ]

    def eager(kern, x):
        """The parent's last stage of a visit: the kernel, q - old and
        the count added to the visit's int64."""
        total = torch.zeros((), dtype=torch.int64, device=dev)
        out, inv = kern(x)
        return out, total + inv, out - old

    def epilogue(kern, x):
        count = torch.zeros((), dtype=torch.int64, device=dev)
        return kern(x, count=count, residual=True)

    rows = []
    for name, kern, plain, nbytes, wrapper in stages:
        # the residual written, and the count as an int64
        tail = sz * 5 * n + 4
        for suffix, x, nb in (("", q, nbytes), ("+bad", bad, None)):
            rows += [(name + suffix, lev, lambda k=kern, x=x: k(x),
                      lambda p=plain, x=x: p(x), nb),
                     (f"{name}+eager{suffix}", lev,
                      lambda k=kern, x=x: eager(k, x),
                      lambda k=kern, x=x: eager(k, x),
                      None if nb is None else nb + tail)]
            if takes_epilogues(wrapper.__call__):
                rows.append((f"{name}+epilogue{suffix}", lev,
                             lambda k=kern, x=x: epilogue(k, x),
                             lambda k=kern, x=x: eager(k, x),
                             None if nb is None else nb + tail))
    return rows


def takes_primitives(fn) -> bool:
    """Whether a wrapper of this tree takes the stored primitives."""
    import inspect
    params = inspect.signature(fn).parameters
    return "prims_in" in params or "prims_out" in params


def visits_only(only) -> bool:
    """Whether every name asked for with --only is a visit row's."""
    return all(o.startswith("visit") for o in only)


def level_files(args) -> list:
    """The .npz files given with --levels."""
    return [Path(f) for f in args.levels.split(",") if f]


def visit_rows(dt, suffix, lev, z, dev):
    """One level visit's launches (the module docstring's visit rows) on
    level lev of a cell's .npz z: (name, level, kernel, plain, bytes);
    kernel and plain return the launch's outputs (the step factor's RK
    factors; a stage's new state and count, the last one's residual too),
    plain the same launch without the primitives."""
    import numpy as np
    import torch
    from mgcfd_tpu_torch.core.constants import RK, far_field_state
    from mgcfd_tpu_torch.kernels.edge_csr import compute_dtype
    from mgcfd_tpu_torch.kernels.fused_stage import fused_stage
    from mgcfd_tpu_torch.kernels.step_factor import StepScratch, step_factor
    d = {k: z[f"{lev}f_{k}"] for k in PLAN_KEYS}
    d["num_rows"], d["num_cols"] = int(d["num_rows"]), int(d["num_cols"])
    from mgcfd_tpu_torch.kernels import DeviceCSR
    csr = DeviceCSR.from_plan(SimpleNamespace(
        **d, num_entries=int(d["col"].shape[0])), dev, dt)
    n = csr.num_rows
    nc64 = z[f"{lev}_nc"]
    nc, nc_bytes = stage_operand(nc64, dt, dev)
    vol = torch.as_tensor(z[f"{lev}_volumes"]).to(dev, dt)
    cbrt = torch.pow(vol, 1.0 / 3.0)
    scratch = StepScratch(n, dt, dev)
    sz = torch.empty((), dtype=dt).element_size()
    csz = torch.empty((), dtype=compute_dtype(dt)).element_size()
    prims = takes_primitives(fused_stage.__call__)
    rng = np.random.default_rng(7 + lev)
    q0 = torch.as_tensor(far_field_state(np.float64)[0][:, None]
                         * (1.0 + 0.05 * rng.uniform(-1, 1, (5, n)))).to(
        dev, dt)
    bad = q0.clone()
    edge = int(nc64.any(axis=0).argmax())
    inner = int((~nc64.any(axis=0)).argmax())
    bad[1, edge], bad[3, inner] = float("nan"), float("inf")
    bad[0, inner], bad[4, edge] = -2.0, -2.0

    def buf():
        return torch.zeros((2, n), dtype=compute_dtype(dt), device=dev)

    stage_bytes = 4 * (n + 1) + 4 * csr.num_entries \
        + sz * 4 * csr.num_entries + sz * n * (5 + 5 + 1 + 5) + nc_bytes + 8
    rows = []
    # the stages' factors, from the sound state: the planted state's
    # would be NaN at every node
    fac = step_factor(q0, vol, cbrt, False, scratch)
    for tag, q in (("", q0), ("+bad", bad)):
        # the chain once: each launch's input, and the primitives stored
        store = buf() if prims else None
        kw = {"prims_out": store} if prims else {}
        step_factor(q, vol, cbrt, False, scratch, **kw)
        inputs, stored = [q], [store]
        count = torch.zeros((), dtype=torch.int64, device=dev)
        for j in range(RK - 1):
            out_buf = buf() if prims else None
            kw = {"prims_in": stored[-1], "prims_out": out_buf} \
                if prims else {}
            inputs.append(fused_stage(csr, nc, inputs[-1], q, fac[j],
                                      count, **kw)[0])
            stored.append(out_buf)
        timed = tag == ""

        def step(own=buf() if prims else None, q=q):
            kw = {"prims_out": own} if own is not None else {}
            return step_factor(q, vol, cbrt, False, scratch, **kw)

        rows.append((f"visit.step{suffix}{tag}", lev, step,
                     lambda q=q: step_factor(q, vol, cbrt, False, scratch),
                     sz * n * 10 + (2 * csz * n if prims else 0)
                     if timed else None))
        for j in range(RK):
            last = j == RK - 1
            gather = stored[j]
            own = buf() if prims and not last else None

            def stage(j=j, gather=gather, own=own, last=last, x=inputs[j],
                      q=q):
                kw = {}
                if gather is not None:
                    kw["prims_in"] = gather
                if own is not None:
                    kw["prims_out"] = own
                count = torch.zeros((), dtype=torch.int64, device=dev)
                return fused_stage(csr, nc, x, q, fac[j], count,
                                   residual=last, **kw)

            def plain(j=j, last=last, x=inputs[j], q=q):
                count = torch.zeros((), dtype=torch.int64, device=dev)
                return fused_stage(csr, nc, x, q, fac[j], count,
                                   residual=last)

            nbytes = stage_bytes + sz * 5 * n * last \
                + csz * 2 * n * ((gather is not None) + (own is not None))
            rows.append((f"visit.stage{j + 1}{suffix}{tag}", lev, stage,
                         plain, nbytes if timed else None))
    return rows


def cell_facts(path: Path) -> None:
    """Print each level's rows, entries a row, tile-local share and
    fused_stage.gather_sectors at float32 and float64 of a --levels
    file."""
    import numpy as np
    import torch
    from mgcfd_tpu_torch.kernels.edge_csr import FLUX_TILE_ROWS as rows
    from mgcfd_tpu_torch.kernels.fused_stage import gather_sectors
    z = np.load(path)
    suffix = f".{path.stem}"
    for lev in (int(v) for v in z["levels"]):
        col = torch.as_tensor(z[f"{lev}f_col"]).to(torch.int32)
        owner = torch.as_tensor(z[f"{lev}f_owner"]).long()
        n = int(z[f"{lev}f_num_rows"])
        local = float((col.long() // rows == owner // rows).double().mean())
        sectors = [gather_sectors(SimpleNamespace(
            col=col, owner=owner, w=torch.empty(0, dtype=dt)))
            for dt in (torch.float32, torch.float64)]
        print(f"cell{suffix} L{lev}: rows {n}, entries a row "
              f"{len(col) / n:.2f}, tile-local {100 * local:.2f} %, "
              f"sectors a load fp32 {sectors[0]:.2f} fp64 {sectors[1]:.2f}",
              flush=True)


def cell_rows(files, dt, dev):
    """visit_rows of each --levels file at each of its levels."""
    import numpy as np
    rows = []
    for path in files:
        z = np.load(path)
        for lev in z["levels"]:
            rows += visit_rows(dt, f".{path.stem}", int(lev), z, dev)
    return rows


def level_rows(levels, flux, state):
    """shift.rw and shift.flux at every level, edge_csr.rw on each level's
    flux CSR (flux: [(suffix, level, CSR)]) and the wsum transfers at
    every level that has them: (name, level, kernel, plain, bytes); state
    (n, seed) -> a (5, n) state in the levels' dtype."""
    from mgcfd_tpu_torch.kernels import shift
    rows = []
    for lev, L in enumerate(levels):
        sh, n = L.shift, L.num_nodes
        sz = sh.w.element_size()
        D = len(sh.deltas)
        q = state(n, 11 + lev)
        for mode, kern, wrows in (("rw", shift.rw, 3),
                                  ("flux", shift.flux, 4)):
            rows.append((f"shift.{mode}", lev,
                         lambda k=kern, sh=sh, q=q: k(sh, q),
                         lambda m=mode, sh=sh, q=q: shift.shift_plain(m, sh,
                                                                      q),
                         sz * n * (5 + wrows * D + 5)))
    return rows + csr_rows(flux, state) \
        + wsum_rows(flagship_transfers(levels), state)


def csr_rows(flux, state):
    """edge_csr.rw and edge_csr.flux on each (suffix, level, CSR): (name,
    level, kernel, plain, bytes), the bytes chip_smoke.py counts (row_ptr,
    col, three weight rows in rw mode and four in flux mode, the state read
    and the sums written)."""
    from mgcfd_tpu_torch.kernels import edge_csr
    rows = []
    for suffix, lev, csr in flux:
        sz = csr.w.element_size()
        q = state(csr.num_cols, 31 + lev)
        for mode, kern, wrows in (("rw", edge_csr.rw, 3),
                                  ("flux", edge_csr.flux, 4)):
            rows.append((f"edge_csr.{mode}{suffix}", lev,
                         lambda k=kern, c=csr, q=q: k(c, q),
                         lambda m=mode, c=csr, q=q: edge_csr.edge_csr_plain(
                             m, c, q),
                         4 * (csr.num_rows + 1)
                         + (4 + wrows * sz) * csr.num_entries
                         + sz * 5 * (csr.num_cols + csr.num_rows)))
    return rows


def flagship_transfers(levels):
    """(name suffix, level, restriction CSR, prolongation CSR) of every
    level of a solver's mesh that has them."""
    return [("", lev, L.restrict_csr, L.prolong_csr)
            for lev, L in enumerate(levels) if L.restrict_csr is not None]


def make_tet(path: Path, spec, seed: int) -> None:
    """Generate a tet hierarchy (spec, seed), renumber it (RCM) and write
    each level's flux CSR plan and each level's restriction and
    prolongation plans, as the solver builds them, into path, an .npz that
    every side loads, so that both trees get the same arrays. Nothing is
    done if path exists."""
    if path.exists():
        return
    import numpy as np
    from mgcfd_tpu_torch.mesh import generate_unstructured_hierarchy
    from mgcfd_tpu_torch.prep.csr import (build_flux_csr, build_prolong_csr,
                                          build_restrict_csr)
    from mgcfd_tpu_torch.prep.renumber import renumber_hierarchy
    tmesh = renumber_hierarchy(generate_unstructured_hierarchy(*spec,
                                                               seed=seed))
    plans = {}
    for lev, fine in enumerate(tmesh.levels):
        plans[f"{lev}f"] = build_flux_csr(fine)
        if lev == 0:
            plans["0t"] = first_entries(plans["0f"], FIRST)
        if lev + 1 < tmesh.num_levels:
            coarse = tmesh.levels[lev + 1]
            plans[f"{lev}r"] = build_restrict_csr(
                fine.mg_mapping, fine.num_nodes, coarse.num_nodes)[0]
            plans[f"{lev}p"] = build_prolong_csr(fine, coarse)
    arrays = {f"{pre}_{k}": np.asarray(getattr(plan, k))
              for pre, plan in plans.items() for k in PLAN_KEYS}
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **arrays)
    tmp.replace(path)


def first_entries(plan, k: int):
    """A CSR plan with each row cut to its first k entries."""
    import numpy as np
    lens = np.diff(plan.row_ptr)
    pos = np.arange(plan.num_entries) - np.repeat(plan.row_ptr[:-1], lens)
    keep = pos < k
    row_ptr = np.zeros_like(plan.row_ptr)
    np.cumsum(np.minimum(lens, k), out=row_ptr[1:])
    return SimpleNamespace(num_rows=plan.num_rows, num_cols=plan.num_cols,
                           row_ptr=row_ptr, owner=plan.owner[keep],
                           col=plan.col[keep], w=plan.w[:, keep])


def tet_plans(path: Path):
    """make_tet's plans, each a CSRPlan-like namespace: ([(suffix, level,
    flux CSR)], [(level, restriction, prolongation)]); the suffix is ""
    for each level's flux CSR and FIRST_SUFFIX for level 0's cut to its
    first FIRST entries a row."""
    import numpy as np
    z = np.load(path)

    def plan(pre):
        d = {k: z[f"{pre}_{k}"] for k in PLAN_KEYS}
        d["num_rows"], d["num_cols"] = int(d["num_rows"]), int(d["num_cols"])
        return SimpleNamespace(**d, num_entries=int(d["col"].shape[0]))

    pres = {re.match(r"(\d+[frpt])_", k).group(1) for k in z.files}
    levels = sorted(int(p[:-1]) for p in pres if p.endswith("f"))
    return ([("", lev, plan(f"{lev}f")) for lev in levels]
            + [(FIRST_SUFFIX, 0, plan("0t"))],
            [(lev, plan(f"{lev}r"), plan(f"{lev}p")) for lev in levels
             if f"{lev}r" in pres])


def tet_path(tets: Path, suffix: str) -> Path:
    spec, seed = TETS[suffix]
    return tets / f"tet_{'x'.join(map(str, spec))}_s{seed}_rcm_f{FIRST}.npz"


def tet_csrs(tets: Path, dt, dev):
    """Every TETS tet's CSRs on the card: ([(suffix, level, flux CSR)],
    [(suffix, level, restriction CSR, prolongation CSR)])."""
    from mgcfd_tpu_torch.kernels import DeviceCSR
    flux, transfers = [], []
    for suffix in TETS:
        fplans, tplans = tet_plans(tet_path(tets, suffix))
        flux += [(suffix + cut, lev, DeviceCSR.from_plan(f, dev, dt))
                 for cut, lev, f in fplans]
        transfers += [(suffix, lev, DeviceCSR.from_plan(r, dev, dt),
                       DeviceCSR.from_plan(p, dev, dt))
                      for lev, r, p in tplans]
    return flux, transfers


def wsum_rows(transfers, state):
    """The wsum transfers, edge_csr.restrict and edge_csr.prolong, on each
    (suffix, level, restriction CSR, prolongation CSR); each also with
    the solver's update (+eager, and +epilogue where the wrappers take
    it): the restriction keeps a coarse state on its rows with no
    entries, the prolongation returns vars + (res - P)."""
    import torch
    from mgcfd_tpu_torch.kernels import edge_csr
    rows = []
    for suffix, lev, rcsr, pcsr in transfers:
        for what, kern, csr in (("restrict", edge_csr.restrict, rcsr),
                                ("prolong", edge_csr.prolong, pcsr)):
            sz = csr.w.element_size()
            x = state(csr.num_cols, 21 + lev)
            a = state(csr.num_rows, 41 + lev)
            b = state(csr.num_rows, 51 + lev)
            empty = (csr.row_ptr[1:] == csr.row_ptr[:-1])[None]
            name = f"edge_csr.wsum.{what}{suffix}"
            nbytes = 4 * (csr.num_rows + 1) + (4 + sz) * csr.num_entries \
                + sz * 5 * (csr.num_cols + csr.num_rows)
            rows.append((name, lev, lambda k=kern, c=csr, x=x: k(c, x),
                         lambda c=csr, x=x: edge_csr.edge_csr_plain(
                             "wsum", c, x), nbytes))
            if what == "restrict":
                def eager(k=kern, c=csr, x=x, a=a, e=empty):
                    return torch.where(e, a, k(c, x))

                def epilogue(k=kern, c=csr, x=x, a=a):
                    return k(c, x, keep=a)
                # the kept state's reads on the rows with no entries
                tail = sz * 5 * int(empty.sum())
            else:
                def eager(k=kern, c=csr, x=x, a=a, b=b):
                    return a + (b - k(c, x))

                def epilogue(k=kern, c=csr, x=x, a=a, b=b):
                    return k(c, x, correct=(a, b))
                tail = sz * 10 * csr.num_rows
            rows.append((f"{name}+eager", lev, eager, eager, nbytes + tail))
            if takes_epilogues(kern.__call__):
                rows.append((f"{name}+epilogue", lev, epilogue, eager,
                             nbytes + tail))
    return rows


def shape_sweep(label, tag, levels, flux, transfers, state, smi,
                outputs, only=("",)) -> None:
    """shift.rw and shift.flux at every shape their kernel is built for
    (rw: with and without a thread per (node, channel); both: with and
    without the span loop unrolled), edge_csr.rw and edge_csr.flux at each
    of their shapes (each output kept in outputs, to be held to the other
    tree's kernel in that mode) and the wsum transfers with and without a thread per (row,
    channel), with plain, chunked and batched loads, at every level,
    warm; the shape each C entry point picks marked, and any output that
    differs from the chosen shape's flagged (flux mode's unrolled and
    looped forms differ in the last bits). Only the kernels whose names
    start with one of the prefixes `only`."""
    import torch
    from mgcfd_tpu_torch.kernels import edge_csr, shift

    def sweep(what, kern, run, shapes, chosen, name, keep=None):
        if not kern.name.startswith(only):
            return
        want = kern(*run)
        got = []
        for s in shapes:
            out = kern.at(*run, *s)
            same = torch.equal(out, want)
            if keep is not None:
                outputs[f"{keep} {tag} shape={name(s)}"] = out.cpu()
            ms = event_ms(lambda s=s: kern.at(*run, *s), REPS)
            got.append(f"{name(s)}{'*' if s == chosen else ''} "
                       f"{ms * 1e3:.2f}{'' if same else ' DIFFERS'}")
        print(f"{label} shapes {what} {tag}: " + "; ".join(got)
              + f" us (* = chosen) [{smi}]", flush=True)

    for lev, L in enumerate(levels):
        sh, n = L.shift, L.num_nodes
        q = state(n, 11 + lev)
        for mode, kern in (("rw", shift.rw), ("flux", shift.flux)):
            sweep(f"shift.{mode} L{lev} n={n}", kern, (sh, q),
                  [(shift.FluxShape(split=sp, unroll=u),)
                   for sp in ((False, True) if mode == "rw" else (False,))
                   for u in (False, True)], (kern.shape(sh),),
                  lambda s: f"{'split' if s[0].split else 'node'}"
                            f"{'+unroll' if s[0].unroll else ''}")
    for suffix, lev, csr in flux:
        q = state(csr.num_cols, 31 + lev)
        sweep(f"rw{suffix} L{lev} rows={csr.num_rows} "
              f"entries={csr.num_entries}", edge_csr.rw, (csr, q),
              [(s,) for s in edge_csr.RW_SHAPES], (edge_csr.rw.shape(csr),),
              lambda s: edge_csr.RW_SHAPES[s[0]],
              keep=f"edge_csr.rw{suffix} L{lev}")
        if hasattr(edge_csr, "FLUX_SHAPES"):
            sweep(f"flux{suffix} L{lev} rows={csr.num_rows} "
                  f"entries={csr.num_entries}", edge_csr.flux, (csr, q),
                  [(s,) for s in edge_csr.FLUX_SHAPES],
                  (edge_csr.flux.shape(csr),),
                  lambda s: edge_csr.FLUX_SHAPES[s[0]],
                  keep=f"edge_csr.flux{suffix} L{lev}")
    loads = {edge_csr.PLAIN: "plain", edge_csr.CHUNKED: "chunked",
             edge_csr.BATCHED: "batched"}
    for suffix, lev, rcsr, pcsr in transfers:
        for what, kern, csr in (("restrict", edge_csr.restrict, rcsr),
                                ("prolong", edge_csr.prolong, pcsr)):
            x = state(csr.num_cols, 21 + lev)
            sweep(f"wsum.{what}{suffix} L{lev} rows={csr.num_rows} "
                  f"entries={csr.num_entries}", kern, (csr, x),
                  [(edge_csr.WsumShape(split=sp, loads=ld),)
                   for sp in (False, True) for ld in loads],
                  (kern.shape(csr),),
                  lambda s: f"{'split' if s[0].split else 'row'}+"
                            f"{loads[s[0].loads]}")


def run_side(args) -> int:
    sys.path.insert(0, str(args.tree))
    import numpy as np
    import torch

    import mgcfd_tpu_torch
    from mgcfd_tpu_torch.bench.flagship import flagship_mesh
    from mgcfd_tpu_torch.core.config import SolverConfig
    from mgcfd_tpu_torch.core.constants import far_field_state
    from mgcfd_tpu_torch.kernels import DeviceCSR, build, edge_csr, shift
    from mgcfd_tpu_torch.ops.tops import build_dense_boundary_wall
    from mgcfd_tpu_torch.prep.csr import build_flux_csr
    from mgcfd_tpu_torch.prep.shift import build_shift_plan
    from mgcfd_tpu_torch.solver import MGCFDSolver
    from mgcfd_tpu_torch.validate.rounding import bf16_agreement
    where = Path(mgcfd_tpu_torch.__file__).resolve()
    if args.tree.resolve() not in where.parents:
        raise RuntimeError(f"imported {where}, not from {args.tree}")
    label, smi = args.label, card()
    only = tuple(args.only.split(","))
    print(f"{label}: {where.parent}; {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    if args.ptxas:
        ptxas_report(build, label, args.out)
        sass_report(build, label, args.out)
    build.library()

    # the flagship's and the tets' rows unless only visit rows are asked
    box = not visits_only(only)
    mesh = flagship_mesh() if box else SimpleNamespace(levels=[])
    box_flux = [build_flux_csr(L) for L in mesh.levels]
    dev = torch.device("cuda")
    # each level's stage operands: span plan, flux CSR, nc and a state
    stage_inputs = []
    for lev, lv in enumerate(mesh.levels):
        n = lv.num_nodes
        bdn, wln, wlc = build_dense_boundary_wall(
            n, lv.bedge_b, lv.bedge_w, lv.wedge_b, lv.wedge_w,
            far_field_state(np.float64)[1])
        rng = np.random.default_rng(1 + lev)
        stage_inputs.append((lev, lv, build_shift_plan(lv), box_flux[lev],
                             np.concatenate([bdn, wln, wlc]),
                             far_field_state(np.float64)[0][:, None]
                             + 0.05 * rng.standard_normal((5, n))))
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    one = torch.zeros(1, device=dev)
    floor = event_ms(lambda: one.add_(1), REPS)
    print(RECORD + json.dumps({"label": label, "kernel": "floor",
                               "warm_ms": floor, "card": smi}), flush=True)
    outputs = {}
    for tag, dt in zip(DTYPES, (torch.float32, torch.bfloat16,
                                torch.float64)):
        levels = MGCFDSolver(mesh, SolverConfig(
            dtype=str(dt).split(".")[-1], accumulate="pallas")).dmesh.levels \
            if box else []

        def state(m, seed, dt=dt):
            r = np.random.default_rng(seed)
            x = far_field_state(np.float64)[0][:, None] \
                + 0.05 * r.standard_normal((5, m))
            return torch.as_tensor(x).to(dev, dt)

        flux = [("", lev, DeviceCSR.from_plan(f, dev, dt))
                for lev, f in enumerate(box_flux)]
        tflux, tets = tet_csrs(args.tets, dt, dev) if box else ([], [])
        flux += tflux
        rows = [r for stage in stage_inputs
                for r in stage_rows(dt, *stage, dev)] \
            + level_rows(levels, flux, state) + wsum_rows(tets, state) \
            + cell_rows(level_files(args), dt, dev)
        rows = [r for r in rows if r[0].startswith(only)]
        for name, lev, kfn, pfn, nbytes in rows:
            got, again, want = kfn(), kfn(), pfn()
            torch.cuda.synchronize()
            inv = ""
            key = f"{name} L{lev} {tag}"
            if isinstance(got, tuple):
                inv = f", invalid {int(got[1])}/{int(want[1])}"
                outputs[f"{key} invalid"] = got[1].reshape(1).cpu()
                if len(got) == 3:
                    inv += (", residual bit-equal "
                            f"{same_share(got[2], want[2]):.4f}")
                    outputs[f"{key} residual"] = got[2].cpu()
                got, again, want = got[0], again[0], want[0]
            outputs[key] = got.cpu()
            ratio, _ = bf16_agreement(got, want)
            err = float((got.double() - want.double()).nan_to_num(
                0.0, 0.0, 0.0).abs().max())
            print(f"{label} {name} L{lev} {tag}: vs plain bit-equal "
                  f"{same_share(got, want):.4f}, max abs diff {err:.3e} "
                  f"({ratio:.3f} bf16 spacings){inv}, repeat bit-equal "
                  f"{same_share(got, again) == 1.0}", flush=True)
            if nbytes is None:
                continue
            rec = {"label": label, "kernel": name, "level": lev,
                   "dtype": tag, "warm_ms": event_ms(kfn, REPS),
                   "cold_ms": cold_ms(kfn, REPS, flush),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "mbytes": nbytes / 1e6, "card": smi}
            print(RECORD + json.dumps(rec), flush=True)
        if box and args.shapes and hasattr(edge_csr, "RW_SHAPES"):
            shape_sweep(label, tag, levels, flux,
                        flagship_transfers(levels) + tets, state, smi,
                        outputs, only)
        del levels, flux, tets
    if args.save is not None:
        torch.save(outputs, args.save)
    return 0


# --- the main process: both trees in turns ----------------------------------

def prebuild(tree: Path) -> str:
    """Build a tree's kernels (its build.build()) in a process of its
    own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from mgcfd_tpu_torch.kernels import build; "
            "p, s = build.build(); print(f'{p.name} {s:.1f} s')")
    r = subprocess.run([sys.executable, "-c", code, str(tree)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: {r.stderr[-2000:]}")
    return f"built {tree}: {r.stdout.strip()}"


def summarize(records, trees) -> None:
    """Each kernel's times per side: warm and cold readings, bound,
    share of the bound, and the launch floor."""
    floors = {lab: [x["warm_ms"] for x in records
                    if x["kernel"] == "floor" and x["label"] == lab]
              for lab in trees}
    for lab, f in floors.items():
        if f:
            print(f"floor {lab}: one-element add "
                  f"{' '.join(f'{v * 1e3:.2f}' for v in f)} us warm")
    keys = []
    for x in records:
        k = (x["kernel"], x.get("level"), x.get("dtype"))
        if x["kernel"] != "floor" and k not in keys:
            keys.append(k)
    for name, lev, tag in keys:
        for label in trees:
            rs = [x for x in records if x["label"] == label and
                  (x["kernel"], x.get("level"), x.get("dtype")) ==
                  (name, lev, tag)]
            if not rs:
                continue
            warm = [x["warm_ms"] for x in rs]
            cold = [x["cold_ms"] for x in rs]
            bound = rs[0]["bound_ms"]
            print(f"time {name} L{lev} {tag} {label}: warm "
                  f"{' '.join(f'{w * 1e3:.2f}' for w in warm)} us, cold "
                  f"{' '.join(f'{c * 1e3:.2f}' for c in cold)} us; "
                  f"bound {bound * 1e3:.2f} us ({rs[0]['mbytes']:.1f} "
                  f"MB); share warm {bound / min(warm):.3f} cold "
                  f"{bound / min(cold):.3f} [{rs[0]['card']}]",
                  flush=True)


def run_turns(args) -> int:
    import torch
    sys.path.insert(0, str(TREE))
    trees = {"new": TREE}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    order = ["parent", "new", "new", "parent"] if args.parent else ["new"]
    out = args.out or TREE / "build" / "kernel_ab"
    work = TREE / "build" / "kernel_ab"   # the outputs, tens of MB each
    for d in (out, work):
        d.mkdir(parents=True, exist_ok=True)
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(TETS), mp_context=spawn) as procs, \
            ThreadPoolExecutor(len(trees)) as pool:
        made = [procs.submit(make_tet, tet_path(work, suffix), *TETS[suffix])
                for suffix in TETS if not visits_only(args.only.split(","))]
        for line in pool.map(prebuild, trees.values()):
            print(line, flush=True)
        for m in made:
            m.result()
    for path in level_files(args):
        cell_facts(path)
    records, saved, seen = [], {}, set()
    for turn, label in enumerate(order):
        save = work / f"outputs_{label}.pt"
        cmd = [sys.executable, __file__, "--side", "--tree",
               str(trees[label]), "--label", label, "--save", str(save),
               "--out", str(out), "--tets", str(work)]
        if label not in seen:
            cmd.append("--ptxas")
            seen.add(label)
        if args.shapes:
            cmd.append("--shapes")
        if args.only:
            cmd += ["--only", args.only]
        if args.levels:
            cmd += ["--levels", args.levels]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=WORKER_TIMEOUT_S)
        sys.stderr.write(r.stderr[-4000:])
        for line in r.stdout.splitlines():
            if line.startswith(RECORD):
                records.append(json.loads(line[len(RECORD):]))
            else:
                print(f"[{turn + 1}] {line}", flush=True)
        if r.returncode != 0:
            print(f"kernel_ab: {label} side exited {r.returncode}",
                  file=sys.stderr)
            return r.returncode
        saved[label] = save
    summarize(records, trees)
    if "parent" in saved:
        a = torch.load(saved["new"])
        b = torch.load(saved["parent"])
        for key in a:
            if key.split(" shape=")[0] not in b:
                print(f"{key}: new only")
                continue
            want = b[key.split(" shape=")[0]]
            same = same_share(a[key], want)
            diff = float((a[key].double() - want.double()).nan_to_num(
                0.0, 0.0, 0.0).abs().max())
            print(f"{key}: new against parent, bit-equal {same:.4f}, max "
                  f"abs diff {diff:.3e}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, default=None,
                   help="root of the tree to compare with")
    p.add_argument("--out", type=Path, default=None,
                   help="where the ptxas reports go (default "
                   "build/kernel_ab, where the outputs go)")
    p.add_argument("--shapes", action="store_true",
                   help="also time the span, rw and wsum kernels at every "
                   "launch shape")
    p.add_argument("--only", default="", metavar="NAME",
                   help="only the kernels whose names start with NAME, "
                   "for example edge_csr.rw, or with one of a "
                   "comma-separated list of names")
    p.add_argument("--levels", default="", metavar="NPZ",
                   help="comma-separated .npz files of levels "
                   "(cfdbench/level_npz.py) on which to time the visit "
                   "rows")
    p.add_argument("--side", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--tree", type=Path, default=TREE, help=argparse.SUPPRESS)
    p.add_argument("--label", default="new", help=argparse.SUPPRESS)
    p.add_argument("--ptxas", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--save", type=Path, default=None, help=argparse.SUPPRESS)
    p.add_argument("--tets", type=Path, default=TREE / "build" / "kernel_ab",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    return run_side(args) if args.side else run_turns(args)


if __name__ == "__main__":
    sys.exit(main())
