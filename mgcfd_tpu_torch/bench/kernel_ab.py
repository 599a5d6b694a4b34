"""The kernels of this tree against those of another tree, on the card, at
the box flagship's shapes and two RCM-ordered tets' CSRs.

    python mgcfd_tpu_torch/bench/kernel_ab.py [--parent TREE] [--out DIR]
        [--shapes]

TREE is the root of another checkout of the repository, for example an
earlier commit unpacked with `git archive <commit> mgcfd_tpu_torch | tar
-x -C build/parent_tree` into a gitignored directory. Each side runs in
a process of its own that imports mgcfd_tpu_torch from its tree and calls
its wrappers, so any version of the kernels whose wrappers take the same
operands can be compared:
  - the two fused RK-stage kernels, shift.fused_stage and fused_stage, at
    level 0 (plan, nc, q, old, fac), each also as a visit's last stage:
    with the parent's eager ops after it (suffix +eager: q - old and the
    int64 add of the count) and, where the tree's wrappers take them,
    with its epilogues instead (suffix +epilogue: the residual and the
    count stored by the kernel);
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
    as the kernel's epilogue (suffix +epilogue).
The processes run in turns, parent, new, new, parent (new alone without
--parent), after both trees' kernels are built in parallel.

What each process does, for fp32, bf16 and fp64:
  1. on its tree's first turn, prints nvcc -Xptxas -v for the kernels'
     sources (registers, spills, shared memory), the whole report into
     --out (default build/kernel_ab);
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


def takes_epilogues(fn) -> bool:
    """Whether a wrapper of this tree takes the epilogues' operands."""
    import inspect
    params = inspect.signature(fn).parameters
    return "residual" in params or "keep" in params


def stage_rows(dt, lv, splan, cplan, nc64, q64, dev):
    """The two stage kernels at level 0: (name, level, kernel, plain,
    bytes); each returns (out, invalid count), the +eager and +epilogue
    rows (out, invalid count, residual)."""
    import torch
    from mgcfd_tpu_torch.kernels import DeviceCSR, DeviceShift, shift
    from mgcfd_tpu_torch.kernels.fused_stage import (fused_stage,
                                                     fused_stage_plain)
    n = lv.num_nodes
    sz = torch.empty((), dtype=dt).element_size()
    sh = DeviceShift.from_plan(splan, n, dev, dt)
    csr = DeviceCSR.from_plan(cplan, dev, dt)
    nc = torch.as_tensor(nc64).to(dev, dt)
    q = torch.as_tensor(q64).to(dev, dt)
    old = q + 1e-6 * q
    fac = torch.full((n,), 1e-3, dtype=dt, device=dev)
    D = len(sh.deltas)
    stages = [
        ("shift.fused_stage",
         lambda **e: shift.fused_stage(sh, nc, q, old, fac, **e),
         lambda: shift.shift_fused_stage_plain(sh, nc, q, old, fac),
         sz * n * (5 + 4 * D + 5 + 1 + 11 + 5) + 4, shift.fused_stage),
        ("fused_stage", lambda **e: fused_stage(csr, nc, q, old, fac, **e),
         lambda: fused_stage_plain(csr, nc, q, old, fac),
         4 * (n + 1) + 4 * csr.num_entries + sz * 4 * csr.num_entries
         + sz * n * (5 + 5 + 1 + 11 + 5) + 4, fused_stage),
    ]

    def eager(kern):
        """The parent's last stage of a visit: the kernel, q - old and
        the count added to the visit's int64."""
        total = torch.zeros((), dtype=torch.int64, device=dev)
        out, inv = kern()
        return out, total + inv, out - old

    def epilogue(kern):
        count = torch.zeros((), dtype=torch.int64, device=dev)
        return kern(count=count, residual=True)

    rows = []
    for name, kern, plain, nbytes, wrapper in stages:
        # the residual written, and the count as an int64
        tail = sz * 5 * n + 4
        rows += [(name, 0, kern, plain, nbytes),
                 (f"{name}+eager", 0, lambda k=kern: eager(k),
                  lambda k=kern: eager(k), nbytes + tail)]
        if takes_epilogues(wrapper.__call__):
            rows.append((f"{name}+epilogue", 0, lambda k=kern: epilogue(k),
                         lambda k=kern: eager(k), nbytes + tail))
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
    build.library()

    mesh = flagship_mesh()
    box_flux = [build_flux_csr(L) for L in mesh.levels]
    lv = mesh.levels[0]
    n = lv.num_nodes
    dev = torch.device("cuda")
    splan, cplan = build_shift_plan(lv), build_flux_csr(lv)
    bdn, wln, wlc = build_dense_boundary_wall(
        n, lv.bedge_b, lv.bedge_w, lv.wedge_b, lv.wedge_w,
        far_field_state(np.float64)[1])
    nc64 = np.concatenate([bdn, wln, wlc])
    rng = np.random.default_rng(1)
    q64 = far_field_state(np.float64)[0][:, None] \
        + 0.05 * rng.standard_normal((5, n))
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    one = torch.zeros(1, device=dev)
    floor = event_ms(lambda: one.add_(1), REPS)
    print(RECORD + json.dumps({"label": label, "kernel": "floor",
                               "warm_ms": floor, "card": smi}), flush=True)
    outputs = {}
    for tag, dt in zip(DTYPES, (torch.float32, torch.bfloat16,
                                torch.float64)):
        levels = MGCFDSolver(mesh, SolverConfig(
            dtype=str(dt).split(".")[-1], accumulate="pallas")).dmesh.levels

        def state(m, seed, dt=dt):
            r = np.random.default_rng(seed)
            x = far_field_state(np.float64)[0][:, None] \
                + 0.05 * r.standard_normal((5, m))
            return torch.as_tensor(x).to(dev, dt)

        flux = [("", lev, DeviceCSR.from_plan(f, dev, dt))
                for lev, f in enumerate(box_flux)]
        tflux, tets = tet_csrs(args.tets, dt, dev)
        flux += tflux
        rows = stage_rows(dt, lv, splan, cplan, nc64, q64, dev) \
            + level_rows(levels, flux, state) + wsum_rows(tets, state)
        rows = [r for r in rows if r[0].startswith(only)]
        for name, lev, kfn, pfn, nbytes in rows:
            got, again, want = kfn(), kfn(), pfn()
            torch.cuda.synchronize()
            inv = ""
            if isinstance(got, tuple):
                inv = f", invalid {int(got[1])}/{int(want[1])}"
                if len(got) == 3:
                    inv += (", residual bit-equal "
                            f"{bf16_agreement(got[2], want[2])[1]:.4f}")
                got, again, want = got[0], again[0], want[0]
            outputs[f"{name} L{lev} {tag}"] = got.cpu()
            ratio, same = bf16_agreement(got, want)
            err = float((got.double() - want.double()).abs().max())
            print(f"{label} {name} L{lev} {tag}: vs plain bit-equal "
                  f"{same:.4f}, max abs diff {err:.3e} ({ratio:.3f} bf16 "
                  f"spacings){inv}, repeat bit-equal "
                  f"{torch.equal(got, again)}", flush=True)
            rec = {"label": label, "kernel": name, "level": lev,
                   "dtype": tag, "warm_ms": event_ms(kfn, REPS),
                   "cold_ms": cold_ms(kfn, REPS, flush),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "mbytes": nbytes / 1e6, "card": smi}
            print(RECORD + json.dumps(rec), flush=True)
        if args.shapes and hasattr(edge_csr, "RW_SHAPES"):
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
                for suffix in TETS]
        for line in pool.map(prebuild, trees.values()):
            print(line, flush=True)
        for m in made:
            m.result()
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
            same = float((a[key] == want).double().mean())
            diff = float((a[key].double() - want.double()).abs().max())
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
