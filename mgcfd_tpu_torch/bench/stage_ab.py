"""The two fused RK-stage kernels of this tree against those of another
tree, on the card, at the box flagship's level-0 shapes.

    python mgcfd_tpu_torch/bench/stage_ab.py [--parent TREE] [--out DIR]

TREE is the root of another checkout of the repository, for example an
earlier commit unpacked with `git archive <commit> mgcfd_tpu_torch | tar
-x -C build/parent_tree` into a gitignored directory. Each side runs in
a process of its own that imports mgcfd_tpu_torch from its tree and calls
its wrappers (shift.fused_stage and fused_stage), so any version of the
kernels whose wrappers take (plan, nc, q, old, fac) can be compared. The
processes run in turns, parent, new, new, parent (new alone without
--parent), after both trees' kernels are built in parallel.

What each process does, for fp32, bf16 and fp64:
  1. on its tree's first turn, prints nvcc -Xptxas -v for the two
     kernels (registers, spills, shared memory), the whole report into
     --out (default build/stage_ab);
  2. holds each kernel to its plain version (the share of bit-equal
     elements, the largest difference, the invalid counts) and two
     launches to each other;
  3. times each kernel warm (CUDA events around REPS back-to-back
     launches, so the operands that fit stay in the 50 MB L2) and cold
     (a 128 MB buffer written before each launch, each launch timed by
     its own event pair, the median), beside the byte bound at 3.35
     TB/s.
Then the main process prints each side's times and shares and whether
the two trees' outputs are bit-equal. Needs a CUDA device. Prints the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 128 * 2 ** 20
REPS = 20
KERNELS = ("fused_stage.cu", "shift_fused_stage.cu")
DTYPES = ("fp32", "bf16", "fp64")
TREE = Path(__file__).resolve().parents[2]
WORKER_TIMEOUT_S = 600
RECORD = "STAGE_AB "


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip()


# --- one side, in its own process ------------------------------------------

def ptxas_report(build, label: str, out: Path | None) -> None:
    """nvcc -Xptxas -v of the two kernels: one line per instantiation."""
    text = []
    for name in KERNELS:
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
                kind = ("bf16" if "bfloat16" in entry else
                        "fp64" if re.search(r"kernelIdE", entry) else "fp32")
                print(f"{label} ptxas {name:22s} {kind}: {line.strip()}")
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


def run_side(args) -> int:
    sys.path.insert(0, str(args.tree))
    import numpy as np
    import torch

    import mgcfd_tpu_torch
    from mgcfd_tpu_torch.bench.flagship import flagship_mesh
    from mgcfd_tpu_torch.core.constants import far_field_state
    from mgcfd_tpu_torch.kernels import DeviceCSR, DeviceShift, build, shift
    from mgcfd_tpu_torch.kernels.fused_stage import (fused_stage,
                                                     fused_stage_plain)
    from mgcfd_tpu_torch.ops.tops import build_dense_boundary_wall
    from mgcfd_tpu_torch.prep.csr import build_flux_csr
    from mgcfd_tpu_torch.prep.shift import build_shift_plan
    from mgcfd_tpu_torch.validate.rounding import bf16_agreement
    where = Path(mgcfd_tpu_torch.__file__).resolve()
    if args.tree.resolve() not in where.parents:
        raise RuntimeError(f"imported {where}, not from {args.tree}")
    label, smi = args.label, card()
    print(f"{label}: {where.parent}; {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    if args.ptxas:
        ptxas_report(build, label, args.out)
    build.library()

    lv = flagship_mesh().levels[0]
    n = lv.num_nodes
    dev = torch.device("cuda")
    splan, cplan = build_shift_plan(lv), build_flux_csr(lv)
    bdn, wln, wlc = build_dense_boundary_wall(
        n, lv.bedge_b, lv.bedge_w, lv.wedge_b, lv.wedge_w,
        far_field_state(np.float64)[1])
    rng = np.random.default_rng(1)
    q64 = far_field_state(np.float64)[0][:, None] \
        + 0.05 * rng.standard_normal((5, n))
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    outputs = {}
    for tag, dt in zip(DTYPES, (torch.float32, torch.bfloat16,
                                torch.float64)):
        sz = torch.tensor([], dtype=dt).element_size()
        sh = DeviceShift.from_plan(splan, n, dev, dt)
        csr = DeviceCSR.from_plan(cplan, dev, dt)
        nc = torch.as_tensor(np.concatenate([bdn, wln, wlc])).to(dev, dt)
        q = torch.as_tensor(q64).to(dev, dt)
        old = q + 1e-6 * q
        fac = torch.full((n,), 1e-3, dtype=dt, device=dev)
        D = len(sh.deltas)
        rows = [
            ("shift.fused_stage",
             lambda: shift.fused_stage(sh, nc, q, old, fac),
             lambda: shift.shift_fused_stage_plain(sh, nc, q, old, fac),
             sz * n * (5 + 4 * D + 5 + 1 + 11 + 5) + 4),
            ("fused_stage",
             lambda: fused_stage(csr, nc, q, old, fac),
             lambda: fused_stage_plain(csr, nc, q, old, fac),
             4 * (n + 1) + 4 * csr.num_entries + sz * 4 * csr.num_entries
             + sz * n * (5 + 5 + 1 + 11 + 5) + 4),
        ]
        for name, kfn, pfn, nbytes in rows:
            got, got_inv = kfn()
            again, _ = kfn()
            want, want_inv = pfn()
            torch.cuda.synchronize()
            outputs[f"{name} {tag}"] = got.cpu()
            ratio, same = bf16_agreement(got, want)
            err = float((got.double() - want.double()).abs().max())
            print(f"{label} {name} {tag}: vs plain bit-equal {same:.4f}, "
                  f"max abs diff {err:.3e} ({ratio:.3f} bf16 spacings), "
                  f"invalid {int(got_inv)}/{int(want_inv)}, repeat "
                  f"bit-equal {torch.equal(got, again)}", flush=True)
            rec = {"label": label, "kernel": name, "dtype": tag,
                   "warm_ms": event_ms(kfn, REPS),
                   "cold_ms": cold_ms(kfn, REPS, flush),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "mbytes": nbytes / 1e6, "card": smi}
            print(RECORD + json.dumps(rec), flush=True)
    if args.save is not None:
        torch.save(outputs, args.save)
    return 0


# --- the main process: both trees in turns ----------------------------------

def prebuild(tree: Path) -> str:
    """Build a tree's kernels (one nvcc call) in a process of its own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from mgcfd_tpu_torch.kernels import build; "
            "p, s = build.build(); print(f'{p.name} {s:.1f} s')")
    r = subprocess.run([sys.executable, "-c", code, str(tree)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: {r.stderr[-2000:]}")
    return f"built {tree}: {r.stdout.strip()}"


def run_turns(args) -> int:
    import torch
    trees = {"new": TREE}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    order = ["parent", "new", "new", "parent"] if args.parent else ["new"]
    out = args.out or TREE / "build" / "stage_ab"
    work = TREE / "build" / "stage_ab"   # the outputs, tens of MB each
    for d in (out, work):
        d.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(trees)) as pool:
        for line in pool.map(prebuild, trees.values()):
            print(line, flush=True)
    records, saved, seen = [], {}, set()
    for turn, label in enumerate(order):
        save = work / f"outputs_{label}.pt"
        cmd = [sys.executable, __file__, "--side", "--tree",
               str(trees[label]), "--label", label, "--save", str(save),
               "--out", str(out)]
        if label not in seen:
            cmd.append("--ptxas")
            seen.add(label)
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=WORKER_TIMEOUT_S)
        sys.stderr.write(r.stderr[-4000:])
        for line in r.stdout.splitlines():
            if line.startswith(RECORD):
                records.append(json.loads(line[len(RECORD):]))
            else:
                print(f"[{turn + 1}] {line}", flush=True)
        if r.returncode != 0:
            print(f"stage_ab: {label} side exited {r.returncode}",
                  file=sys.stderr)
            return r.returncode
        saved[label] = save
    for tag in DTYPES:
        for name in ("shift.fused_stage", "fused_stage"):
            mine = [x for x in records
                    if x["kernel"] == name and x["dtype"] == tag]
            for label in trees:
                rs = [x for x in mine if x["label"] == label]
                if not rs:
                    continue
                warm = [x["warm_ms"] for x in rs]
                cold = [x["cold_ms"] for x in rs]
                bound = rs[0]["bound_ms"]
                print(f"time {name} {tag} {label}: warm "
                      f"{' '.join(f'{w * 1e3:.2f}' for w in warm)} us, cold "
                      f"{' '.join(f'{c * 1e3:.2f}' for c in cold)} us; "
                      f"bound {bound * 1e3:.2f} us ({rs[0]['mbytes']:.1f} "
                      f"MB); share warm {bound / min(warm):.3f} cold "
                      f"{bound / min(cold):.3f} [{rs[0]['card']}]",
                      flush=True)
    if "parent" in saved:
        a = torch.load(saved["new"])
        b = torch.load(saved["parent"])
        for key in a:
            same = float((a[key] == b[key]).double().mean())
            print(f"{key}: new against parent, bit-equal {same:.4f}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", type=Path, default=None,
                   help="root of the tree to compare with")
    p.add_argument("--out", type=Path, default=None,
                   help="where the ptxas reports go (default "
                   "build/stage_ab, where the outputs go)")
    p.add_argument("--side", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--tree", type=Path, default=TREE, help=argparse.SUPPRESS)
    p.add_argument("--label", default="new", help=argparse.SUPPRESS)
    p.add_argument("--ptxas", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--save", type=Path, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("stage_ab: no CUDA device", file=sys.stderr)
        return 1
    return run_side(args) if args.side else run_turns(args)


if __name__ == "__main__":
    sys.exit(main())
