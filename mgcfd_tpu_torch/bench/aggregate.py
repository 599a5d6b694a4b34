"""Benchmark result aggregation (mgcfd_tpu/bench/aggregate.py): walk the
job directories, collate each job's Times.csv and LoopNumIters.csv (the
identification-prefix schema of monitor/csvout.py), average over
repeats, and derive throughput metrics:

  iters/sec per function = iterations / seconds   (the headline)
  GFLOPs/sec, GB/sec     = from KernelCosts.csv's MODEL_OPERATIONS and
                           MODEL_BYTES rows (monitor/costs.py, per call)
                           times its CALLS row, where mgcfd_tpu reads
                           XLA's cost analysis from XLACosts.csv

Output: all-data-combined.csv, one row per configuration x function x
level. mgcfd_tpu's analyze_hlo (the static instruction mix of each
kernel's optimized HLO, from --dump-hlo) has no counterpart: the port
compiles no XLA program, and its jobs dump no HLO.
"""
from __future__ import annotations

import csv
import os
import sys
from collections import defaultdict

from ..monitor.csvout import COSTS_FILE, ID_COLUMNS, KERNEL_COLUMNS

ID_COLS = ID_COLUMNS
KERNELS = KERNEL_COLUMNS

# Peak device rates for the utilisation columns, keyed by the card's name
# as the CSV's 'Instruction set' field holds it (torch.cuda.
# get_device_name): (peak FLOP/s, peak memory B/s). NVIDIA H100 SXM5
# 80 GB data sheet: 3.35 TB/s HBM3 and 67 TFLOP/s fp32 (non-tensor; the
# flux and transfer kernels' math is fp32 or fp64 on the CUDA cores). Any
# other name gives (0, 0).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}


def device_peaks(device_kind: str):
    """-> (peak_flops, peak_bw), or (0, 0) for a device not listed."""
    return DEVICE_PEAKS.get(device_kind or "", (0.0, 0.0))


def _read_wide_csv(path: str):
    with open(path) as f:
        rows = list(csv.reader(f))
    if len(rows) < 2:
        return None
    header = [h for h in rows[0] if h != ""]
    out = []
    for row in rows[1:]:
        if not row or all(c == "" for c in row):
            continue
        out.append(dict(zip(header, row)))
    return header, out


def _split_kernel_cols(header):
    """-> {(function, level): column name}"""
    out = {}
    for col in header:
        for k in KERNELS:
            if col.startswith(k) and col[len(k):].isdigit():
                out[(k, int(col[len(k):]))] = col
    return out


def _read_costs(path):
    """KernelCosts.csv -> {(function, level): (operations, bytes, calls)},
    operations and bytes per call."""
    r = _read_wide_csv(path)
    if r is None:
        return {}
    header, rows = r
    kcols = _split_kernel_cols(header)
    by_event = {row.get("Event", ""): row for row in rows}
    ops = by_event.get("MODEL_OPERATIONS", {})
    by = by_event.get("MODEL_BYTES", {})
    ca = by_event.get("CALLS", {})
    return {key: (float(ops.get(col, 0) or 0), float(by.get(col, 0) or 0),
                  float(ca.get(col, 0) or 0))
            for key, col in kcols.items()}


def collate(jobs_dir: str):
    """-> records, one per (job, function, level) with the id columns,
    seconds, iterations and the run's operations and bytes."""
    records = []
    for root, dirs, files in os.walk(jobs_dir):
        if "Times.csv" not in files:
            continue
        t = _read_wide_csv(os.path.join(root, "Times.csv"))
        if t is None:
            continue
        i = _read_wide_csv(os.path.join(root, "LoopNumIters.csv")) \
            if "LoopNumIters.csv" in files else None
        costs = _read_costs(os.path.join(root, COSTS_FILE)) \
            if COSTS_FILE in files else {}
        theader, trows = t
        kcols = _split_kernel_cols(theader)
        irows = i[1] if i else []
        for ridx, trow in enumerate(trows):
            irow = irows[ridx] if ridx < len(irows) else {}
            ident = {c: trow.get(c, "") for c in ID_COLS}
            for (kernel, level), col in kcols.items():
                secs = float(trow.get(col, 0) or 0)
                iters = float(irow.get(col, 0) or 0)
                if secs == 0 and iters == 0:
                    continue
                ops, by, calls = costs.get((kernel, level), (0.0, 0.0, 0.0))
                records.append({**ident, "job": os.path.basename(root),
                                "kernel": kernel, "level": level,
                                "seconds": secs, "iterations": iters,
                                "flops_total": ops * calls,
                                "bytes_total": by * calls,
                                "total": float(trow.get("Total", 0) or 0)})
    return records


def _repeat_key(rec):
    """Everything identifying but the repeat index (job names end in .rN,
    gen_job.job_name)."""
    job = rec["job"]
    base = job.rsplit(".r", 1)[0] if ".r" in job else job
    return (base, rec["kernel"], rec["level"],
            tuple(rec[c] for c in ID_COLS))


def aggregate(records):
    groups = defaultdict(list)
    for r in records:
        groups[_repeat_key(r)].append(r)
    out = []
    for (base, kernel, level, ident_vals), rs in sorted(groups.items()):
        secs = [r["seconds"] for r in rs]
        iters = [r["iterations"] for r in rs]
        n = len(rs)
        mean_s = sum(secs) / n
        mean_i = sum(iters) / n
        std_s = (sum((x - mean_s) ** 2 for x in secs) / n) ** 0.5
        rec = dict(zip(ID_COLS, ident_vals))
        mean_fl = sum(r["flops_total"] for r in rs) / n
        mean_by = sum(r["bytes_total"] for r in rs) / n
        peak_fl, peak_bw = device_peaks(rec.get("Instruction set", ""))
        flops_sec = (mean_fl / mean_s) if mean_s else 0.0
        bytes_sec = (mean_by / mean_s) if mean_s else 0.0
        rec.update({
            "config": base, "kernel": kernel, "level": level,
            "num repeats": n,
            "seconds mean": mean_s,
            "seconds std pct": (100.0 * std_s / mean_s) if mean_s else 0.0,
            "iterations": mean_i,
            "iters/sec": (mean_i / mean_s) if mean_s else 0.0,
            "GFLOPs/sec": flops_sec / 1e9,
            "GB/sec": bytes_sec / 1e9,
            "Flops/Byte": (mean_fl / mean_by) if mean_by else 0.0,
            "pct peak FLOPs": (100.0 * flops_sec / peak_fl)
            if peak_fl else 0.0,
            "pct peak HBM": (100.0 * bytes_sec / peak_bw)
            if peak_bw else 0.0,
            "flops/iter": (mean_fl / mean_i) if mean_i else 0.0,
            "bytes/iter": (mean_by / mean_i) if mean_i else 0.0,
            "total mean": sum(r["total"] for r in rs) / n,
        })
        out.append(rec)
    return out


def write_combined(out_path: str, rows) -> str:
    if not rows:
        raise SystemExit("no Times.csv found under the jobs directory")
    cols = list(rows[0].keys())
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    return out_path


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="collate and aggregate the jobs' CSV reports")
    p.add_argument("--jobs-dir", required=True)
    p.add_argument("--output", default=None,
                   help="default: <jobs-dir>/all-data-combined.csv")
    args = p.parse_args(argv)
    rows = aggregate(collate(args.jobs_dir))
    out = args.output or os.path.join(args.jobs_dir,
                                      "all-data-combined.csv")
    path = write_combined(out, rows)
    print(f"combined data written to {path} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
