"""One run of one cell of BENCHMARK.json, on the card:

    python3 -m cfdbench.run --workload CELL --seed N --seconds S --trace 0|1

It makes the cell's mesh files once per checkout (cfdbench/.cache/), then
loads them through the port as its CLI does (the parse, then -m's
duplication, then --renumber's ordering where the configuration asks for
it: order.py), builds MGCFDSolver from the configuration, hands it the
initial state drawn from --seed, and runs the mix's entry: the first call
from that state is the one the reference checks, and it and the mix's
warm-up calls (CUDA graph capture, first replay) are set-up. With
--trace 0 it then calls the entry back to back for --seconds and reports
the cell's end-to-end metrics; with --trace 1 it profiles a few calls
instead and reports the cell's per-layer metrics, each read by
metrics/<name>.py from the run's record. Then, with the program freed,
the float64 reference runs the checked cycles and check.py decides
`correct`. The last stdout line is the result as JSON; the numbers
compared, each with its limit, are the last stderr lines.

It exits 2 and prints no result without a card (or with fewer than the
cell's chips), 3 if jax, jaxlib, flax or mgcfd_tpu was imported, 4
without the program, mgcfd_tpu_torch, and 5 when a per-layer metric the
cell lists reads nothing. A configuration or mix with a key the harness
does not apply is refused before anything runs.
"""
import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the mesh files, the port's sidecars and plan cache, per configuration
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "mgcfd_tpu")
# the SolverConfig fields a configuration may set: each is applied by
# MGCFDSolver itself and leaves the numbers the reference computes as
# they are (the CLI's own fields, such as mesh_duplicate_count, are not)
SOLVER_KEYS = {"dtype", "accumulate", "fuse_stage", "fuse_window_stage",
               "mg_gather", "check_invalid_every"}
# the load step of the CLI (cli/main.py) a configuration sets: -m always,
# --renumber where it says so
LOAD_KEYS = {"duplicate"}
LOAD_OPTIONAL = {"renumber"}
# the solver's entries a mix may drive, and what it states besides
ENTRIES = ("run", "run_batched")
MIX_KEYS = {"entry", "args", "warmup_calls", "trace_calls",
            "production_cycles", "window_metric", "why"}


class NoCard(RuntimeError):
    pass


class Card:
    """The CUDA device a run measures on, and what the run asks of it."""

    platform = "gpu"

    def __init__(self, chips: int):
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise NoCard(f"this cell needs {chips} CUDA device(s); "
                         f"torch.cuda.is_available() is "
                         f"{torch.cuda.is_available()}, device_count() is "
                         f"{torch.cuda.device_count()}")
        self.device = torch.device("cuda", 0)

    def kind(self) -> str:
        import torch
        return torch.cuda.get_device_name(self.device)

    def sync(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch
        return torch.cuda.max_memory_allocated(self.device)

    def release(self) -> None:
        import torch
        torch.cuda.empty_cache()

    def trace(self, fn):
        """(summary of the device's records while fn() ran, fn's host
        seconds); the summary is None when the device recorded nothing."""
        from torch.profiler import ProfilerActivity

        from cfdbench.trace import profile, summarise
        events, wall = profile(fn, self.sync, [ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
        return summarise(events), wall


def require_card(chips: int) -> Card:
    return Card(chips)


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this
    module's import began."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def check_config(config: dict, mix: dict) -> None:
    """ValueError for a key the harness would not apply, so that no cell
    runs under a label its run does not carry out."""
    from cfdbench import check
    from cfdbench.inputs.make import check_spec

    check_spec(config["mesh"])
    bad = []
    if set(config["solver"]) - SOLVER_KEYS:
        bad.append(f"solver keys {sorted(set(config['solver']) - SOLVER_KEYS)}"
                   f" (the harness applies {sorted(SOLVER_KEYS)})")
    if set(config["control"]) - SOLVER_KEYS:
        bad.append(f"control keys {sorted(config['control'])} (a control "
                   f"sets solver keys)")
    load = config["load"]
    if not LOAD_KEYS <= set(load) <= LOAD_KEYS | LOAD_OPTIONAL:
        bad.append(f"load keys {sorted(load)} (it takes {sorted(LOAD_KEYS)}"
                   f" and may take {sorted(LOAD_OPTIONAL)})")
    elif not isinstance(load.get("renumber", False), bool):
        bad.append(f"load renumber {load['renumber']!r} (true or false)")
    elif load.get("renumber") and load["duplicate"] != 1:
        bad.append(f"load renumber with duplicate {load['duplicate']} (the "
                   f"copies repeat coordinates, which map the port's order "
                   f"to the files')")
    if not set(check.NAMES) <= set(config["limits"]) \
            <= set(check.NAMES + check.OPTIONAL):
        bad.append(f"limits {sorted(config['limits'])} (check.py compares "
                   f"{list(check.NAMES)} and may compare "
                   f"{list(check.OPTIONAL)})")
    if set(mix) != MIX_KEYS or mix["entry"] not in ENTRIES:
        bad.append(f"mix keys {sorted(set(mix) ^ MIX_KEYS)} or entry "
                   f"{mix.get('entry')!r} (entries {ENTRIES})")
    if bad:
        raise ValueError(f"configuration {config['name']!r}: "
                         + "; ".join(bad))


def cell_spec(name: str) -> dict:
    """The cell, its configuration, its mix and the metrics it reports,
    each found by the name BENCHMARK.json gives."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]

    def mine(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and ("workloads" in m or m["moves"] in moved)]
    spec = {"cell": cell,
            "config": load_json(HERE, "configs", cell["config"] + ".json"),
            "mix": load_json(HERE, "mixes", cell["traffic"] + ".json"),
            "end_to_end": e2e, "per_layer": layer}
    check_config(spec["config"], spec["mix"])
    return spec


def power_limit() -> str:
    """nvidia-smi's power limit of the card, or why there is none."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() \
            else f"nvidia-smi: {r.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def cycles_per_call(mix: dict) -> int:
    return mix["args"]["cycles"]


def make_call(solver, mix: dict):
    """The mix's entry with its arguments, as a call."""
    entry, args = getattr(solver, mix["entry"]), mix["args"]
    return lambda: entry(**args)


def mesh_files(config: dict) -> str:
    """input.dat of the configuration's mesh, written on the first run
    in a checkout."""
    from cfdbench.inputs.make import ensure
    return ensure(config["mesh"],
                  os.path.join(CACHE, config["name"], "mesh"))


def port_mesh(config: dict, input_dat: str):
    """The port's mesh as its CLI loads it: the parse (through its
    .meshcache/ sidecars), then -m's duplication."""
    from mgcfd_tpu_torch.mesh import duplicate_mesh
    from mgcfd_tpu_torch.mesh.io_dat import load_multigrid_mesh

    mesh = load_multigrid_mesh(input_dat)
    sizes = [lv.num_nodes for lv in mesh.levels]
    if sizes != config["nodes"]:
        raise ValueError(f"the mesh's levels have {sizes} nodes, the "
                         f"configuration states {config['nodes']}")
    return duplicate_mesh(mesh, config["load"]["duplicate"])


def reference_mesh(config: dict, input_dat: str):
    """The same mesh by the benchmark's own reader and duplication."""
    from cfdbench.inputs.datfiles import read_hierarchy
    from cfdbench.inputs.duplicate import duplicate_hierarchy

    return duplicate_hierarchy(read_hierarchy(input_dat),
                               config["load"]["duplicate"])


def solver_config(config: dict, **override):
    from mgcfd_tpu_torch.core.config import SolverConfig
    return SolverConfig(
        plan_cache_dir=os.path.join(CACHE, config["name"], "plans"),
        **(config["solver"] | override))


def snapshot(solver) -> dict:
    """The solver's state (node-major, float64) and RMS history."""
    import numpy as np
    state = solver._state_node_major()
    return {k: [np.asarray(a, np.float64) for a in v]
            for k, v in state.items()} | {"rms": list(solver.rms_history)}


def load_reader(name: str):
    """metrics/<name>.py's read(record)."""
    spec = importlib.util.spec_from_file_location(
        "cfdbench_metric_" + name.replace(".", "_").replace("-", "_"),
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def measure(spec: dict, args, card: Card, record: dict) -> dict:
    """Set-up, the window or the traced calls, and the checked call's
    outputs; fills `record` and returns the outputs."""
    from mgcfd_tpu_torch.solver import MGCFDSolver
    from cfdbench.order import renumbered
    from cfdbench.state import initial_state

    config, mix = spec["config"], spec["mix"]
    t0 = time.perf_counter()
    input_dat = mesh_files(config)
    t1 = time.perf_counter()
    mesh = port_mesh(config, input_dat)
    t2 = time.perf_counter()
    mesh, order, order_spans = renumbered(config, mesh, input_dat)
    record["nodes"] = sizes = [lv.num_nodes for lv in mesh.levels]
    s0 = initial_state(sizes, args.seed, config["state"])
    t3 = time.perf_counter()
    solver = MGCFDSolver(mesh, solver_config(config), device=card.device)
    solver.load_state(order.to_port(s0))
    call = make_call(solver, mix)
    call()
    checked = order.to_file(snapshot(solver))
    for _ in range(mix["warmup_calls"]):
        call()
    card.sync()
    t4 = time.perf_counter()
    record["spans"] = {"inputs_s": t1 - t0, "mesh_load_s": t2 - t1,
                       "prep_s": t4 - t3} | order_spans
    record["e2e"] = {"setup_s": process_age_s()}
    record["accumulate"] = solver.config.accumulate
    k = cycles_per_call(mix)
    record["attempted"] = 0
    if not args.trace:
        stamps = [time.perf_counter()]
        while True:
            record["attempted"] += k
            call()
            stamps.append(time.perf_counter())
            if stamps[-1] - stamps[0] >= args.seconds:
                break
        card.sync()
        wall = time.perf_counter() - stamps[0]
        record["e2e"][mix["window_metric"]] = wall / record["attempted"] \
            * 1e3
        record["window_s"] = wall
        # how steady the window was: ms a call at its quartiles and ends
        calls = sorted(b - a for a, b in zip(stamps, stamps[1:]))
        record["call_ms"] = [1e3 * calls[int(q * (len(calls) - 1))]
                             for q in (0.0, 0.25, 0.5, 0.75, 1.0)]
    else:
        from mgcfd_tpu_torch.monitor.opstats import measure_production

        def traced():
            for _ in range(mix["trace_calls"]):
                record["attempted"] += k
                call()
        summary, wall = card.trace(traced)
        if summary is not None:
            summary["window_s"] = wall
            record["trace"] = summary
        if mix["production_cycles"]:
            measure_production(solver, 1)
            m = measure_production(solver, mix["production_cycles"])
            per = {}
            for (function, _), rec in m.functions.items():
                per[function] = per.get(function, 0.0) + rec["time_us"]
            record["functions"] = {f: us / mix["production_cycles"]
                                   for f, us in per.items()}
    record["memory_peak_bytes"] = card.memory_peak()
    del solver, call
    gc.collect()
    card.release()
    return {"input_dat": input_dat, "s0": s0, "checked": checked}


def reference_check(spec: dict, out: dict, card: Card,
                    record: dict) -> tuple:
    """The reference's cycles from the same state; check.py's verdict."""
    from cfdbench import check, counts
    from cfdbench.reference import ReferenceSolver

    t0 = time.perf_counter()
    mesh = reference_mesh(spec["config"], out["input_dat"])
    ref = ReferenceSolver(mesh, card.device).run(
        out["s0"], cycles_per_call(spec["mix"]))
    values = check.readings(out["s0"], out["checked"], ref)
    record["reference_s"] = time.perf_counter() - t0
    record["sizes"] = counts.level_sizes(mesh)
    return check.judge(values, spec["config"]["limits"])


def layer_metrics(spec: dict, record: dict, kind: str) -> tuple:
    """({metric: {"value", "unit"}} of the cell's per-layer metrics,
    [names of those whose reader found nothing to read])."""
    from cfdbench import counts
    peaks = load_json(HERE, "peaks.json").get(kind)
    dtype = spec["config"]["solver"].get("dtype", "float32")
    if peaks is not None and "sizes" in record:
        record["least"] = {f: counts.least_time(
            f, record["sizes"], dtype, peaks["bytes_per_s"],
            peaks["ops_per_s"][dtype]) for f in counts.FUNCTIONS}
    out, missing = {}, []
    for m in spec["per_layer"]:
        value = load_reader(m["name"])(record)
        if value is None:
            missing.append(m["name"])
        else:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out, missing


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = cell_spec(args.workload)
    try:
        card = require_card(spec["cell"]["chips"])
    except NoCard as e:
        print(f"cfdbench: {e}", file=sys.stderr)
        return 2
    try:
        import mgcfd_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"cfdbench: the program is missing: {e}", file=sys.stderr)
        return 4
    kind = card.kind()
    record = {"cell": spec["cell"], "mix": spec["mix"], "kind": kind}
    try:
        out = measure(spec, args, card, record)
    except Exception:       # the program failed: report it, not a number
        traceback.print_exc()
        out = None
    if out is None:
        correct, checks = False, {}
    else:
        correct, checks = reference_check(spec, out, card, record)
    metrics, missing = {}, []
    if out is not None and not args.trace:
        # a metric split by cells (cycle_ms.x8) reads its quantity
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {
                "value": record["e2e"][m["name"].split(".")[0]],
                "unit": m["unit"]}
    elif out is not None:
        metrics, missing = layer_metrics(spec, record, kind)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"cfdbench: the run imported {', '.join(found)}",
              file=sys.stderr)
        return 3
    if missing:
        print(f"cfdbench: {args.workload} lists {', '.join(missing)}, "
              f"which read nothing in this run (trace recorded: "
              f"{'trace' in record}; functions measured: "
              f"{sorted(record.get('functions', {}))}; peaks for "
              f"{kind!r}: {'least' in record})", file=sys.stderr)
        return 5
    device_rec = {"platform": card.platform, "kind": kind,
                  "count": spec["cell"]["chips"],
                  "memory_peak_bytes": record.get("memory_peak_bytes", 0)}
    result = {"correct": correct, "attempted": record.get("attempted", 0),
              "failed": 0 if out is not None
              else cycles_per_call(spec["mix"]),
              "metrics": metrics, "device": device_rec}
    tr = record.get("trace")
    if tr:
        device_rec["busy_s"] = tr["busy_s"]
        device_rec["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    # after the window, so that nvidia-smi's time stays out of setup_s
    print(f"cfdbench: {args.workload} on {kind}; {power_limit()}",
          file=sys.stderr)
    print(json.dumps({k: record[k] for k in ("nodes", "spans", "reference_s",
                                             "accumulate", "window_s",
                                             "call_ms") if k in record}),
          file=sys.stderr)
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0 if out is not None else 1


if __name__ == "__main__":
    sys.exit(main())
