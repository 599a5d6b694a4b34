"""The port's monitor (mgcfd_tpu_torch/monitor/) and the unfused window
stage it times, against mgcfd_tpu at fp64 on the CPU.

The JAX leg runs as tests/test_cli_monitor.py runs it: 'window' through
the Pallas kernels in interpret mode. The port runs its plain versions
(CPU tensors). Variables and RMS are held to identify_differences
(relative 1e-8); iteration and call counts, report columns and
LoopNumIters cells must be equal.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

from mgcfd_tpu.bench.aggregate import collate
from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.monitor import InstrumentedSolver as JaxInstrumented
from mgcfd_tpu.monitor.events import read_event_config as jax_read_events
from mgcfd_tpu.solver import MGCFDSolver as JaxSolver
from mgcfd_tpu_torch.cli.main import main as cli_main
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.mesh import write_multigrid_mesh
from mgcfd_tpu_torch.monitor import InstrumentedSolver
from mgcfd_tpu_torch.monitor import csvout, events, opstats
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.solver import solver as solver_mod
from mgcfd_tpu_torch.validate import identify_differences

torch.set_num_threads(1)
CYCLES = 2
PATHS = {"segment": {}, "window": {"accumulate": "window"},
         "shift-transposed": {"accumulate": "shift", "transposed": True}}
FUNCTIONS = ("compute_step", "flux", "time_step", "indirect_rw")
_MESHES: dict = {}
_JAX_RUNS: dict = {}


def jax_mesh(kind):
    if kind not in _MESHES:
        _MESHES[kind] = (jax_mg_box(6, 6, 6, 2, h=(0.1, 0.1, 0.1))
                         if kind == "box"
                         else jax_tet(8, 8, 8, 2, seed=1, h=0.1))
    return _MESHES[kind]


def jax_instrumented(kind, path, tmp_path_factory):
    """JAX's InstrumentedSolver after CYCLES cycles and its reports,
    once per module."""
    key = (kind, path)
    if key not in _JAX_RUNS:
        s = JaxInstrumented(jax_mesh(kind),
                            JaxConfig(dtype="float64", **PATHS[path]))
        s.run(CYCLES)
        d = tmp_path_factory.mktemp(f"jax_{kind}_{path}")
        _JAX_RUNS[key] = (s, s.write_reports(str(d) + "/",
                                             include_costs=False))
    return _JAX_RUNS[key]


def port_instrumented(kind, path="segment", **kw):
    return InstrumentedSolver(
        mesh_from_arrays(jax_mesh(kind)),
        SolverConfig(dtype="float64", **PATHS[path], **kw), device="cpu")


def read_csv(path):
    with open(path) as f:
        header, *rows = [line.rstrip("\n").split(",") for line in f]
    return header, rows


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_instrumented_matches_jax(kind, path, tmp_path, tmp_path_factory):
    """Same variables on every level, the same iteration and call counts
    key for key, the same report columns and LoopNumIters cells."""
    ref, (jt, jl) = jax_instrumented(kind, path, tmp_path_factory)
    s = port_instrumented(kind, path)
    assert s.tstate == ref.tstate
    s.run(CYCLES)
    for lev in range(s.mesh.num_levels):
        identify_differences(s.variables(lev), ref.variables(lev),
                             s.mesh.variant)
    identify_differences(np.array(s.rms_history),
                         np.array(ref.rms_history), s.mesh.variant)
    assert dict(s.stats.iters) == dict(ref.stats.iters)
    assert dict(s.stats.calls) == dict(ref.stats.calls)
    assert all(t > 0 for t in s.stats.times.values())
    pt, pl, pc = s.write_reports(str(tmp_path) + "/")
    for got, want in ((pt, jt), (pl, jl)):
        assert read_csv(got)[0] == read_csv(want)[0]
    header, (row,) = read_csv(pl)
    _, (jrow,) = read_csv(jl)
    first = header.index("flux0")
    assert row[first:] == jrow[first:]
    costs, rows = read_csv(pc)
    assert costs == header[:first] + ["Event"] + header[first:]
    by_event = {r[first]: r for r in rows}
    assert list(by_event) == events.DEFAULT_EVENTS
    for function, lev in s.stats.calls:
        col = first + 1 + header[first:].index(f"{function}{lev}")
        assert float(by_event["MODEL_BYTES"][col]) > 0
        assert float(by_event["MODEL_OPERATIONS"][col]) > 0
        assert int(by_event["CALLS"][col]) == s.stats.calls[(function, lev)]


@pytest.mark.parametrize("kind", ["box", "tet"])
def test_unfused_window_stage_matches_jax_and_fused(kind):
    """MGCFDSolver(accumulate='window', fuse_window_stage=False) against
    JAX's unfused window stage and against the port's fused one: every
    level and the RMS within relative 1e-8."""
    jm = jax_mesh(kind)
    ref = JaxSolver(jm, JaxConfig(dtype="float64", accumulate="window",
                                  fuse_window_stage=False))
    ref.run(CYCLES)
    mesh = mesh_from_arrays(jm)
    unfused, fused = (MGCFDSolver(mesh, SolverConfig(
        dtype="float64", accumulate="window", fuse_window_stage=f),
        device="cpu") for f in (False, None))
    for s in (unfused, fused):
        s.run(CYCLES)
    for other in (ref, fused):
        for lev in range(mesh.num_levels):
            identify_differences(unfused.variables(lev),
                                 other.variables(lev), mesh.variant)
        identify_differences(np.array(unfused.rms_history),
                             np.array(other.rms_history), mesh.variant)


def test_aggregate_reads_port_reports(tmp_path):
    """mgcfd_tpu/bench/aggregate.py reads a directory of the port's
    reports unchanged: one record per (function, level) that ran, with
    its seconds and iterations."""
    runs = {}
    for kind in ("box", "tet"):
        s = port_instrumented(kind)
        s.run(1)
        s.write_reports(str(tmp_path / f"job_{kind}") + "/")
        runs[f"job_{kind}"] = s
    records = collate(str(tmp_path))
    assert len(records) == sum(len(s.stats.calls) for s in runs.values())
    for r in records:
        s = runs[r["job"]]
        key = (r["kernel"], r["level"])
        assert r["iterations"] == s.stats.iters[key]
        assert r["seconds"] == pytest.approx(s.stats.times[key])
        assert r["CC"] == "torch"


def _events_file(tmp_path, text):
    p = tmp_path / "events.conf"
    p.write_text(text)
    return str(p)


def test_event_parser_keeps_the_names_jax_keeps(tmp_path, capsys):
    """On a file both packages read, the same names survive: comments
    and blank lines skipped, unknown names warned about and dropped."""
    path = _events_file(tmp_path, "# events\n\nCALLS\n  \nPAPI_TOT_INS\n"
                                  "CALLS\n")
    assert events.read_event_config(path) == jax_read_events(path) == \
        ["CALLS", "CALLS"]
    out = capsys.readouterr().out
    assert out.count("'PAPI_TOT_INS' is not supported") == 2


def test_event_parser_drops_jax_names(tmp_path, capsys):
    """XLA_* estimates and XPROF_* reads are not the port's quantities:
    warned about and dropped, not aliased."""
    path = _events_file(tmp_path, "XLA_FLOPS_ESTIMATE\nMODEL_OPERATIONS\n"
                                  "XPROF_DEVICE_TIME_US\n"
                                  "MEASURED_DEVICE_TIME_US\n")
    assert events.read_event_config(path) == ["MODEL_OPERATIONS",
                                              "MEASURED_DEVICE_TIME_US"]
    out = capsys.readouterr().out
    for name in ("XLA_FLOPS_ESTIMATE", "XPROF_DEVICE_TIME_US"):
        assert f"'{name}' is not supported" in out


@pytest.mark.parametrize("text", ["", "# nothing\n\n", None])
def test_event_parser_defaults(tmp_path, capsys, text):
    """An empty or missing file gives the defaults, in both packages."""
    path = (str(tmp_path / "missing.conf") if text is None
            else _events_file(tmp_path, text))
    assert events.read_event_config(path) == events.DEFAULT_EVENTS
    assert jax_read_events(path) == \
        ["XLA_FLOPS_ESTIMATE", "XLA_BYTES_ACCESSED_ESTIMATE", "CALLS"]
    if text is None:
        assert "could not read event config" in capsys.readouterr().out


def _ev(name, start, end, eid=0, device="cpu", us=0.0):
    """An event of a profile: a host op or call, or a device kernel."""
    dt = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, id=eid, device_type=dt.CPU if device == "cpu" else dt.CUDA,
        time_range=types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start),
        self_cpu_time_total=us)


def test_attribute_hand_made_events():
    """Each device kernel goes to the innermost range open at the host
    call that launched it (the call with the kernel's correlation id):
    inside an aten op, straight inside a range (a launch through
    ctypes), in a nested range, or outside every range (the rest). A
    range's device-side copy is not a kernel; a kernel whose launch the
    profile lacks is the rest's. On the CPU each op's self time goes to
    the range open at its start."""
    evs = [_ev("k_flux_l0", 0, 100),
           _ev("aten::add", 10, 20, us=5.0),
           _ev("cudaLaunchKernel", 12, 13, eid=7),
           _ev("cudaLaunchKernel", 30, 31, eid=8),
           _ev("cudaLaunchKernel", 40, 41, eid=9),
           _ev("k_restrict_l1", 50, 60),
           _ev("aten::mul", 51, 59, us=7.0),
           _ev("cudaLaunchKernel", 52, 53, eid=10),
           _ev("aten::sum", 120, 130, us=11.0),
           _ev("cudaLaunchKernel", 121, 122, eid=11),
           _ev("add_kernel", 200, 202, eid=7, device="cuda"),
           _ev("edge_csr_kernel", 202, 232, eid=8, device="cuda"),
           _ev("edge_csr_kernel", 232, 263, eid=9, device="cuda"),
           _ev("mul_kernel", 263, 266, eid=10, device="cuda"),
           _ev("sum_kernel", 266, 270, eid=11, device="cuda"),
           _ev("k_flux_l0", 200, 299, eid=1, device="cuda"),
           _ev("memset", 300, 301, eid=99, device="cuda")]
    m = opstats.attribute(evs, on_card=True, device="card")
    assert set(m.functions) == {("flux", 0), ("restrict", 1)}
    f = m.functions[("flux", 0)]
    assert f["time_us"] == 63.0 and f["occurrences"] == 3
    assert f["kernels"] == {"add_kernel": [1, 2.0],
                            "edge_csr_kernel": [2, 61.0]}
    assert m.functions[("restrict", 1)]["kernels"] == {"mul_kernel":
                                                       [1, 3.0]}
    assert m.other["kernels"] == {"sum_kernel": [1, 4.0],
                                  "memset": [1, 1.0]}
    assert m.total_us == 71.0
    c = opstats.attribute(evs, on_card=False, device="cpu")
    assert c.functions[("flux", 0)]["kernels"] == {
        "aten::add": [1, 5.0], "cudaLaunchKernel": [3, 0.0]}
    assert c.functions[("restrict", 1)]["kernels"] == {
        "aten::mul": [1, 7.0], "cudaLaunchKernel": [1, 0.0]}
    assert c.other["kernels"] == {"aten::sum": [1, 11.0],
                                  "cudaLaunchKernel": [1, 0.0]}


PRODUCTION = {"segment": {"accumulate": "segment"},
              "window": {"accumulate": "window"},
              "window-unfused": {"accumulate": "window",
                                 "fuse_window_stage": False},
              "pallas": {"accumulate": "pallas"}}


def _range_names(prof):
    return {e.name for e in prof.events() if opstats._TAG_RE.match(e.name)}


@pytest.mark.parametrize("path", list(PRODUCTION))
def test_production_ranges_only_while_measuring(path):
    """measure_production sees a k_<function>_l<level> range for every
    function the cycle runs on every level it runs it, the bookkeeping
    (invalid_count, residual, rms) too; a plain run under the same
    profiler enters none. The fused stages land on flux, so time_step
    appears only where the stage is unfused; invalid_count appears on
    every path, on the fused ones with only the count's sums."""
    from torch.profiler import ProfilerActivity, profile
    mesh = mesh_from_arrays(jax_mesh("box"))
    s = MGCFDSolver(mesh, SolverConfig(dtype="float64", **PRODUCTION[path]),
                    device="cpu")
    s.run(1)
    m = opstats.measure_production(s)
    fused = path in ("window", "pallas")
    want = {(f, lev) for lev in range(2)
            for f in FUNCTIONS + ("invalid_count", "residual")
            if not (fused and f == "time_step")}
    want |= {("restrict", 0), ("prolong", 0), ("rms", 0)}
    assert set(m.functions) == want
    assert all(r["occurrences"] > 0 and r["time_us"] > 0
               for r in m.functions.values())
    assert m.device == "cpu"
    assert not solver_mod._ranges_on
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.run(1)
    assert _range_names(prof) == set()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with solver_mod.measured_ranges():
            s.run(1)
    assert _range_names(prof) == {f"k_{f}_l{lev}" for f, lev in want}


def _snapshot(s):
    return ({k: [t.clone() for t in v] for k, v in s.state.items()},
            list(s.rms_history))


def _same_state(a, b):
    assert a[1] == b[1]
    for key in ("variables", "residuals"):
        for x, y in zip(a[0][key], b[0][key]):
            assert torch.equal(x, y)


def test_measurements_restore_the_state(tmp_path):
    """The state after --measure-ops (and after --profile-dir's extra
    cycle) equals the state without it, so the run ends where it would
    have: the counterpart of ADVICE (c). mgcfd_tpu differs here on
    purpose: its measure_production and --profile-dir advance the state
    by the profiled cycles."""
    mesh = mesh_from_arrays(jax_mesh("tet"))
    cfg = SolverConfig(dtype="float64", accumulate="window")
    s = MGCFDSolver(mesh, cfg, device="cpu")
    s.run(2)
    before, done = _snapshot(s), s.completed_cycles
    opstats.measure_production(s, cycles=2)
    opstats.export_trace(s, str(tmp_path / "trace"))
    _same_state(_snapshot(s), before)
    assert s.completed_cycles == done
    s.run(1)
    ref = MGCFDSolver(mesh, SolverConfig(dtype="float64",
                                         accumulate="window"), device="cpu")
    ref.run(3)
    _same_state(_snapshot(s), _snapshot(ref))

    ins = port_instrumented("tet", "window")
    ins.run(1)
    before = _snapshot(ins)
    stats = {k: dict(getattr(ins.stats, k)) for k in ("times", "iters",
                                                      "calls")}
    total = ins.stats.total_time
    opstats.measure_instrumented(ins, cycles=2)
    _same_state(_snapshot(ins), before)
    assert {k: dict(getattr(ins.stats, k)) for k in stats} == stats
    assert ins.stats.total_time == total


def test_measure_instrumented_fills_the_cost_rows():
    """Every (function, level) the instrumented cycle runs is measured,
    and the bookkeeping, each in a range of its own, so that nothing is
    left outside; they land in cost_details and the MEASURED_* rows."""
    s = port_instrumented("box", "window")
    s.run(1)
    m = opstats.measure_instrumented(s, cycles=1)
    assert set(m.functions) == set(s.stats.calls) | {
        (f, lev) for f in ("residual", "invalid_count") for lev in range(2)
    } | {("rms", 0)}
    assert m.other["occurrences"] == 0
    for key, rec in m.functions.items():
        assert rec["time_us"] > 0 and rec["occurrences"] > 0
        assert s.stats.cost_details[key]["measured_occurrences"] == \
            rec["occurrences"]
    names = [n for n, _ in events.event_rows(s.config, s.stats)]
    assert names == events.DEFAULT_EVENTS + list(events.MEASURED_EVENTS)


@pytest.fixture(scope="module")
def tet_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tetfiles")
    return write_multigrid_mesh(str(d), mesh_from_arrays(jax_mesh("tet")))


def test_cli_instrumented_reports(tet_files, tmp_path, capsys):
    """--monitor instrumented -o DIR/ --measure-ops -p FILE writes the
    three reports; their headers are the identification, ThreadNum,
    CpuId (and Event) and the kernel x level columns; the cost file
    holds the selected events and the measured rows."""
    conf = _events_file(tmp_path, "CALLS\nMODEL_BYTES\nXLA_FLOPS_ESTIMATE\n")
    out = tmp_path / "out"
    assert cli_main(["-i", tet_files, "-g", "2", "--platform", "cpu",
                     "--dtype", "float64", "--monitor", "instrumented",
                     "-o", str(out) + "/", "--measure-ops", "-p", conf]) == 0
    log = capsys.readouterr().out
    assert "'XLA_FLOPS_ESTIMATE' is not supported" in log
    assert "MG cycle 2 / 2" in log
    ident = csvout.ID_COLUMNS
    cols = [f"{k}{lev}" for lev in range(2) for k in csvout.KERNEL_COLUMNS]
    want = {"Times.csv": ident + ["ThreadNum", "CpuId"] + cols + ["Total",
                                                                  ""],
            "LoopNumIters.csv": ident + ["ThreadNum", "CpuId"] + cols + [""],
            csvout.COSTS_FILE: ident + ["ThreadNum", "CpuId", "Event"]
            + cols + [""]}
    for name, header in want.items():
        assert read_csv(out / name)[0] == header
    rows = read_csv(out / csvout.COSTS_FILE)[1]
    ev = len(ident) + 2
    assert [r[ev] for r in rows] == ["CALLS", "MODEL_BYTES",
                                     "MEASURED_DEVICE_TIME_US",
                                     "MEASURED_OCCURRENCES"]
    flux0 = ev + 1
    assert float(rows[2][flux0]) > 0 and int(rows[3][flux0]) > 0


def test_cli_measure_ops_under_the_fused_monitor(tet_files, tmp_path,
                                                 capsys):
    """--measure-ops without --monitor prints the production split and
    writes it as the cost file's MEASURED_* rows; a prefix that is no
    directory joins the file name with '.'."""
    prefix = str(tmp_path / "run1")
    assert cli_main(["-i", tet_files, "-g", "1", "--platform", "cpu",
                     "--measure-ops", "-o", prefix]) == 0
    log = capsys.readouterr().out
    assert "measured flux level 0:" in log
    assert "outside the functions:" in log
    header, rows = read_csv(prefix + "." + csvout.COSTS_FILE)
    ev = header.index("Event")
    by_event = {r[ev]: r for r in rows}
    assert list(by_event) == list(events.MEASURED_EVENTS)
    for col in ("flux0", "flux1", "restrict0", "prolong0", "compute_step0"):
        assert float(by_event["MEASURED_DEVICE_TIME_US"][
            header.index(col)]) > 0, col
    assert not os.path.exists(prefix + ".Times.csv")


def test_cli_profile_dir(tet_files, tmp_path, capsys):
    """--profile-dir writes one more cycle's trace as Chrome trace JSON,
    with the functions' ranges in it."""
    d = tmp_path / "trace"
    assert cli_main(["-i", tet_files, "-g", "1", "--platform", "cpu",
                     "--monitor", "instrumented", "-o",
                     str(tmp_path) + "/", "--profile-dir", str(d)]) == 0
    trace = json.loads((d / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"k_flux_l0", "k_prolong_l0", "k_restrict_l0"} <= names


@pytest.mark.parametrize("flag,why", [
    (["--dump-hlo", "x"], "no HLO to dump"),
    (["--compile-cache", "x"], "compiles no XLA program")])
def test_cli_refusals(tet_files, capsys, flag, why):
    with pytest.raises(SystemExit):
        cli_main(["-i", tet_files, "--platform", "cpu", *flag])
    assert why in capsys.readouterr().err


@pytest.mark.parametrize("flag,parts", [
    (["--shard-levels", "2"], 2), (["--partitions", "2"], 2),
    (["--partition-2d", "2x2"], 4)])
def test_cli_sharding_flags(tet_files, tmp_path, flag, parts):
    """--shard-levels, --partitions and --partition-2d (refused until the
    sharded solver was ported) under --monitor instrumented: the CLI's
    ranks run the instrumented sharded solver, and rank 0 writes the
    reports with Num threads = the partition count."""
    out = tmp_path / "out"
    argv = ["-i", tet_files, "--platform", "cpu", "-g", "1", "--monitor",
            "instrumented", "-o", f"{out}/", *flag]
    if "--partitions" not in flag:
        argv += ["--partitions", str(parts)]
    assert cli_main(argv) == 0
    for name in ("Times.csv", "LoopNumIters.csv", csvout.COSTS_FILE):
        rows = (out / name).read_text().splitlines()
        assert rows[1].split(",")[12] == str(parts), name


@pytest.mark.parametrize("field,value", [
    ("output_file_prefix", "out/"), ("event_config_file", "e.conf"),
    ("flux_reuse_flux", True), ("flux_reuse_div", True),
    ("flux_reuse_factor", True), ("monitor_mode", "instrumented"),
    ("fuse_window_stage", False)])
def test_monitor_fields_accepted(field, value):
    """The fields the monitor brings are taken at any value; an unknown
    monitor mode is refused."""
    SolverConfig(**{field: value}).validate()
    with pytest.raises(ValueError, match="monitor mode"):
        SolverConfig(monitor_mode="papi").validate()


@pytest.mark.parametrize("flags", [
    {}, {"flux_reuse_div": True}, {"flux_reuse_factor": True,
                                   "flux_reuse_flux": True},
    {"flux_precompute_edge_weights": True, "flux_reuse_div": True,
     "flux_reuse_factor": True, "flux_reuse_flux": True},
    {"flux_cripple": True}])
def test_flux_strings_match_jax(flags):
    """The CSV's Flux variant and Flux options fields, string for
    string."""
    mine, ref = SolverConfig(**flags), JaxConfig(**flags)
    assert mine.flux_options_string() == ref.flux_options_string()
    assert mine.flux_variant_string() == ref.flux_variant_string()
