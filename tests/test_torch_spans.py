"""The port's span and counter recorder (mgcfd_tpu_torch/utils/spans.py):
nesting, parents, totals and self time; the spans and counters a
solver's set-up records; the batch spans, recorded only while a
profiler records; kscope's ranges through the same module; the CLI's
log of them; and the benchmark's readers of them (cfdbench/metrics)."""
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mgcfd_tpu_torch.utils
from cfdbench.run import load_reader
from mgcfd_tpu_torch import kernels
from mgcfd_tpu_torch.cli.main import main as cli_main
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.mesh import (duplicate_mesh, generate_multigrid_box,
                                  load_multigrid_mesh, write_multigrid_mesh)
from mgcfd_tpu_torch.monitor import opstats
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.solver import solver as solver_mod
from mgcfd_tpu_torch.utils import logging as mlog
from mgcfd_tpu_torch.utils import spans

H = (0.1, 0.1, 0.1)
SETUP = {"context_s": "mgcfd.context", "plans_s": "mgcfd.plan",
         "upload_s": "mgcfd.upload", "capture_s": "mgcfd.capture"}
BATCH = {"replay_idle_share.graph": "mgcfd.batch.replay",
         "read_idle_share.graph": "mgcfd.batch.read"}


@pytest.fixture(autouse=True)
def clean():
    spans.reset()
    yield
    spans.reset()


def names():
    return [s.name for s in spans.spans()]


def tiny(**kw):
    return MGCFDSolver(generate_multigrid_box(6, 6, 6, 2, h=H),
                       SolverConfig(dtype="float64", **kw), device="cpu")


def test_nesting_parents_and_self_time():
    with spans.span("mgcfd.a"):
        with spans.span("mgcfd.b"):
            with spans.span("mgcfd.a"):
                pass
        with spans.span("mgcfd.c"):
            pass
    a, b, inner, c = spans.spans()
    assert [s.name for s in (a, b, inner, c)] == ["mgcfd.a", "mgcfd.b",
                                                   "mgcfd.a", "mgcfd.c"]
    assert (a.parent, b.parent, inner.parent, c.parent) == (None, 0, 1, 0)
    assert all(s.end_ns >= s.start_ns for s in (a, b, inner, c))
    # the inner mgcfd.a lies inside the outer one: counted once
    assert spans.total("mgcfd.a") == pytest.approx(a.seconds)
    assert spans.self_time("mgcfd.a") == pytest.approx(
        a.seconds - b.seconds - c.seconds + inner.seconds)
    assert spans.self_time("mgcfd.b") == pytest.approx(
        b.seconds - inner.seconds)
    assert spans.total("mgcfd.none") == 0.0


def test_a_span_left_by_an_exception_closes_and_counters_add():
    with pytest.raises(ValueError):
        with spans.span("mgcfd.a"):
            raise ValueError("boom")
    with spans.span("mgcfd.b"):
        pass
    a, b = spans.spans()
    assert a.end_ns is not None and b.parent is None
    spans.count("x.y")
    spans.count("x.y", 4)
    spans.count("z")
    assert spans.counters("x.") == {"y": 5}
    assert spans.counters()["z"] == 1
    assert set(spans.counters("launches.")) == {w.name
                                                for w in kernels.WRAPPERS}
    spans.reset()
    assert spans.spans() == [] and not spans.counters("x.")


def test_a_decorated_function_records_a_span_a_call():
    @spans.span("mgcfd.f")
    def f(n):
        return f(n - 1) + 1 if n else 0

    assert f(2) == 2 and f(0) == 0
    every = spans.spans()
    assert names() == ["mgcfd.f"] * 4
    assert [s.parent for s in every] == [None, 0, 1, None]
    assert all(s.end_ns is not None for s in every)
    assert spans.total("mgcfd.f") == pytest.approx(
        every[0].seconds + every[3].seconds)


def test_a_counter_source_reports_under_its_prefix(monkeypatch):
    """A layer above the recorder gives it counts it keeps itself, as
    the kernels package gives its wrappers' launch counts."""
    own = {"a": 2}
    monkeypatch.setitem(spans._sources, "mine", lambda: dict(own))
    assert spans.counters("mine.") == {"a": 2}
    own["a"] = 3
    spans.reset()
    assert spans.counters("mine.") == {"a": 3}


def test_the_profiler_check_follows_torch_profiler():
    """The one test a span makes: true exactly while a torch.profiler
    session records."""
    assert not spans.profiling()
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.profiling()
    assert not spans.profiling()


def test_a_span_opens_its_range_only_under_a_profiler(monkeypatch):
    opened = []
    real = spans.profiler_range
    monkeypatch.setattr(spans, "profiler_range",
                        lambda name: opened.append(name) or real(name))
    with spans.span("mgcfd.quiet"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("mgcfd.loud"):
            torch.ones(4).sum()
    assert opened == ["mgcfd.loud"]
    assert "mgcfd.loud" in {e.name for e in prof.events()}
    assert names() == ["mgcfd.quiet", "mgcfd.loud"]
    assert spans.when(False, "mgcfd.x") is spans.OFF


def test_span_names_are_not_opstats_ranges():
    tiny(accumulate="window").run_batched(2, 2)
    with profile(activities=[ProfilerActivity.CPU]):
        tiny().run_batched(2, 2)
    assert names() and not any(opstats._TAG_RE.match(n) for n in names())
    assert all(n.startswith("mgcfd.") for n in names())


def test_setup_spans_and_counters_cold_then_warm(tmp_path):
    """A cold construction through a plan cache builds every plan, a warm
    one loads them, each inside the solver's span; the uploads and the
    hashed key bytes are counted. On the CPU no context span."""
    cache = str(tmp_path / "plans")
    cold = tiny(accumulate="window", plan_cache_dir=cache)
    built = spans.counters("plans.built.")
    assert built == {"torch-flux": 2, "torch-restrict": 1,
                     "torch-prolong": 1}
    assert not spans.counters("plans.loaded.")
    every = spans.spans()
    assert every[0].name == "mgcfd.solver" and every[0].parent is None
    assert {"mgcfd.prepare.condition", "mgcfd.plan", "mgcfd.plan.key",
            "mgcfd.plan.build", "mgcfd.upload"} <= set(names())
    assert "mgcfd.context" not in names()
    for s in every[1:]:
        assert s.parent is not None
        parent = every[s.parent].name
        if s.name.startswith("mgcfd.plan."):
            assert parent == "mgcfd.plan"
        else:
            assert parent == "mgcfd.solver", s.name
    assert spans.counters()["plans.key_bytes"] > 0
    device_bytes = sum(t.nbytes for lv in cold.dmesh.levels
                       for t in (lv.volumes, lv.edge_w, lv.edge_a))
    assert spans.counters()["upload.bytes"] > device_bytes
    assert spans.total("mgcfd.solver") >= spans.total("mgcfd.plan") > 0
    spans.reset()
    tiny(accumulate="window", plan_cache_dir=cache)
    assert spans.counters("plans.loaded.") == built
    assert not spans.counters("plans.built.")
    assert "mgcfd.plan.load" in names()
    assert "mgcfd.plan.build" not in names()


def test_load_and_duplicate_spans(tmp_path):
    path = write_multigrid_mesh(str(tmp_path),
                                generate_multigrid_box(5, 5, 5, 2, h=H))
    mesh = load_multigrid_mesh(path)
    duplicate_mesh(mesh, 1)
    assert names() == ["mgcfd.load"]
    duplicate_mesh(mesh, 2)
    assert names() == ["mgcfd.load", "mgcfd.duplicate"]


def test_a_batch_records_nothing_outside_a_profile(monkeypatch):
    """Without a profiler recording, run_batched appends no span and
    opens no range."""
    s = tiny()
    spans.reset()
    opened = []
    monkeypatch.setattr(spans, "profiler_range",
                        lambda name: opened.append(name))
    s.run_batched(4, 2)
    assert spans.spans() == [] and opened == []


@pytest.mark.parametrize("accumulate", ["segment", "window"])
def test_batch_spans_under_a_profile(accumulate):
    """Under torch.profiler each batch is a replay and a read span, both
    in the profile's events; the read holds the host reads, the replay
    the cycles (on the CPU the eager batch)."""
    s = tiny(accumulate=accumulate)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.run_batched(4, 2)
    assert names() == ["mgcfd.batch.replay", "mgcfd.batch.read"] * 2
    assert all(x.parent is None for x in spans.spans())
    events = prof.events()
    assert sum(e.name == "mgcfd.batch.read" for e in events) == 2
    assert sum(e.name == "mgcfd.batch.replay" for e in events) == 2

    def inside(span_name, op):
        outer = [e for e in events if e.name == span_name]
        return any(o.time_range.start <= e.time_range.start
                   and e.time_range.end <= o.time_range.end
                   for e in events if e.name == op for o in outer)
    assert inside("mgcfd.batch.read", "aten::item")
    assert inside("mgcfd.batch.read", "aten::to")
    assert inside("mgcfd.batch.replay", "aten::stack")


def test_kscope_ranges_go_through_the_recorders_range(monkeypatch):
    """kscope keeps its k_<function>_l<level> names, its switch and its
    shared null context; its ranges open through spans.profiler_range."""
    opened = []
    real = spans.profiler_range
    monkeypatch.setattr(spans, "profiler_range",
                        lambda name: opened.append(name) or real(name))
    assert solver_mod.kscope("flux", 0) is spans.OFF
    s = tiny(accumulate="window")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with solver_mod.measured_ranges():
            s.run(1)
    seen = {e.name for e in prof.events() if opstats._TAG_RE.match(e.name)}
    assert {"k_flux_l0", "k_flux_l1", "k_restrict_l0", "k_rms_l0"} <= seen
    assert set(opened) == seen
    assert not solver_mod._ranges_on


def test_the_cli_logs_setup_spans_and_counters(monkeypatch, capsys,
                                              tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(mlog, "_enabled", True)
    assert cli_main(["--synthetic", "4,4,4,2", "-g", "1", "--platform",
                     "cpu", "--dtype", "float64", "--accumulate",
                     "window"]) == 0
    err = capsys.readouterr().err
    assert "set-up span mgcfd.solver:" in err
    assert "set-up span mgcfd.upload:" in err
    assert "set-up counter upload.bytes:" in err
    assert "set-up counter plans.built.torch-flux: 2" in err
    monkeypatch.setattr(mlog, "_enabled", False)
    spans.reset()
    assert cli_main(["--synthetic", "4,4,4,2", "-g", "1", "--platform",
                     "cpu"]) == 0
    assert "set-up" not in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def without_store(monkeypatch):
    """The program as a port older than its spans has it."""
    monkeypatch.delattr(mgcfd_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "mgcfd_tpu_torch.utils.spans", None)


@pytest.mark.parametrize("metric", sorted(SETUP))
def test_setup_readers(metric, monkeypatch):
    read = load_reader(metric)
    name = SETUP[metric]
    assert read({}) is None      # a store without the span
    with spans.span("mgcfd.solver"):
        with spans.span(name):
            with spans.span(name):
                pass
        with spans.span(name):
            pass
    outer = [s for s in spans.spans() if s.name == name and
             spans.spans()[s.parent].name == "mgcfd.solver"]
    assert read({}) == pytest.approx(sum(s.seconds for s in outer))
    without_store(monkeypatch)
    assert read({}) == 0.0


def trace_record(gaps):
    return {"mix": {"entry": "run_batched"},
            "trace": {"busy_s": 0.045, "span_s": 0.05, "idle_gaps": gaps}}


@pytest.mark.parametrize("metric", sorted(BATCH))
def test_batch_readers(metric, monkeypatch):
    read = load_reader(metric)
    name = BATCH[metric]
    gaps = [["mgcfd.batch.replay", 0.003], ["mgcfd.batch.read", 0.001],
            ["host, outside any op", 0.0006]]
    want = {"mgcfd.batch.replay": 6.0, "mgcfd.batch.read": 2.0}[name]
    older = [["cudaGraphLaunch", 0.003], ["aten::item", 0.001]]
    # a store without the span: the program lost it
    assert read(trace_record(gaps)) is None
    assert read(trace_record(older)) is None
    with spans.span(name):
        pass
    assert read(trace_record(gaps)) == pytest.approx(want)
    assert read({"mix": {"entry": "run_batched"}}) is None
    # the span recorded, the device never idled under it
    assert read(trace_record(older)) == 0.0
    without_store(monkeypatch)
    assert read(trace_record(older)) == 0.0
    assert read({"mix": {"entry": "run_batched"}}) is None
