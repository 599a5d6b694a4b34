"""The harness is driven by data: in a copy of cfdbench/ with new
configurations (one duplicated, as the app's -m does, one over the
tetrahedral generator), a mix and a metric reader added as files (no
existing file edited), a run finds and runs them on a tiny mesh, its
traced run reads every per-layer metric the cell lists, and its last line
parses against the result's contract.
A listed metric that reads nothing, or a configuration key the harness
does not apply, fails the run. Without a card a run fails: it exits 2
and prints no result, and never falls back to the CPU."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from cfdbench.tests.conftest import PKG, tiny_config, tiny_tet_config

REPO = os.path.dirname(PKG)
# a run with the card replaced by the CPU (tests/hostcard.py), from a
# copy's root
ON_CPU = ("import sys; sys.path.insert(0, '.');"
          "import cfdbench.run as r;"
          "from cfdbench.tests.hostcard import HostCard;"
          "r.require_card = HostCard;"
          "sys.exit(r.main(sys.argv[1:]))")
# what the host stand-in can read: every per-layer metric but the
# rooflines, which need the card's peaks
ON_HOST = ["device_idle_share.graph", "compute_step_us", "transfer_us",
           "mesh_load_s", "prep_s"]


def digest(root):
    out = {}
    for base, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in (".cache", "__pycache__")]
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def config(name, duplicate=1, **solver):
    cfg = tiny_config("rcm")
    cfg["name"] = name
    cfg["load"]["duplicate"] = duplicate
    cfg["solver"].update(solver)
    return cfg


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A checkout's benchmark with configurations, a mix and a metric
    added as new files, and cells for them in BENCHMARK.json."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(PKG, root / "cfdbench", ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    before = digest(root / "cfdbench")
    configs = root / "cfdbench" / "configs"
    for cfg in (config("newrcm"), config("newrcm2", duplicate=2),
                config("newbad", mesh_duplicate_count=8),
                tiny_tet_config() | {"name": "newtet"}):
        (configs / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (root / "cfdbench" / "mixes" / "graph5.json").write_text(json.dumps({
        "entry": "run_batched",
        "args": {"cycles": 5, "cycles_per_dispatch": 5},
        "warmup_calls": 1, "trace_calls": 2, "production_cycles": 1,
        "window_metric": "cycle_ms", "why": "5 cycles a call"}))
    (root / "cfdbench" / "metrics" / "inputs_s.py").write_text(
        "def read(record):\n"
        "    return record['spans']['inputs_s']\n")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    new = [("newrcm", "graph5"), ("newrcm2", "graph5"), ("newbad", "graph5"),
           ("newrcm", "run"), ("newrcm2", "graph"), ("newtet", "graph5")]
    bench["workloads"] += [
        {"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1,
         "why": f"a tiny {c} mesh under {t}"} for c, t in new]
    graphs = [f"{c}.{t}" for c, t in new if t != "run"]
    for m in bench["end_to_end"]:
        if m["name"] == "cycle_ms":
            m["workloads"] += graphs
    bench["end_to_end"].append({
        "name": "run_cycle_ms", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock", "workloads": ["newrcm.run"]})
    for m in bench["per_layer"]:
        if m["name"] in ON_HOST:
            m["workloads"] += ["newrcm.graph5", "newrcm2.graph5",
                               "newtet.graph5"]
        if m["name"] == "flux_roofline":
            m["workloads"].append("newrcm2.graph")
    bench["per_layer"].append({
        "name": "inputs_s", "unit": "s", "better": "lower",
        "source": "host_clock", "layer": "set-up", "moves": "setup_s",
        "workloads": ["newrcm.graph5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(root / "cfdbench")
    assert {k: v for k, v in after.items() if k in before} == before
    return root


def run(root, *argv, on_cpu=True):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable] + (["-c", ON_CPU] if on_cpu
                              else ["-m", "cfdbench.run"])
    return subprocess.run(cmd + list(argv), cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)


def parse(r):
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    names = [ln.split()[1] for ln in r.stderr.strip().splitlines()[-4:]]
    assert names == list(line["checks"])
    return line


def record(r):
    """The run's own record, the stderr line before the result's."""
    return json.loads([ln for ln in r.stderr.splitlines()
                       if ln.startswith("{")][-1])


@pytest.mark.parametrize("cell,trace,metrics", [
    ("newrcm.graph5", 0, {"cycle_ms", "setup_s"}),
    ("newrcm.graph5", 1, {*ON_HOST, "inputs_s"}),
    ("newrcm2.graph5", 0, {"cycle_ms", "setup_s"}),
    ("newrcm2.graph5", 1, set(ON_HOST)),
    ("newrcm.run", 0, {"run_cycle_ms", "setup_s"})])
def test_new_files_are_found_and_run(copy, cell, trace, metrics):
    r = run(copy, "--workload", cell, "--seed", str(2 ** 31 + 17),
            "--seconds", "0.3", "--trace", str(trace))
    line = parse(r)
    assert line["correct"] is True
    assert set(line["metrics"]) == metrics
    assert line["attempted"] % 5 == 0 and line["failed"] == 0
    duplicate = 2 if cell.startswith("newrcm2") else 1
    assert record(r)["nodes"] == [duplicate * n
                                  for n in tiny_config("rcm")["nodes"]]
    if trace:
        assert line["device"]["busy_s"] > 0
        assert len(line["breakdown"]["device_ops"]) > 0


@pytest.mark.parametrize("trace,metrics", [(0, {"cycle_ms", "setup_s"}),
                                           (1, set(ON_HOST))])
def test_a_tet_configuration_added_as_a_file_runs(copy, trace, metrics):
    r = run(copy, "--workload", "newtet.graph5", "--seed",
            str(2 ** 31 + 29), "--seconds", "0.3", "--trace", str(trace))
    line = parse(r)
    assert line["correct"] is True
    assert set(line["metrics"]) == metrics
    assert record(r)["nodes"] == tiny_tet_config()["nodes"]


def test_a_listed_metric_that_reads_nothing_fails_the_run(copy):
    r = run(copy, "--workload", "newrcm2.graph", "--seed", "3",
            "--seconds", "0.3", "--trace", "1")
    assert r.returncode == 5
    assert r.stdout.strip() == ""
    assert "flux_roofline" in r.stderr


def test_a_configuration_key_the_harness_does_not_apply_is_refused(copy):
    r = run(copy, "--workload", "newbad.graph5", "--seed", "3",
            "--seconds", "0.3", "--trace", "0")
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "mesh_duplicate_count" in r.stderr


def test_without_a_card_a_run_fails(copy):
    r = run(copy, "--workload", "newrcm.graph5", "--seed", "1",
            "--seconds", "1", "--trace", "0", on_cpu=False)
    assert r.returncode == 2
    assert r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copytree(PKG, tmp_path / "cfdbench", ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "-c", ON_CPU, "--workload",
                        "m6rcm.graph", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
