"""The float64 M6 deployment (cfdbench/configs/m6rcm64.json) against the
benchmark's plain float64 reference (cfdbench/reference) on the CPU, at
the limits the cell m6rcm64.graph uses: a small RCM box hierarchy made by
cfdbench/inputs (M6 wing variant), the port's float64 run through
run_batched(10, 10) within every limit, the same run at float32 (the
configuration's control) beyond dq_l0_yz or res_l0_yz, and the harness
taking the configuration as it is, with the graph mix."""
import json
import os

import numpy as np
import pytest
import torch

from cfdbench import check, run
from cfdbench.reference import ReferenceSolver
from cfdbench.state import initial_state
from cfdbench.tests.hostcard import HostCard
from mgcfd_tpu_torch.solver import MGCFDSolver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = [[12, 11, 12], [10, 9, 11], [8, 7, 9], [6, 6, 7]]
SEEDS = (7, 2 ** 31 + 4099)
# the configuration's own accumulate, and the path it takes on the card
ACCUMULATE = ("auto", "window")


def config() -> dict:
    return run.load_json(ROOT, "cfdbench", "configs", "m6rcm64.json")


def small(cfg: dict) -> dict:
    cfg = dict(cfg, name="small64", mesh=dict(cfg["mesh"], levels=LEVELS))
    cfg["nodes"] = [int(np.prod(d)) for d in LEVELS]
    return cfg


@pytest.fixture(scope="module")
def hierarchy(tmp_path_factory):
    """(configuration, the port's mesh, the reference) on the small
    hierarchy, written once."""
    cfg = small(config())
    old = run.CACHE
    run.CACHE = str(tmp_path_factory.mktemp("m6rcm64"))
    try:
        input_dat = run.mesh_files(cfg)
        mesh = run.port_mesh(cfg, input_dat)
        ref = ReferenceSolver(run.reference_mesh(cfg, input_dat),
                              torch.device("cpu"))
    finally:
        run.CACHE = old
    return cfg, mesh, ref


def readings(hierarchy, seed: int, **override) -> dict:
    cfg, mesh, ref = hierarchy
    s0 = initial_state(cfg["nodes"], seed, cfg["state"])
    solver = MGCFDSolver(mesh, run.solver_config(cfg, **override),
                         device="cpu")
    solver.load_state(s0)
    solver.run_batched(10, 10)
    return check.readings(s0, run.snapshot(solver), ref.run(s0, 10))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("accumulate", ACCUMULATE)
def test_float64_is_within_every_limit(hierarchy, accumulate, seed):
    limits = hierarchy[0]["limits"]
    got = readings(hierarchy, seed, accumulate=accumulate)
    assert all(got[k] <= limits[k] for k in check.NAMES), (got, limits)
    assert check.judge(got, limits)[0]


@pytest.mark.parametrize("accumulate", ACCUMULATE)
def test_the_float32_control_fails(hierarchy, accumulate):
    cfg = hierarchy[0]
    assert cfg["control"] == {"dtype": "float32"}
    got = readings(hierarchy, SEEDS[0], accumulate=accumulate,
                   **cfg["control"])
    limits = cfg["limits"]
    assert got["dq_l0_yz"] > limits["dq_l0_yz"] or \
        got["res_l0_yz"] > limits["res_l0_yz"], (got, limits)
    assert not check.judge(got, limits)[0]


def test_the_harness_takes_the_configuration():
    cfg = config()
    run.check_config(cfg, run.load_json(ROOT, "cfdbench", "mixes",
                                        "graph.json"))
    spec = run.cell_spec("m6rcm64.graph")
    assert spec["config"] == cfg and spec["mix"]["entry"] == "run_batched"
    assert spec["cell"]["chips"] == 1
    assert cfg["solver"] == {"dtype": "float64", "accumulate": "auto"}
    m6rcm = run.load_json(ROOT, "cfdbench", "configs", "m6rcm.json")
    for key in ("mesh", "load", "state", "nodes", "edges_level0",
                "source_sizes"):
        assert cfg[key] == m6rcm[key], key
    assert {m["name"] for m in spec["end_to_end"]} == {"cycle_ms",
                                                       "setup_s"}
    assert "flux_roofline" not in {m["name"] for m in spec["per_layer"]}


@pytest.mark.parametrize("dtype,correct", [("float64", True),
                                           ("float32", False)])
def test_a_whole_run_is_judged_at_the_configurations_limits(
        dtype, correct, tmp_path, monkeypatch, capsys):
    """run.main on the small hierarchy with the card's look skipped: the
    float64 run is correct, the float32 control is not."""
    spec = run.cell_spec("m6rcm64.graph")
    spec["config"] = small(spec["config"])
    spec["config"]["solver"] = dict(spec["config"]["solver"], dtype=dtype)
    monkeypatch.setattr(run, "CACHE", str(tmp_path))
    monkeypatch.setattr(run, "require_card", HostCard)
    monkeypatch.setattr(run, "cell_spec", lambda name: spec)
    # this suite's conftest imports JAX for other files' comparisons; the
    # harness's own tests (cfdbench/tests) hold its refusal of JAX
    monkeypatch.setattr(run, "FORBIDDEN", ())
    assert run.main(["--workload", "small64", "--seed", str(SEEDS[1]),
                     "--seconds", "0.2", "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is correct
    assert set(line["metrics"]) == {"cycle_ms", "setup_s"}
