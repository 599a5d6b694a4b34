"""The tetrahedral deployment (cfdbench/configs/tetrcm.json) against the
benchmark's plain float64 reference (cfdbench/reference) on the CPU, at
the limits the cell tetrcm.graph uses: a small RCM tet hierarchy made by
cfdbench/inputs with the configuration's keys and only its levels cut (3
levels, each axis halved), the port's float32 run through
run_batched(10, 10) within every limit, the same run at bfloat16 (the
configuration's control) beyond dq_l0_yz or res_l0_yz, the harness taking
the configuration as it is, with the graph mix, and a whole run judged
correct on the host stand-in. The configuration's levels take the long-row
launch shapes that no box cell takes."""
import json
import os

import numpy as np
import pytest
import torch

from cfdbench import check, run
from cfdbench.reference import ReferenceSolver
from cfdbench.state import initial_state
from cfdbench.tests.hostcard import HostCard
from mgcfd_tpu_torch.kernels.edge_csr import (CHUNKED, RW_GROUP8X2, RW_ROW,
                                              RW_TILE, rw_shape, wsum_shape)
from mgcfd_tpu_torch.solver import MGCFDSolver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = [[14, 12, 14], [7, 6, 7], [4, 3, 4]]
SEEDS = (7, 2 ** 31 + 4099)
# the configuration's own accumulate, and the path it takes on the card
ACCUMULATE = ("auto", "window")
# internal edges of the configuration's levels, as the generator writes
# them (seed 0)
EDGES = [2279535, 277022, 33696, 3997]


def config() -> dict:
    return run.load_json(ROOT, "cfdbench", "configs", "tetrcm.json")


def small(cfg: dict) -> dict:
    cfg = dict(cfg, name="smalltet", mesh=dict(cfg["mesh"], levels=LEVELS))
    cfg["nodes"] = [int(np.prod(d)) for d in LEVELS]
    return cfg


@pytest.fixture(scope="module")
def hierarchy(tmp_path_factory):
    """(configuration, the port's mesh, the reference) on the small
    hierarchy, written once."""
    cfg = small(config())
    old = run.CACHE
    run.CACHE = str(tmp_path_factory.mktemp("tetrcm"))
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


def test_the_small_hierarchy_has_long_rows(hierarchy):
    _, mesh, _ = hierarchy
    assert [lv.num_nodes for lv in mesh.levels] == \
        [int(np.prod(d)) for d in LEVELS]
    # a tet's 7 or so internal edges a node, where the box has 3
    assert mesh.levels[0].edge_a.shape[0] > 6 * mesh.levels[0].num_nodes
    assert all(lv.mg_mapping is not None for lv in mesh.levels[:-1])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("accumulate", ACCUMULATE)
def test_float32_is_within_every_limit(hierarchy, accumulate, seed):
    limits = hierarchy[0]["limits"]
    got = readings(hierarchy, seed, accumulate=accumulate)
    assert all(got[k] <= limits[k] for k in check.NAMES), (got, limits)
    assert check.judge(got, limits)[0]


@pytest.mark.parametrize("accumulate", ACCUMULATE)
def test_the_bfloat16_control_fails(hierarchy, accumulate):
    cfg = hierarchy[0]
    assert cfg["control"] == {"dtype": "bfloat16"}
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
    spec = run.cell_spec("tetrcm.graph")
    assert spec["config"] == cfg and spec["mix"]["entry"] == "run_batched"
    assert spec["cell"]["chips"] == 1
    assert cfg["solver"] == {"dtype": "float32", "accumulate": "auto"}
    assert cfg["mesh"]["generator"] == "tet" and \
        cfg["mesh"]["order"] == "rcm"
    assert cfg["nodes"] == [int(np.prod(d)) for d in cfg["mesh"]["levels"]]
    assert cfg["edges_level0"] == EDGES[0]
    # each axis halved a level, rounding up
    for fine, coarse in zip(cfg["mesh"]["levels"], cfg["mesh"]["levels"][1:]):
        assert coarse == [(n + 1) // 2 for n in fine]
    m6rcm = run.load_json(ROOT, "cfdbench", "configs", "m6rcm.json")
    for key in ("load", "solver", "control", "state"):
        assert cfg[key] == m6rcm[key], key
    assert cfg["nodes"][0] == m6rcm["nodes"][0]
    bench = run.load_json(ROOT, "BENCHMARK.json")
    entry = {c["name"]: c for c in bench["configs"]}["tetrcm"]
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    assert {m["name"] for m in spec["end_to_end"]} == {"cycle_ms",
                                                       "setup_s"}
    layer = {m["name"] for m in spec["per_layer"]}
    assert {"tile_local_share", "flux_roofline.tet",
            "rw_roofline.tet"} <= layer
    assert not {"flux_roofline", "rw_roofline"} & layer


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_levels_take_the_long_row_shapes(dtype):
    """rw at the tile on level 0, a thread a row on level 1 and two
    entries a lane on the thin levels; the restriction's chunked loads."""
    nodes = config()["nodes"]
    shapes = [rw_shape(n, 2 * e, dtype) for n, e in zip(nodes, EDGES)]
    assert shapes == [RW_TILE, RW_ROW, RW_GROUP8X2, RW_GROUP8X2]
    for fine, coarse in zip(nodes, nodes[1:]):
        assert wsum_shape(coarse, fine, dtype).loads == CHUNKED


@pytest.mark.parametrize("dtype,correct", [("float32", True),
                                           ("bfloat16", False)])
def test_a_whole_run_is_judged_at_the_configurations_limits(
        dtype, correct, tmp_path, monkeypatch, capsys):
    """run.main on the small hierarchy with the card's look skipped: the
    float32 run is correct, the bfloat16 control is not."""
    spec = run.cell_spec("tetrcm.graph")
    spec["config"] = small(spec["config"])
    spec["config"]["solver"] = dict(spec["config"]["solver"], dtype=dtype)
    monkeypatch.setattr(run, "CACHE", str(tmp_path))
    monkeypatch.setattr(run, "require_card", HostCard)
    monkeypatch.setattr(run, "cell_spec", lambda name: spec)
    # this suite's conftest imports JAX for other files' comparisons; the
    # harness's own tests (cfdbench/tests) hold its refusal of JAX
    monkeypatch.setattr(run, "FORBIDDEN", ())
    assert run.main(["--workload", "smalltet", "--seed", str(SEEDS[1]),
                     "--seconds", "0.2", "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is correct
    assert set(line["metrics"]) == {"cycle_ms", "setup_s"}
