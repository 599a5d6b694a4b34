"""The cell fvcorr193k.graph on the CPU: the cell generator's level
(inputs/cell.py) closes every cell, fills the box, gives each cell 4
faces and positive volume, walls the bottom face, and writes the same
bytes for the same seed; check_spec takes only its own keys and one
level; the configuration is the generator's at its stated sizes; the
port agrees with the float64 reference within every limit of the
configuration under 'auto' and 'window' (the plain twins here) while its
bfloat16 control does not, and a change of one variable alone fails
dq_l0; the undamped flow stays valid for 2,000 cycles; and whole runs on
a tiny level with the card's look skipped: a sound run is judged
correct, the control, each planted fault and one variable's update
scaled by 1.01 are not."""
import contextlib
import hashlib
import json

import numpy as np
import pytest
import torch

from cfdbench import check, run
from cfdbench import faults
from cfdbench.faults import FAULTS, plant
from cfdbench.inputs.cell import cell_level, generate_cell_hierarchy, \
    kuhn_tets
from cfdbench.inputs.datfiles import write_hierarchy
from cfdbench.inputs.make import check_spec, ensure, generate
from cfdbench.inputs.tet import _jittered_points
from cfdbench.reference import ReferenceSolver
from cfdbench.state import initial_state
from cfdbench.tests.conftest import PKG, TINY_CELL_LEVELS, tiny_config
from cfdbench.tests.hostcard import HostCard
from cfdbench.tests.test_cfdbench_inputs import arrays_digest, files_digest

from mgcfd_tpu_torch.mesh.io_dat import load_multigrid_mesh
from mgcfd_tpu_torch.solver import MGCFDSolver

CELL = "fvcorr193k.graph"
SEEDS = (7, 2 ** 31 + 4099)
H = (0.02, 0.03, 0.025)
# what the host stand-in reads of the cell's per-layer metrics: the
# program's own set-up spans and the window path's counters are the card's
ON_HOST = {"mesh_load_s", "prep_s", "device_idle_share.graph",
           "compute_step_us"}
# density, x-momentum and energy: the variables dq_l0_yz does not compare
ALONE = (0, 1, 4)


def config() -> dict:
    return run.load_json(PKG, "configs", "fvcorr193k.json")


def level(dims=(5, 6, 4), jitter=0.2, seed=3):
    return generate_cell_hierarchy(dims, h=H, jitter=jitter,
                                   seed=seed).levels[0]


def scatter(n, ends, rows):
    out = np.zeros((n,) + rows.shape[1:])
    np.add.at(out, ends, rows)
    return out


def outward(lv):
    """Each cell's sum of outward face area vectors, by the convention
    signs: +w at an internal edge's a end, -w at its b end, the inward
    boundary and wall normals negated."""
    n = lv.num_nodes
    return (scatter(n, lv.edge_a, lv.edge_w)
            - scatter(n, lv.edge_b, lv.edge_w)
            - scatter(n, lv.bedge_b, lv.bedge_w)
            - scatter(n, lv.wedge_b, lv.wedge_w))


def faces(lv):
    n = lv.num_nodes
    internal = np.bincount(lv.edge_a, minlength=n) + \
        np.bincount(lv.edge_b, minlength=n)
    hull = np.bincount(lv.bedge_b, minlength=n) + \
        np.bincount(lv.wedge_b, minlength=n)
    return internal, hull


# -- the generator -----------------------------------------------------------

@pytest.mark.parametrize("jitter", [0.0, 0.2, 0.35])
def test_every_cells_faces_close(jitter):
    lv = level(jitter=jitter)
    scale = np.abs(lv.edge_w).max()
    assert np.abs(outward(lv)).max() < 1e-13 * scale
    # every face vector is a real face, none degenerate
    for w in (lv.edge_w, lv.bedge_w, lv.wedge_w):
        assert (np.linalg.norm(w, axis=1) > 1e-3 * scale).all()


@pytest.mark.parametrize("dims", [(2, 2, 2), (5, 6, 4), (7, 3, 5)])
def test_the_cells_fill_the_box(dims):
    lv = level(dims)
    assert lv.num_nodes == 6 * int(np.prod(np.subtract(dims, 1)))
    box = np.prod([(d - 1) * h for d, h in zip(dims, H)])
    assert lv.volumes.sum() == pytest.approx(box, rel=1e-13)
    assert (lv.volumes > 0).all()
    # the centroids inside the box
    hi = np.array([(d - 1) * h for d, h in zip(dims, H)])
    assert ((lv.coords > 0) & (lv.coords < hi)).all()


def test_every_cell_has_4_faces():
    dims = (5, 6, 4)
    lv = level(dims)
    internal, hull = faces(lv)
    assert ((internal + hull) == 4).all()
    nx, ny, nz = np.subtract(dims, 1)
    hull_faces = 4 * (nx * ny + ny * nz + nx * nz)
    assert hull.sum() == hull_faces
    assert lv.edge_a.shape[0] == (4 * lv.num_nodes - hull_faces) // 2
    # a cell away from the hull has its 4 faces inside
    assert (internal[hull == 0] == 4).all() and (hull == 0).any()
    # each internal edge once, a < b, listed by b then a
    assert (lv.edge_a < lv.edge_b).all()
    key = lv.edge_b.astype(np.int64) * lv.num_nodes + lv.edge_a
    assert (np.diff(key) > 0).all()


@pytest.mark.parametrize("jitter", [0.0, 0.2, 0.35])
def test_every_tetrahedron_is_positively_oriented(jitter):
    dims = (5, 6, 4)
    pts = _jittered_points(*dims, np.asarray(H), jitter,
                           np.random.default_rng(0))
    tets = kuhn_tets(*dims)
    P = pts[tets]
    det6 = np.einsum("ti,ti->t", P[:, 1] - P[:, 0],
                     np.cross(P[:, 2] - P[:, 0], P[:, 3] - P[:, 0]))
    assert (det6 > 0).all()
    if jitter == 0.0:
        np.testing.assert_allclose(det6, np.prod(H), rtol=1e-12)
    flipped = tets.copy()
    flipped[5, [1, 2]] = flipped[5, [2, 1]]
    with pytest.raises(ValueError, match="1 tetrahedra"):
        cell_level(pts, flipped)


@pytest.mark.parametrize("jitter", [0.0, 0.35])
def test_the_walls_are_the_bottom_face(jitter):
    dims = (5, 6, 4)
    lv = level(dims, jitter=jitter)
    walls = lv.bedge_w / np.linalg.norm(lv.bedge_w, axis=1)[:, None]
    # the bottom face's 2 triangles a grid square, normals stored inward:
    # up; the other hull faces far field, none facing up, and as many as
    # the bottom's facing down: the top face's
    assert lv.bedge_b.shape[0] == 2 * (dims[0] - 1) * (dims[1] - 1)
    np.testing.assert_allclose(walls, [[0, 0, 1]] * len(walls), atol=1e-12)
    assert (lv.coords[lv.bedge_b, 2] < H[2]).all()
    far = lv.wedge_w / np.linalg.norm(lv.wedge_w, axis=1)[:, None]
    assert (far[:, 2] < 0.5).all()
    down = far[:, 2] < -0.5
    assert down.sum() == lv.bedge_b.shape[0]
    np.testing.assert_allclose(far[down], [[0, 0, -1]] * down.sum(),
                               atol=1e-12)
    assert (np.diff(lv.bedge_b) >= 0).all() and \
        (np.diff(lv.wedge_b) >= 0).all()


def test_the_same_seed_gives_the_same_bytes():
    a, b, c = (generate_cell_hierarchy((5, 6, 4), h=H, seed=s)
               for s in (3, 3, 4))
    assert arrays_digest(a) == arrays_digest(b) != arrays_digest(c)
    # another seed: the same cells in another order
    va, vc = a.levels[0].volumes, c.levels[0].volumes
    assert not np.array_equal(va, vc)


MISSING = object()
SPEC = config()["mesh"]


@pytest.mark.parametrize("change,named", [
    ({"volume_jitter": 0.2}, "volume_jitter"),
    ({"wall_frac": 0.0}, "wall_frac"),
    ({"levels": [[5, 6, 4], [3, 3, 3]]}, "one level"),
    ({"levels": []}, "one level"),
    *(({key: MISSING}, key) for key in sorted(SPEC))])
def test_check_spec_refuses_a_cell_entry_it_would_not_read(change, named):
    spec = {k: v for k, v in (SPEC | change).items() if v is not MISSING}
    with pytest.raises(ValueError, match=named):
        check_spec(spec)


# -- the configuration -------------------------------------------------------

# sha256 prefixes of generate()'s arrays and ensure()'s files at
# TINY_CELL_LEVELS, and of the mesh entry as mesh.json stores it
PINNED_CELL = ("3c4bd0aa36154a55", "50a479d82acad983", "da977536d750281c")


def test_the_configurations_mesh_is_pinned(tmp_path):
    spec = config()["mesh"]
    tiny = spec | {"levels": TINY_CELL_LEVELS}
    ensure(tiny, str(tmp_path / "m"))
    assert (arrays_digest(generate(tiny)), files_digest(tmp_path / "m"),
            hashlib.sha256(json.dumps(spec).encode()).hexdigest()[:16]) \
        == PINNED_CELL


def test_the_configuration_is_the_generators():
    cfg = config()
    run.check_config(cfg, run.load_json(PKG, "mixes", "graph.json"))
    spec = cfg["mesh"]
    assert spec["generator"] == "cell" and spec["variant"] == "fvcorr"
    lv = generate(spec | {"order": "structured"}).levels[0]
    assert cfg["nodes"] == [lv.num_nodes] == [193536]
    assert cfg["edges_level0"] == lv.num_edges
    internal, hull = faces(lv)
    assert ((internal + hull) == 4).all()
    # the legacy update's ratio 0.5 sum|n| / sqrt(V) stays well inside
    # the RK stages' stable range
    area = (scatter(lv.num_nodes, lv.edge_a, np.linalg.norm(lv.edge_w,
                                                             axis=1))
            + scatter(lv.num_nodes, lv.edge_b, np.linalg.norm(lv.edge_w,
                                                               axis=1))
            + scatter(lv.num_nodes, lv.bedge_b, np.linalg.norm(lv.bedge_w,
                                                                axis=1))
            + scatter(lv.num_nodes, lv.wedge_b, np.linalg.norm(lv.wedge_w,
                                                                axis=1)))
    ratio = 0.5 * area / np.sqrt(lv.volumes)
    assert 0.40 < np.median(ratio) < 0.45 and ratio.max() < 0.85


def test_the_limits_name_every_number_and_may_name_dq_l0():
    cfg = config()
    mix = run.load_json(PKG, "mixes", "graph.json")
    assert set(cfg["limits"]) == set(check.NAMES + check.OPTIONAL)
    limits = cfg["limits"]
    for ok in (limits, {k: limits[k] for k in check.NAMES}):
        run.check_config(cfg | {"limits": ok}, mix)
    for bad in ({k: v for k, v in limits.items() if k != "rms_self"},
                limits | {"dq_l0_x": 1e-3}):
        with pytest.raises(ValueError, match="limits"):
            run.check_config(cfg | {"limits": bad}, mix)


def test_the_harness_takes_the_cell():
    spec = run.cell_spec(CELL)
    cfg = spec["config"]
    assert spec["cell"]["chips"] == 1 and spec["cell"]["traffic"] == "graph"
    assert cfg == config()
    assert cfg["solver"] == {"dtype": "float32", "accumulate": "auto"}
    assert cfg["control"] == {"dtype": "bfloat16"}
    m6rcm = run.load_json(PKG, "configs", "m6rcm.json")
    for key in ("load", "state"):
        assert cfg[key] == m6rcm[key], key
    bench = run.load_json(PKG, "..", "BENCHMARK.json")
    entry = {c["name"]: c for c in bench["configs"]}["fvcorr193k"]
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    assert {m["name"] for m in spec["end_to_end"]} == {"cycle_ms",
                                                       "setup_s"}
    layer = {m["name"] for m in spec["per_layer"]}
    assert layer == {"device_idle_share.graph", "replay_idle_share.graph",
                     "read_idle_share.graph", "compute_step_us",
                     "tile_local_share", "mesh_load_s", "prep_s",
                     "context_s", "plans_s", "upload_s", "capture_s"}


# -- the port against the reference ------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(configuration, the port's mesh, the reference) on the tiny
    level, written once."""
    cfg = tiny_config("fvcorr")
    old = run.CACHE
    run.CACHE = str(tmp_path_factory.mktemp("fvcorr"))
    try:
        input_dat = run.mesh_files(cfg)
        mesh = run.port_mesh(cfg, input_dat)
        ref = ReferenceSolver(run.reference_mesh(cfg, input_dat),
                              torch.device("cpu"))
    finally:
        run.CACHE = old
    return cfg, mesh, ref


def outputs(small, seed: int, **override) -> tuple:
    """(initial state, the port's snapshot, the reference's) over the
    mix's first 10 cycles."""
    cfg, mesh, ref = small
    s0 = initial_state(cfg["nodes"], seed, cfg["state"])
    solver = MGCFDSolver(mesh, run.solver_config(cfg, **override),
                         device="cpu")
    solver.load_state(s0)
    solver.run_batched(10, 10)
    return s0, run.snapshot(solver), ref.run(s0, 10)


def readings(small, seed: int, **override) -> dict:
    return check.readings(*outputs(small, seed, **override))


def test_the_port_reads_one_undamped_fvcorr_level(small):
    _, mesh, _ = small
    assert len(mesh.levels) == 1 and mesh.variant.value == "fvcorr"
    assert mesh.variant.uses_legacy_step_factor
    assert mesh.variant.ewt_damping_factor is None


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("accumulate", ["auto", "window"])
def test_float32_is_within_every_limit(small, accumulate, seed):
    limits = small[0]["limits"]
    got = readings(small, seed, accumulate=accumulate)
    assert check.judge(got, limits)[0], (got, limits)


@pytest.mark.parametrize("accumulate", ["auto", "window"])
def test_the_bfloat16_control_fails(small, accumulate):
    cfg = small[0]
    got = readings(small, SEEDS[0], accumulate=accumulate,
                   **cfg["control"])
    limits = cfg["limits"]
    assert got["dq_l0_yz"] > limits["dq_l0_yz"], (got, limits)
    assert not check.judge(got, limits)[0]


@pytest.mark.parametrize("var", ALONE)
def test_one_variables_change_alone_fails_dq_l0(small, var):
    """The port's last state with one variable's change off by 1 % and
    its residual as the port left it: only dq_l0 sees it."""
    limits = small[0]["limits"]
    s0, prog, ref = outputs(small, SEEDS[1])
    sound = check.readings(s0, prog, ref)
    v, v0 = prog["variables"][0], s0["variables"][0]
    v[:, var] = v0[:, var] + 1.01 * (v[:, var] - v0[:, var])
    got = check.readings(s0, prog, ref)
    assert {k: got[k] for k in check.NAMES} == \
        {k: sound[k] for k in check.NAMES}
    assert sound["dq_l0"] <= limits["dq_l0"] < got["dq_l0"]
    assert not check.judge(got, limits)[0]


def test_the_undamped_flow_stays_valid_for_2000_cycles(tmp_path):
    """Rodinia's default run of 2,000 cycles on 480 cells at the
    configuration's h, jitter and walls: no invalid state (run_batched
    raises on one), and the RMS falls as the flow settles."""
    cfg = tiny_config("fvcorr")
    mesh_spec = cfg["mesh"] | {"levels": [[5, 6, 5]]}
    mesh = load_multigrid_mesh(write_hierarchy(str(tmp_path),
                                               generate(mesh_spec)),
                               use_cache=False)
    s0 = initial_state([mesh.levels[0].num_nodes], SEEDS[1], cfg["state"])
    solver = MGCFDSolver(mesh, run.solver_config(cfg, accumulate="window"),
                         device="cpu")
    solver.load_state(s0)
    solver.run_batched(2000, 100)
    rms = solver.rms_history
    assert len(rms) == 2000 and np.isfinite(rms).all()
    assert rms[-1] < 1e-3 * rms[0]


# -- whole runs --------------------------------------------------------------

@contextlib.contextmanager
def scaled(var: int, by: float = 1.01):
    """Every smoothing visit's update of one variable scaled by `by`,
    where the visit produces it."""
    from mgcfd_tpu_torch.solver import solver as mod
    saved = {k: getattr(mod, k) for k in faults._VISITS}

    def wrap(orig):
        def visit(lvl, q, *rest):
            v, res, inv = orig(lvl, q, *rest)
            v = v.clone()
            if v.shape[0] == lvl.num_nodes:
                v[:, var] = q[:, var] + by * (v[:, var] - q[:, var])
            else:
                v[var] = q[var] + by * (v[var] - q[var])
            return v, v - q, inv
        return visit
    try:
        for k in faults._VISITS:
            setattr(mod, k, wrap(saved[k]))
        yield
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)


@pytest.fixture
def harness(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(run, "CACHE", str(tmp_path))
    monkeypatch.setattr(run, "require_card", HostCard)
    spec = run.cell_spec(CELL)
    spec["config"] = tiny_config("fvcorr")
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if m["name"] in ON_HOST]
    monkeypatch.setattr(run, "cell_spec", lambda name: spec)

    def go(seed=SEEDS[1], trace=0, **solver):
        spec["config"]["solver"].update(solver)
        assert run.main(["--workload", "tiny", "--seed", str(seed),
                         "--seconds", "0.2", "--trace", str(trace)]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return go


@pytest.mark.parametrize("seed", SEEDS)
def test_a_sound_run_is_correct(harness, seed):
    line = harness(seed)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"cycle_ms", "setup_s"}


def test_a_traced_run_reads_the_cells_metrics(harness):
    line = harness(trace=1)
    assert line["correct"] is True
    assert set(line["metrics"]) == ON_HOST


def test_the_bfloat16_control_is_not_correct(harness):
    line = harness(**tiny_config("fvcorr")["control"])
    assert line["correct"] is False


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_is_not_correct(harness, fault):
    with plant(fault):
        line = harness()
    assert line["correct"] is False


@pytest.mark.parametrize("var", ALONE)
def test_one_variables_update_scaled_is_not_correct(harness, var):
    with scaled(var):
        line = harness()
    assert line["correct"] is False
    dq = line["checks"]["dq_l0"]
    assert dq["value"] > dq["limit"]
