"""The cell m6rcm.shuffled.graph on the CPU: the shuffled order on disk is
a relabelling of each generator's levels; the configurations that were
there before it still write the same files; the map the harness recovers
from the coordinates round-trips and refuses points that repeat or
differ; check_config takes a renumber on load only where that map exists;
and whole runs on a tiny shuffled box with the card's look skipped: the
port, renumbered by its own renumber layer and mapped back, is judged
correct within the configuration's limits, while the bfloat16 control,
each planted fault and the port's snapshot compared without the map are
not."""
import hashlib
import json

import numpy as np
import pytest

from cfdbench import order, run
from cfdbench.faults import FAULTS, plant
from cfdbench.inputs.datfiles import read_coords, read_hierarchy, \
    write_hierarchy
from cfdbench.inputs.make import ensure, generate
from cfdbench.inputs.shuffle import level_orders
from cfdbench.tests.conftest import PKG, TINY_LEVELS, TINY_TET_LEVELS, \
    tet_spec, tiny_config
from cfdbench.tests.hostcard import HostCard
from cfdbench.tests.test_cfdbench_inputs import arrays_digest, assert_same, \
    files_digest

from mgcfd_tpu_torch.mesh.io_dat import load_multigrid_mesh

CELL = "m6rcm.shuffled.graph"
SEEDS = (7, 2 ** 31 + 4099)
# what the host stand-in reads of the cell's per-layer metrics: the
# program's own set-up spans, the rooflines' peaks and the window path's
# counters are the card's
ON_HOST = {"renumber_s", "mesh_load_s", "prep_s", "device_idle_share.graph",
           "compute_step_us", "transfer_us"}


def box_spec(order_name="structured"):
    return tiny_config("box")["mesh"] | {"order": order_name}


def spec_of(generator, order_name):
    return box_spec(order_name) if generator == "box" \
        else tet_spec(order=order_name)


# -- the order on disk -------------------------------------------------------

@pytest.mark.parametrize("generator", ["box", "tet"])
def test_shuffled_is_a_relabelling_of_the_generators_levels(generator):
    plain = generate(spec_of(generator, "structured"))
    shuf = generate(spec_of(generator, "shuffled"))
    perms = [order.node_map(a.coords, b.coords)
             for a, b in zip(plain.levels, shuf.levels)]
    for lev, (a, b, p) in enumerate(zip(plain.levels, shuf.levels, perms)):
        # a shuffle, not the identity, and the generator's seed's one
        assert (p != np.arange(p.size)).mean() > 0.9
        np.testing.assert_array_equal(
            p, level_orders([lv.num_nodes for lv in plain.levels],
                            spec_of(generator, "shuffled")["seed"])[lev])
        np.testing.assert_array_equal(b.volumes, a.volumes[p])
        for ends, w in (("edge_a", "edge_w"), ("bedge_b", "bedge_w"),
                        ("wedge_b", "wedge_w")):
            np.testing.assert_array_equal(p[getattr(b, ends)],
                                          getattr(a, ends))
            np.testing.assert_array_equal(getattr(b, w), getattr(a, w))
        np.testing.assert_array_equal(p[b.edge_b], a.edge_b)
        if a.mg_mapping is None:
            assert b.mg_mapping is None
            continue
        # the same coarse node, named in the coarse level's new ids
        assert b.mg_mapping.min() >= 0 and \
            b.mg_mapping.max() < shuf.levels[lev + 1].num_nodes
        np.testing.assert_array_equal(perms[lev + 1][b.mg_mapping],
                                      a.mg_mapping[p])


@pytest.mark.parametrize("generator", ["box", "tet"])
def test_shuffled_files_read_back_alike_by_both_readers(tmp_path, generator):
    mesh = generate(spec_of(generator, "shuffled"))
    path = write_hierarchy(str(tmp_path), mesh)
    ours = read_hierarchy(path)
    assert_same(ours, load_multigrid_mesh(path, use_cache=False,
                                          use_native=False))
    for a, b in zip(mesh.levels, ours.levels):
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.volumes, b.volumes)
        np.testing.assert_array_equal(a.mg_mapping, b.mg_mapping)
        # the reader orients each edge by the new ids, a < b
        assert (b.edge_a < b.edge_b).all()
        assert b.edge_a.size == a.edge_a.size


def test_the_coordinates_read_alone_are_the_readers(tmp_path):
    mesh = generate(box_spec("shuffled"))
    path = write_hierarchy(str(tmp_path), mesh)
    first = read_coords(path)           # parses the files, leaves the npz
    again = read_coords(path)           # from the npz alone
    for lv, a, b in zip(read_hierarchy(path).levels, first, again):
        np.testing.assert_array_equal(a, lv.coords)
        np.testing.assert_array_equal(b, lv.coords)
    assert len(first) == len(mesh.levels)


# sha256 prefixes of generate()'s arrays and ensure()'s files at tiny
# levels, and of the mesh entry as mesh.json stores it: the first five as
# the harness wrote them before the shuffled order existed
PINNED = {"m6rcm": ("c496a22782d91392", "f82a164e53fbfdb6",
                    "c08072058e00153f"),
          "m6box": ("90cc10b5a52c90b5", "ffc5e5975bd64e0f",
                    "e9692bf59d34ccca"),
          "m6rcm8": ("c496a22782d91392", "f82a164e53fbfdb6",
                     "c08072058e00153f"),
          "m6rcm64": ("c496a22782d91392", "f82a164e53fbfdb6",
                      "c08072058e00153f"),
          "tetrcm": ("fd3657faebb53ce7", "d3a656399f29adec",
                     "bf50de6597120aea"),
          "m6rcm.shuffled": ("8394353373f1500a", "486a8bf85d5d562d",
                             "0de241de8efe5bdf")}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_every_configurations_mesh_is_pinned(name, tmp_path):
    spec = run.load_json(PKG, "configs", f"{name}.json")["mesh"]
    levels = TINY_TET_LEVELS if spec["generator"] == "tet" else TINY_LEVELS
    tiny = spec | {"levels": levels}
    ensure(tiny, str(tmp_path / "m"))
    assert (arrays_digest(generate(tiny)), files_digest(tmp_path / "m"),
            hashlib.sha256(json.dumps(spec).encode()).hexdigest()[:16]) \
        == PINNED[name]


# -- the map from the coordinates --------------------------------------------

def test_the_coordinate_map_round_trips():
    rng = np.random.default_rng(3)
    pts = rng.random((500, 3))
    perm = rng.permutation(500)
    p = order.node_map(pts, pts[perm])
    np.testing.assert_array_equal(p, perm)
    state = {"variables": [rng.random((500, 5))],
             "residuals": [rng.random((500, 5))]}
    o = order.Order([p])
    port = o.to_port(state)
    np.testing.assert_array_equal(port["variables"][0],
                                  state["variables"][0][perm])
    back = o.to_file(port | {"rms": [1.0]})
    for k in ("variables", "residuals"):
        np.testing.assert_array_equal(back[k][0], state[k][0])
    assert back["rms"] == [1.0]
    assert order.Order().to_port(state) is state


@pytest.mark.parametrize("case", ["repeated", "moved", "fewer", "none"])
def test_the_coordinate_map_refuses_points_it_cannot_match(case):
    pts = np.random.default_rng(5).random((50, 3))
    other = pts.copy()
    if case == "repeated":
        pts[7] = pts[3]
        other = pts[::-1].copy()
    elif case == "moved":
        other[9, 2] = np.nextafter(other[9, 2], 2.0)
    elif case == "fewer":
        other = other[1:]
    else:
        other = None
    with pytest.raises(ValueError):
        order.node_map(pts, other)


# -- the configuration -------------------------------------------------------

def mix():
    return run.load_json(PKG, "mixes", "graph.json")


@pytest.mark.parametrize("load", [{"duplicate": 1, "renumber": True},
                                  {"duplicate": 1, "renumber": False},
                                  {"duplicate": 1}])
def test_check_config_takes_a_renumber_on_load(load):
    run.check_config(tiny_config("rcm.shuffled") | {"load": load}, mix())


@pytest.mark.parametrize("load,named", [
    ({"duplicate": 2, "renumber": True}, "duplicate 2"),
    ({"duplicate": 1, "renumber": "rcm"}, "'rcm'"),
    ({"duplicate": 1, "renumber": True, "reorder": True}, "reorder"),
    ({"renumber": True}, "load keys")])
def test_check_config_refuses_a_renumber_it_cannot_map(load, named):
    with pytest.raises(ValueError, match=named):
        run.check_config(tiny_config("rcm.shuffled") | {"load": load}, mix())


def test_the_harness_takes_the_configuration():
    spec = run.cell_spec(CELL)
    cfg = spec["config"]
    assert spec["cell"]["chips"] == 1 and spec["mix"] == mix()
    m6rcm = run.load_json(PKG, "configs", "m6rcm.json")
    assert cfg["mesh"] == m6rcm["mesh"] | {"order": "shuffled"}
    assert cfg["load"] == {"duplicate": 1, "renumber": True}
    for key in ("solver", "control", "state", "nodes", "limits"):
        assert cfg[key] == m6rcm[key], key
    bench = run.load_json(PKG, "..", "BENCHMARK.json")
    entry = {c["name"]: c for c in bench["configs"]}["m6rcm.shuffled"]
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    assert {m["name"] for m in spec["end_to_end"]} == {"cycle_ms",
                                                       "setup_s"}
    layer = {m["name"] for m in spec["per_layer"]}
    assert {"renumber_s", "tile_local_share", "mesh_load_s"} <= layer
    assert not any("roofline" in m for m in layer)
    others = [w["name"] for w in bench["workloads"] if w["name"] != CELL]
    reader = {m["name"]: m for m in bench["per_layer"]}["renumber_s"]
    assert reader["workloads"] == [CELL] and reader["moves"] == "setup_s"
    assert all(run.cell_spec(w)["config"]["load"] == {"duplicate": (
        8 if w == "m6rcm8.graph" else 1)} for w in others)


# -- whole runs --------------------------------------------------------------

@pytest.fixture
def harness(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(run, "CACHE", str(tmp_path))
    monkeypatch.setattr(run, "require_card", HostCard)
    spec = run.cell_spec(CELL)
    spec["config"] = tiny_config("rcm.shuffled")
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if m["name"] in ON_HOST]
    monkeypatch.setattr(run, "cell_spec", lambda name: spec)

    def go(seed=SEEDS[1], trace=0, **solver):
        spec["config"]["solver"].update(solver)
        assert run.main(["--workload", "tiny", "--seed", str(seed),
                         "--seconds", "0.2", "--trace", str(trace)]) == 0
        out, err = capsys.readouterr()
        record = json.loads([ln for ln in err.splitlines()
                             if ln.startswith("{")][-1])
        return json.loads(out.strip().splitlines()[-1]), record
    return go


@pytest.mark.parametrize("seed", SEEDS)
def test_the_renumbered_port_is_correct(harness, seed):
    line, record = harness(seed)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"cycle_ms", "setup_s"}
    assert record["spans"]["renumber_s"] > 0
    assert record["nodes"] == tiny_config("rcm.shuffled")["nodes"]


def test_a_traced_run_reads_renumber_s(harness):
    line, _ = harness(trace=1)
    assert line["correct"] is True
    assert set(line["metrics"]) == ON_HOST
    assert line["metrics"]["renumber_s"]["value"] > 0


def test_the_bfloat16_control_is_not_correct(harness):
    line, _ = harness(**tiny_config("rcm.shuffled")["control"])
    assert line["correct"] is False
    assert line["checks"]["dq_l0_yz"]["value"] > \
        line["checks"]["dq_l0_yz"]["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_is_not_correct(harness, fault):
    with plant(fault):
        line, _ = harness()
    assert line["correct"] is False


@pytest.mark.parametrize("where", ["identity map", "snapshot unmapped"])
def test_the_ports_order_compared_without_the_map_is_not_correct(
        harness, monkeypatch, where):
    if where == "identity map":
        monkeypatch.setattr(order, "node_map",
                            lambda f, p: np.arange(f.shape[0]))
    else:
        monkeypatch.setattr(order.Order, "to_file", lambda self, snap: snap)
    line, record = harness()
    assert line["correct"] is False
    assert line["checks"]["dq_l0_yz"]["value"] > 1.0
