"""The benchmark's frozen inputs equal the port's box and tetrahedral
levels, RCM order, duplication, files and reader at small sizes (the test
imports the port; the inputs do not), and its hierarchies are sized and
mapped as their configurations say. Every configuration's mesh entry
generates the arrays and files it generated before the tet generator was
added (digests pinned then)."""
import filecmp
import hashlib
import json
import os

import numpy as np
import pytest
from scipy.spatial import Delaunay

from cfdbench.inputs.box import _box_level, generate_box_hierarchy
from cfdbench.inputs.datfiles import read_hierarchy, write_hierarchy
from cfdbench.inputs.duplicate import duplicate_hierarchy
from cfdbench.inputs.make import check_spec, ensure, generate
from cfdbench.inputs.rcm import renumber_hierarchy
from cfdbench.inputs.tet import _delaunay_level, _jittered_points, \
    generate_tet_hierarchy
from cfdbench.run import check_config, load_json
from cfdbench.tests.conftest import PKG, TINY_LEVELS, TINY_TET_LEVELS, \
    tet_spec, tiny_config, tiny_tet_config

from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.core.types import LEVEL_ARRAYS, MeshLevel, \
    MultigridMesh
from mgcfd_tpu_torch.mesh import duplicate_mesh
from mgcfd_tpu_torch.mesh import generate as port_box
from mgcfd_tpu_torch.mesh import unstructured as port_tet
from mgcfd_tpu_torch.mesh.io_dat import load_multigrid_mesh, \
    write_multigrid_mesh
from mgcfd_tpu_torch.prep.renumber import renumber_hierarchy as port_rcm

KW = dict(h=(0.1, 0.1, 0.1), volume_jitter=0.2, seed=0)


def assert_same(ours, theirs):
    assert len(ours.levels) == len(theirs.levels)
    for a, b in zip(ours.levels, theirs.levels):
        for f in LEVEL_ARRAYS:
            x, y = getattr(a, f), getattr(b, f)
            if y is None:
                assert x is None, f
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def as_port(mesh):
    """The same arrays as the port's mesh type."""
    return MultigridMesh(
        levels=[MeshLevel(**{f: getattr(lv, f) for f in LEVEL_ARRAYS})
                for lv in mesh.levels],
        variant=MeshVariant(mesh.variant), problem_size=mesh.problem_size)


def ours():
    return generate_box_hierarchy(TINY_LEVELS, **KW)


@pytest.mark.parametrize("dims,h", [((9, 7, 10), (0.1, 0.1, 0.1)),
                                    ((4, 6, 5), (0.2, 0.1, 0.3))])
def test_a_level_equals_the_ports(dims, h):
    a = _box_level(*dims, h, (0.0, 0.0, 0.0), 0.2, 3)
    b = port_box._box_level(*dims, h, (0.0, 0.0, 0.0), 0.2, 3)
    for f in LEVEL_ARRAYS:
        if f != "mg_mapping":
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def test_levels_are_sized_and_mapped_to_the_nearest_coarse_node():
    mesh = ours()
    assert [lv.num_nodes for lv in mesh.levels] == \
        [int(np.prod(d)) for d in TINY_LEVELS]
    lo, hi = mesh.levels[0].coords.min(0), mesh.levels[0].coords.max(0)
    for fine, coarse in zip(mesh.levels, mesh.levels[1:]):
        np.testing.assert_allclose(coarse.coords.min(0), lo)
        np.testing.assert_allclose(coarse.coords.max(0), hi)
        d = np.linalg.norm(fine.coords[:, None] - coarse.coords[None],
                           axis=2)
        mapped = d[np.arange(fine.num_nodes), fine.mg_mapping]
        np.testing.assert_allclose(mapped, d.min(axis=1), atol=1e-12)
        sums = np.bincount(fine.mg_mapping, fine.volumes,
                           minlength=coarse.num_nodes)
        np.testing.assert_allclose(coarse.volumes, sums, rtol=1e-15)
        assert (sums > 0).all()


def test_a_level_finer_than_the_one_above_is_refused():
    with pytest.raises(ValueError):
        generate_box_hierarchy([[6, 6, 6], [7, 6, 6]], **KW)


def test_rcm_equals_the_ports():
    mesh = ours()
    assert_same(renumber_hierarchy(mesh), port_rcm(as_port(mesh)))


def test_duplication_equals_the_ports():
    mesh = renumber_hierarchy(ours())
    assert_same(duplicate_hierarchy(mesh, 3), duplicate_mesh(as_port(mesh),
                                                             3))
    assert duplicate_hierarchy(mesh, 1) is mesh


def test_files_equal_the_ports_and_read_back(tmp_path):
    mesh = renumber_hierarchy(ours())
    write_hierarchy(str(tmp_path / "ours"), mesh)
    write_multigrid_mesh(str(tmp_path / "theirs"), as_port(mesh))
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == names
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "ours", tmp_path / "theirs", names, shallow=False)
    assert not mismatch and not errors
    parsed = load_multigrid_mesh(str(tmp_path / "theirs" / "input.dat"),
                                 use_cache=False, use_native=False)
    first = read_hierarchy(str(tmp_path / "ours" / "input.dat"))
    assert os.path.exists(tmp_path / "ours" / "reference_mesh.npz")
    again = read_hierarchy(str(tmp_path / "ours" / "input.dat"))
    assert_same(first, parsed)
    assert_same(again, parsed)


def test_ensure_writes_once(tmp_path):
    spec = tiny_config("box")["mesh"]
    path = ensure(spec, str(tmp_path / "m"))
    stamp = os.path.getmtime(path)
    assert ensure(spec, str(tmp_path / "m")) == path
    assert os.path.getmtime(path) == stamp
    assert_same(read_hierarchy(path), generate(spec))


@pytest.mark.parametrize("change", [{"order": "hilbert"},
                                    {"generator": "tet"},
                                    {"renumber": "rcm"}])
def test_a_mesh_entry_not_read_is_refused(change):
    spec = tiny_config("box")["mesh"] | change
    with pytest.raises(ValueError):
        check_spec(spec)


def test_reader_refuses_trailing_values(tmp_path):
    write_hierarchy(str(tmp_path), ours())
    with open(tmp_path / "level0.dat", "a") as f:
        f.write("1.0\n")
    with pytest.raises(ValueError):
        read_hierarchy(str(tmp_path / "input.dat"))


# -- the tetrahedral generator -----------------------------------------------

def assert_same_level(a, b):
    for f in LEVEL_ARRAYS:
        if f != "mg_mapping":
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, f)


@pytest.mark.parametrize("dims,h,wall_frac", [
    ((9, 7, 10), 0.1, 0.2), ((6, 8, 5), (0.2, 0.1, 0.3), 0.35)])
def test_a_tet_level_equals_the_ports(dims, h, wall_frac):
    rng = np.random.default_rng(11)
    ours = _delaunay_level(_jittered_points(*dims, h, 0.35, rng), rng,
                           wall_frac)
    if np.ndim(h) == 0 and wall_frac == 0.2:
        theirs = port_tet.generate_unstructured_mesh(*dims, h=h,
                                                     jitter=0.35, seed=11)
    else:
        # the port's level functions, handed the per-axis spacing
        rng = np.random.default_rng(11)
        pts = port_tet._jittered_points(*dims, np.asarray(h), 0.35, rng)
        pts = pts[rng.permutation(pts.shape[0])]
        tri = Delaunay(pts)
        theirs = port_tet.tet_dual_level(
            pts, tri.simplices.astype(np.int64),
            tri.convex_hull.astype(np.int64), wall_frac)
    assert_same_level(ours, theirs)
    assert ours.wedge_b.size and ours.bedge_b.size


def test_the_tet_hierarchy_equals_the_ports_where_it_halves():
    """2^k + 1 points an axis: the port's halving spans the same box."""
    ours = generate_tet_hierarchy([[9, 9, 9], [5, 5, 5], [3, 3, 3]],
                                  h=(0.1, 0.1, 0.1), seed=3)
    assert_same(ours, port_tet.generate_unstructured_hierarchy(
        9, 9, 9, 3, h=0.1, seed=3))


def test_tet_levels_are_sized_and_mapped_to_the_nearest_coarse_node():
    mesh = generate(tet_spec(order="structured"))
    assert [lv.num_nodes for lv in mesh.levels] == \
        [int(np.prod(d)) for d in TINY_TET_LEVELS]
    lo, hi = mesh.levels[0].coords.min(0), mesh.levels[0].coords.max(0)
    np.testing.assert_allclose(hi - lo, 0.1 * (np.array(TINY_TET_LEVELS[0])
                                               - 1))
    unmapped = 0
    for fine, coarse in zip(mesh.levels, mesh.levels[1:]):
        np.testing.assert_allclose(coarse.coords.min(0), lo, atol=1e-15)
        np.testing.assert_allclose(coarse.coords.max(0), hi)
        d = np.linalg.norm(fine.coords[:, None] - coarse.coords[None],
                           axis=2)
        mapped = d[np.arange(fine.num_nodes), fine.mg_mapping]
        np.testing.assert_array_equal(mapped, d.min(axis=1))
        unmapped += coarse.num_nodes - np.unique(fine.mg_mapping).size
    assert unmapped > 0
    for lv in mesh.levels:
        assert (lv.volumes > 0).all()
        np.testing.assert_allclose(lv.volumes.sum(), np.prod(hi - lo))
        # long rows: 7.3 a node at scale, above 5 even here; the box < 3
        assert lv.edge_a.size > 5 * lv.num_nodes
    assert mesh.levels[-1].mg_mapping is None


@pytest.mark.parametrize("order", ["structured", "rcm"])
def test_the_same_tet_spec_gives_identical_arrays(order):
    assert_same(generate(tet_spec(order=order)),
                generate(tet_spec(order=order)))


@pytest.mark.parametrize("order", ["structured", "rcm"])
def test_tet_files_read_back_equal(tmp_path, order):
    mesh = generate(tet_spec(order=order))
    path = write_hierarchy(str(tmp_path), mesh)
    parsed = load_multigrid_mesh(path, use_cache=False, use_native=False)
    ours = read_hierarchy(path)
    assert_same(ours, parsed)
    if order == "structured":
        # the generator lists each edge at its larger end, a < b, as the
        # reader emits it
        assert_same(ours, mesh)


def test_a_tet_configuration_is_accepted_written_once_and_loaded(tmp_path):
    cfg = tiny_tet_config()
    check_config(cfg, load_json(PKG, "mixes", "graph.json"))
    path = ensure(cfg["mesh"], str(tmp_path / "m"))
    stamp = os.path.getmtime(path)
    assert ensure(cfg["mesh"], str(tmp_path / "m")) == path
    assert os.path.getmtime(path) == stamp
    mesh = load_multigrid_mesh(path)
    assert [lv.num_nodes for lv in mesh.levels] == cfg["nodes"]
    assert_same(read_hierarchy(path), mesh)


MISSING = object()


@pytest.mark.parametrize("change,named", [
    ({"volume_jitter": 0.2}, "volume_jitter"),
    ({"generator": "box"}, "volume_jitter"),
    ({"generator": "hex"}, "hex"),
    ({"order": "hilbert"}, "hilbert"),
    *(({key: MISSING}, key) for key in sorted(tet_spec()))])
def test_a_tet_mesh_entry_not_read_is_refused(change, named):
    spec = {k: v for k, v in (tet_spec() | change).items()
            if v is not MISSING}
    with pytest.raises(ValueError, match=named):
        generate(spec)


# -- every configuration's mesh entry, pinned --------------------------------

FIELDS = ("volumes", "coords", "edge_a", "edge_b", "edge_w", "bedge_b",
          "bedge_w", "wedge_b", "wedge_w", "mg_mapping")
# sha256 prefixes of generate()'s arrays and of ensure()'s files at
# TINY_LEVELS, by order, and of each configuration's mesh entry as
# json.dumps writes it into mesh.json
PINNED = {"structured": ("90cc10b5a52c90b5", "ffc5e5975bd64e0f"),
          "rcm": ("c496a22782d91392", "f82a164e53fbfdb6")}
PINNED_SPECS = {"m6rcm": "c08072058e00153f", "m6box": "e9692bf59d34ccca",
                "m6rcm8": "c08072058e00153f", "m6rcm64": "c08072058e00153f"}


def arrays_digest(mesh) -> str:
    h = hashlib.sha256()
    for lv in mesh.levels:
        for f in FIELDS:
            x = getattr(lv, f)
            h.update(f.encode())
            if x is not None:
                h.update(f"{x.dtype.str}{x.shape}".encode())
                h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()[:16]


def files_digest(directory) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(directory)):
        h.update(name.encode())
        with open(os.path.join(directory, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", ["m6rcm", "m6box", "m6rcm8", "m6rcm64"])
@pytest.mark.parametrize("order", ["structured", "rcm"])
def test_every_configurations_mesh_is_unchanged(name, order, tmp_path):
    spec = load_json(PKG, "configs", f"{name}.json")["mesh"]
    check_spec(spec)
    assert hashlib.sha256(json.dumps(spec).encode()).hexdigest()[:16] \
        == PINNED_SPECS[name]
    tiny = spec | {"levels": TINY_LEVELS, "order": order}
    ensure(tiny, str(tmp_path / "m"))
    assert (arrays_digest(generate(tiny)),
            files_digest(tmp_path / "m")) == PINNED[order]
