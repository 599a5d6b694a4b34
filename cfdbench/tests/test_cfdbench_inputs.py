"""The benchmark's frozen inputs equal the port's box level, RCM order,
duplication, files and reader at small sizes (the test imports the port;
the inputs do not), and its hierarchies are sized and mapped as their
configurations say."""
import filecmp
import os

import numpy as np
import pytest

from cfdbench.inputs.box import _box_level, generate_box_hierarchy
from cfdbench.inputs.datfiles import read_hierarchy, write_hierarchy
from cfdbench.inputs.duplicate import duplicate_hierarchy
from cfdbench.inputs.make import check_spec, ensure, generate
from cfdbench.inputs.rcm import renumber_hierarchy
from cfdbench.tests.conftest import TINY_LEVELS, tiny_config

from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.core.types import LEVEL_ARRAYS, MeshLevel, \
    MultigridMesh
from mgcfd_tpu_torch.mesh import duplicate_mesh
from mgcfd_tpu_torch.mesh import generate as port_box
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


@pytest.mark.parametrize("change", [{"order": "shuffled"},
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
