"""The port's native mesh parser (mgcfd_tpu_torch/native/) against its
Python reader, bit for bit, and against mgcfd_tpu's native parser: every
MeshVariant on box and tet levels, the MG connectivity, a missing file,
malformed files (the same exception and text as the Python reader's),
the edge-count warning, and where and when the library builds."""
import os
import shutil
import time

import numpy as np
import pytest

from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.native import loader as jax_native
from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.core.types import LEVEL_ARRAYS
from mgcfd_tpu_torch.mesh import (MeshFormatError, generate_box_mesh,
                                  generate_unstructured_hierarchy,
                                  load_multigrid_mesh, read_grid_dat,
                                  read_mg_connectivity, write_grid_dat,
                                  write_mg_connectivity,
                                  write_multigrid_mesh)
from mgcfd_tpu_torch.native import loader
from mgcfd_tpu_torch.utils import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_bit_equal(got, want):
    for f in LEVEL_ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f


def level(kind):
    if kind == "box":
        return generate_box_mesh(6, 5, 4, h=(0.1, 0.1, 0.1),
                                 volume_jitter=0.3, seed=11)
    return generate_unstructured_hierarchy(6, 5, 5, 1, seed=4).levels[0]


def test_library_builds_under_build():
    assert loader.native_available()
    assert loader.LIBRARY.parent == \
        __import__("pathlib").Path(REPO) / "build" / "mgcfd_tpu_torch"
    assert loader.LIBRARY.is_file()


@pytest.mark.parametrize("variant", list(MeshVariant), ids=lambda v: v.name)
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_native_equals_python_reader(tmp_path, kind, variant):
    """Bit for bit, the coords included, and the same as mgcfd_tpu's
    native parser on the same file."""
    path = str(tmp_path / "m.dat")
    write_grid_dat(path, level(kind), variant)
    before = spans.counters("mesh.reads.")
    nat = read_grid_dat(path, variant, use_native=True)
    py = read_grid_dat(path, variant, use_native=False)
    after = spans.counters("mesh.reads.")
    assert after["native"] == before.get("native", 0) + 1
    assert after["python"] == before.get("python", 0) + 1
    assert_bit_equal(nat, py)
    ref = jax_native.parse_dat_native(
        path, JaxVariant[variant.name].flips_all_normals, True)
    if ref is None:
        pytest.skip("mgcfd_tpu's native parser did not build")
    assert_bit_equal(nat, ref)


def test_hierarchy_and_mg_connectivity(tmp_path):
    mesh = generate_unstructured_hierarchy(7, 6, 6, 3, seed=2)
    path = write_multigrid_mesh(str(tmp_path / "tet"), mesh)
    nat = load_multigrid_mesh(path, use_cache=False, use_native=True)
    py = load_multigrid_mesh(path, use_cache=False, use_native=False)
    for a, b in zip(nat.levels, py.levels):
        assert_bit_equal(a, b)
        assert (a.mg_mapping is None) == (b.mg_mapping is None)
        if a.mg_mapping is not None:
            assert a.mg_mapping.dtype == b.mg_mapping.dtype == np.int64
            np.testing.assert_array_equal(a.mg_mapping, b.mg_mapping)
    m = np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.int64)
    p = str(tmp_path / "mg.dat")
    write_mg_connectivity(p, m)
    np.testing.assert_array_equal(read_mg_connectivity(p, use_native=True),
                                  m)
    np.testing.assert_array_equal(loader.parse_mg_native(p), m)


def test_missing_file_raises_as_python():
    for use_native in (True, False):
        with pytest.raises(FileNotFoundError):
            read_grid_dat("/nonexistent/mesh.dat", MeshVariant.FVCORR,
                          use_native=use_native)
        with pytest.raises(FileNotFoundError):
            read_mg_connectivity("/nonexistent/mg.dat", use_native)
    with pytest.raises(loader.NativeParseError, match="cannot read"):
        loader.parse_dat_native("/nonexistent/mesh.dat", False, False)


MALFORMED = {
    "empty": "",
    "header": "2 x\n1.0 0\n1.0 0\n",
    "node count": "0 0\n",
    "negative degree": "2 0\n1.0 -3\n1.0 0\n",
    "truncated": "2 1\n1.0 1 1 1.0 0.0 0.0\n1.0 1 0 1.0",
    "float degree": "2 0\n1.0 1.5\n1.0 0\n",
    "word in record": "2 1\n1.0 1 1 1.0 banana 0.0\n1.0 1 0 1.0 0.0 0.0\n",
    "id below -2": "2 1\n1.0 0\n1.0 1 -7 1.0 0.0 0.0\n",
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_file_raises_the_python_readers_error(tmp_path, case):
    p = tmp_path / "bad.dat"
    p.write_text(MALFORMED[case])
    errors = []
    for use_native in (True, False):
        with pytest.raises(ValueError) as e:
            read_grid_dat(str(p), MeshVariant.M6_WING, use_native=use_native)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    with pytest.raises(loader.NativeParseError):
        loader.parse_dat_native(str(p), False, False)


def test_malformed_coords_and_mg(tmp_path):
    lvl = level("box")
    p = str(tmp_path / "m.dat")
    write_grid_dat(p, lvl, MeshVariant.FVCORR)
    rows = open(p + ".coords").read().splitlines()
    for text in ("\n".join(rows[:-2]), "\n".join(rows + rows[:1])):
        with open(p + ".coords", "w") as f:
            f.write(text)
        errs = []
        for use_native in (True, False):
            with pytest.raises(MeshFormatError) as e:
                read_grid_dat(p, MeshVariant.FVCORR, use_native=use_native)
            errs.append(str(e.value))
        assert errs[0] == errs[1] and "x y z" in errs[0]
    mg = tmp_path / "mg.dat"
    for text in ("notanumber\n1 2 3\n", "4\n1 2 3", "3\n1 2 3.5\n"):
        mg.write_text(text)
        errs = []
        for use_native in (True, False):
            with pytest.raises(MeshFormatError) as e:
                read_mg_connectivity(str(mg), use_native)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_edge_count_warning_is_the_python_readers(tmp_path, capsys):
    p = tmp_path / "m.dat"
    write_grid_dat(str(p), level("box"), MeshVariant.FVCORR)
    toks = p.read_text().split()
    toks[1] = str(int(toks[1]) + 7)
    p.write_text(" ".join(toks))
    outs = []
    for use_native in (True, False):
        got = read_grid_dat(str(p), MeshVariant.FVCORR,
                            use_native=use_native)
        outs.append(capsys.readouterr().out)
        assert got.num_internal_edges == level("box").num_internal_edges
    assert outs[0] == outs[1] and outs[0].startswith("WARNING")


def test_rebuilds_when_the_source_is_newer(tmp_path, monkeypatch):
    src = tmp_path / "mesh_parser.cpp"
    shutil.copy(loader.SOURCE, src)
    lib = tmp_path / "build" / "libmgcfd_torch_native.so"
    monkeypatch.setattr(loader, "SOURCE", src)
    monkeypatch.setattr(loader, "BUILD_DIR", lib.parent)
    monkeypatch.setattr(loader, "LIBRARY", lib)
    loader._build()
    first = lib.stat().st_mtime_ns
    loader._build()                         # up to date: nothing built
    assert lib.stat().st_mtime_ns == first
    later = time.time() + 5
    os.utime(src, (later, later))
    loader._build()
    assert lib.stat().st_mtime_ns != first
    assert not list(lib.parent.glob("*.tmp.so"))
