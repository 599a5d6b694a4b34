"""The port's reference-format mesh files against mgcfd_tpu.mesh: the
.dat/.coords/.mg/input.dat writers and readers, the npz sidecar cache,
duplicate_mesh, generate_unstructured_mesh, dual_closure_error and the
CLI's -i/-d/-m/--renumber.

Both writers give the same bytes; each package reads the other's files
(mgcfd_tpu through its Python parser and, where it builds, its native
one) to equal arrays; the reader raises MeshFormatError on each malformed
input of tests/test_io_robustness.py; each package loads a sidecar the
other wrote."""
import os

import numpy as np
import pytest

from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.mesh import cache as jax_cache
from mgcfd_tpu.mesh import duplicate_mesh as jax_duplicate
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh import io_dat as jax_io
from mgcfd_tpu.mesh.unstructured import (
    dual_closure_error as jax_closure,
    generate_unstructured_hierarchy as jax_tet,
    generate_unstructured_mesh as jax_tet_level)
from mgcfd_tpu.native.loader import native_available
from mgcfd_tpu_torch.cli.main import main as cli_main
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.core.types import LEVEL_ARRAYS, MeshLevel
from mgcfd_tpu_torch.mesh import (MeshFormatError, cache, duplicate_mesh,
                                  dual_closure_error, generate_box_mesh,
                                  generate_unstructured_mesh, io_dat,
                                  load_multigrid_mesh, read_grid_dat,
                                  read_mg_connectivity, write_grid_dat,
                                  write_mg_connectivity,
                                  write_multigrid_mesh)

JAX_PARSERS = [False] + ([True] if native_available() else [])
VAR = MeshVariant.FVCORR


def assert_levels_equal(got, want, dtypes=True):
    for f in LEVEL_ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
            if dtypes:
                assert np.asarray(a).dtype == np.asarray(b).dtype, f


def assert_meshes_equal(got, want):
    assert got.variant.value == want.variant.value
    assert got.num_levels == want.num_levels
    assert got.problem_size == want.problem_size
    for g, w in zip(got.levels, want.levels):
        assert_levels_equal(g, w)


def jax_hierarchy(kind, variant):
    v = JaxVariant[variant.name]
    if kind == "box":
        return jax_mg_box(6, 5, 4, 2, h=(0.1, 0.1, 0.1), variant=v,
                          volume_jitter=0.2, seed=0)
    return jax_tet(7, 6, 6, 2, seed=2, h=0.1, variant=v)


# --- .dat files across the two packages ---------------------------------

@pytest.mark.parametrize("variant", [MeshVariant.FVCORR,
                                     MeshVariant.M6_WING])
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_dat_files_across_packages(tmp_path, kind, variant):
    """Each level written by both packages: the same bytes; the port reads
    mgcfd_tpu's file and mgcfd_tpu reads the port's, each to the level's
    arrays."""
    jm = jax_hierarchy(kind, variant)
    pm = mesh_from_arrays(jm)
    for jl, pl in zip(jm.levels, pm.levels):
        jax_io.write_grid_dat(str(tmp_path / "j.dat"), jl, jm.variant)
        write_grid_dat(str(tmp_path / "p.dat"), pl, variant)
        for ext in ("", ".coords"):
            assert (tmp_path / f"j.dat{ext}").read_bytes() == \
                (tmp_path / f"p.dat{ext}").read_bytes()
        got = read_grid_dat(str(tmp_path / "j.dat"), variant)
        assert_levels_equal(got, MeshLevel(**{
            f: getattr(pl, f) for f in LEVEL_ARRAYS if f != "mg_mapping"}))
        for native in JAX_PARSERS:
            back = jax_io.read_grid_dat(str(tmp_path / "p.dat"), jm.variant,
                                        use_native=native)
            assert_levels_equal(back, got)


@pytest.mark.parametrize("kind", ["box", "tet"])
def test_hierarchy_files_across_packages(tmp_path, kind):
    """write_multigrid_mesh + load_multigrid_mesh (cold and through the
    cache) round-trip exactly, and mgcfd_tpu loads the same directory to
    the same arrays; input.dat and the mg files read alike."""
    jm = jax_hierarchy(kind, MeshVariant.M6_WING)
    pm = mesh_from_arrays(jm)
    path = write_multigrid_mesh(str(tmp_path), pm)
    cold = load_multigrid_mesh(path, use_cache=False)
    for got in (cold, load_multigrid_mesh(path),
                load_multigrid_mesh(path)):
        assert_meshes_equal(got, pm)
    ref = jax_io.load_multigrid_mesh(path, use_cache=False)
    assert_meshes_equal(cold, ref)
    assert io_dat.read_input_dat(path)[:2] == \
        jax_io.read_input_dat(path)[:2]
    mg = str(tmp_path / "mg0.dat")
    np.testing.assert_array_equal(read_mg_connectivity(mg),
                                  jax_io.read_mg_connectivity(mg))


def test_mg_connectivity_written_alike(tmp_path):
    mapping = np.array([3, 0, 2, 2, 1], dtype=np.int64)
    write_mg_connectivity(str(tmp_path / "p"), mapping)
    jax_io.write_mg_connectivity(str(tmp_path / "j"), mapping)
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    np.testing.assert_array_equal(
        read_mg_connectivity(str(tmp_path / "p")), mapping)


# --- the npz sidecar cache ----------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_loads_across_packages(tmp_path, monkeypatch, writer):
    """A sidecar one package wrote is a hit for the other: its parser is
    never called, and the arrays equal the parsed ones."""
    pm = mesh_from_arrays(jax_hierarchy("tet", MeshVariant.M6_WING))
    path = write_multigrid_mesh(str(tmp_path), pm)
    if writer == "port":
        load_multigrid_mesh(path)
        monkeypatch.setattr(jax_io, "read_grid_dat", _no_parse)
        got = jax_io.load_multigrid_mesh(path)
    else:
        jax_io.load_multigrid_mesh(path)
        monkeypatch.setattr(io_dat, "read_grid_dat", _no_parse)
        got = load_multigrid_mesh(path)
    assert os.path.isdir(tmp_path / cache.CACHE_DIR_NAME)
    for g, w in zip(got.levels, pm.levels):
        assert_levels_equal(g, w, dtypes=False)


def _no_parse(*args, **kwargs):
    raise AssertionError("the parser ran on a cache hit")


def test_stale_or_corrupt_cache_falls_back_to_the_parser(tmp_path):
    lvl = mesh_from_arrays(jax_hierarchy("box", VAR)).levels[0]
    p = str(tmp_path / "m.dat")
    write_grid_dat(p, lvl, VAR)
    cache.load_mesh_cached(p, VAR)
    cpath = cache._cache_path(p)
    # stale: the source's mtime no longer matches the sidecar's record
    lvl2 = MeshLevel(**{f: getattr(lvl, f) for f in LEVEL_ARRAYS})
    lvl2.volumes = lvl.volumes * 2.0
    write_grid_dat(p, lvl2, VAR)
    os.utime(p, (1e9, 1e9))
    np.testing.assert_array_equal(cache.load_mesh_cached(p, VAR).volumes,
                                  lvl2.volumes)
    with open(cpath, "wb") as f:
        f.write(b"not an npz")
    np.testing.assert_array_equal(cache.load_mesh_cached(p, VAR).volumes,
                                  lvl2.volumes)
    assert jax_cache._FORMAT == cache._FORMAT
    assert jax_cache.CACHE_DIR_NAME == cache.CACHE_DIR_NAME


# --- duplicate_mesh and the unstructured generator ----------------------

@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_duplicate_mesh_equals_jax(kind, m):
    jm = jax_hierarchy(kind, MeshVariant.M6_WING)
    got = duplicate_mesh(mesh_from_arrays(jm), m)
    assert_meshes_equal(got, jax_duplicate(jm, m))


@pytest.mark.parametrize("seed", [0, 5])
def test_unstructured_mesh_and_closure_equal_jax(seed):
    got = generate_unstructured_mesh(7, 5, 6, h=0.3, seed=seed)
    want = jax_tet_level(7, 5, 6, h=0.3, seed=seed)
    assert_levels_equal(got, want)
    assert dual_closure_error(got) == jax_closure(want)
    assert dual_closure_error(got) < 1e-12


# --- malformed input: the cases of tests/test_io_robustness.py ----------

@pytest.fixture()
def clean_dat(tmp_path):
    lvl = generate_box_mesh(4, 3, 3, h=(0.1, 0.1, 0.1), volume_jitter=0.2)
    p = tmp_path / "m.dat"
    write_grid_dat(str(p), lvl, VAR)
    return p, lvl


def _tokens(path):
    return open(path).read().split()


def test_truncated_neighbour_records(clean_dat):
    p, _ = clean_dat
    toks = _tokens(p)
    p.write_text(" ".join(toks[:len(toks) * 2 // 3]))
    with pytest.raises(MeshFormatError, match="node"):
        read_grid_dat(str(p), VAR)


def test_missing_header(tmp_path):
    p = tmp_path / "empty.dat"
    p.write_text("")
    with pytest.raises(MeshFormatError, match="header"):
        read_grid_dat(str(p), VAR)


def test_nonpositive_node_count(tmp_path):
    p = tmp_path / "zero.dat"
    p.write_text("0 0\n")
    with pytest.raises(MeshFormatError, match="node count"):
        read_grid_dat(str(p), VAR)


def test_negative_degree(tmp_path):
    p = tmp_path / "negdeg.dat"
    p.write_text("2 0\n1.0 -3\n1.0 0\n")
    with pytest.raises(MeshFormatError, match="negative degree"):
        read_grid_dat(str(p), VAR)


@pytest.mark.parametrize("at", [0, 2, 3, 7, -1])
def test_non_numeric_token(clean_dat, at):
    """A word in place of the header, the first volume, its degree, a
    neighbour record or the last weight; mgcfd_tpu's parser raises on
    each too."""
    p, _ = clean_dat
    toks = _tokens(p)
    toks[at] = "banana"
    p.write_text(" ".join(toks))
    with pytest.raises(MeshFormatError):
        read_grid_dat(str(p), VAR)
    with pytest.raises(jax_io.MeshFormatError):
        jax_io.read_grid_dat(str(p), JaxVariant.FVCORR, use_native=False)


def test_trailing_tokens_ignored_as_in_jax(clean_dat):
    p, lvl = clean_dat
    p.write_text(p.read_text() + " banana 7\n")
    assert_levels_equal(read_grid_dat(str(p), VAR),
                        jax_io.read_grid_dat(str(p), JaxVariant.FVCORR,
                                             use_native=False))


def test_edge_count_mismatch_warns_and_continues(clean_dat, capsys):
    p, lvl = clean_dat
    toks = _tokens(p)
    toks[1] = str(int(toks[1]) + 7)
    p.write_text(" ".join(toks))
    got = read_grid_dat(str(p), VAR)
    assert "WARNING" in capsys.readouterr().out
    assert got.num_internal_edges == lvl.num_internal_edges


def test_crlf_and_foreign_whitespace(clean_dat):
    p, lvl = clean_dat
    text = open(p).read()
    p.write_text(text.replace("\n", "\r\n").replace(" ", "\t  "))
    got = read_grid_dat(str(p), VAR)
    np.testing.assert_array_equal(got.edge_a, lvl.edge_a)
    np.testing.assert_array_equal(got.edge_w, lvl.edge_w)
    np.testing.assert_array_equal(got.volumes, lvl.volumes)


def test_duplicate_neighbour_entries_agree_with_jax(tmp_path):
    """A neighbour listed twice gives two identical edges, as in both of
    mgcfd_tpu's parsers."""
    p = tmp_path / "dup.dat"
    p.write_text("2 3\n"
                 "1.0 1 -2 0.0 0.0 1.0\n"
                 "1.0 2 0 1.0 0.0 0.0 0 1.0 0.0 0.0\n")
    got = read_grid_dat(str(p), VAR)
    assert got.num_internal_edges == 2
    assert_levels_equal(got, jax_io.read_grid_dat(str(p), JaxVariant.FVCORR,
                                                  use_native=False))


def test_out_of_range_neighbour_dropped_with_warning(tmp_path, capsys):
    p = tmp_path / "oor.dat"
    p.write_text("2 2\n"
                 "1.0 1 99 1.0 0.0 0.0\n"
                 "1.0 1 0 1.0 0.0 0.0\n")
    got = read_grid_dat(str(p), VAR)
    assert "WARNING" in capsys.readouterr().out
    assert got.num_internal_edges == 1 and got.num_edges == 1


def test_truncated_coords(clean_dat):
    p, _ = clean_dat
    coords = open(str(p) + ".coords").read().splitlines()
    with open(str(p) + ".coords", "w") as f:
        f.write("\n".join(coords[:-2]))
    with pytest.raises(MeshFormatError, match="x y z"):
        read_grid_dat(str(p), VAR, need_coords=True)


def test_truncated_mg_connectivity(tmp_path):
    p = tmp_path / "mg.dat"
    write_mg_connectivity(str(p), np.arange(10))
    toks = open(p).read().split()
    p.write_text(" ".join(toks[:6]))
    with pytest.raises(MeshFormatError):
        read_mg_connectivity(str(p))


def test_mg_bad_count(tmp_path):
    p = tmp_path / "mg.dat"
    p.write_text("notanumber\n1 2 3\n")
    with pytest.raises(MeshFormatError):
        read_mg_connectivity(str(p))


# --- the CLI --------------------------------------------------------------

@pytest.fixture(scope="module")
def tet_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tetfiles")
    pm = mesh_from_arrays(jax_hierarchy("tet", MeshVariant.M6_WING))
    return write_multigrid_mesh(str(d), pm), pm


@pytest.mark.parametrize("args", [
    [], ["--renumber"], ["-m", "2"], ["-m", "2", "--renumber"],
    ["--dtype", "bfloat16", "--accumulate", "window"]])
def test_cli_runs_input_files(tet_files, capsys, args):
    path, pm = tet_files
    assert cli_main(["-i", path, "-g", "2", "--platform", "cpu",
                     *args]) == 0
    out = capsys.readouterr().out
    m = 2 if "-m" in args else 1
    assert f"{m * pm.levels[0].num_nodes} nodes, 2 levels" in out
    assert out.count("MG cycle") == 2


def test_cli_input_directory(tet_files, capsys):
    path, _ = tet_files
    assert cli_main(["-i", os.path.basename(path), "-d",
                     os.path.dirname(path), "-g", "1", "--platform",
                     "cpu"]) == 0
    assert "MG cycle 1 / 1" in capsys.readouterr().out


def test_cli_without_input(capsys):
    assert cli_main(["-g", "1", "--platform", "cpu"]) == 1
    assert "ERROR: input_file not set" in capsys.readouterr().out


def test_cli_refuses_unported_flags(tet_files, tmp_path):
    """--partitions, refused before the sharded solver was ported, reads
    the input files in every rank it starts: its dump equals the single
    device's within identify_differences."""
    from mgcfd_tpu_torch.validate import identify_differences
    path, pm = tet_files
    argv = ["-i", path, "--platform", "cpu", "-g", "1", "--dtype",
            "float64", "--output-variables"]
    assert cli_main(argv + ["--partitions", "2", "-o",
                            f"{tmp_path}/p2/"]) == 0
    assert cli_main(argv + ["-o", f"{tmp_path}/p1/"]) == 0
    name = "variables.size=1x.cycles=1.level=0"
    assert identify_differences(np.loadtxt(tmp_path / "p2" / name),
                                np.loadtxt(tmp_path / "p1" / name),
                                pm.variant, raise_on_fail=False) == 0
