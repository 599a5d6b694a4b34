"""The port's full single-device CLI (cli/main.py) against mgcfd_tpu's:
every flag of the JAX CLI is taken or refused with its reason, the config
file sets the same fields, -v exits 0 and 1 as the reference does, and
both CLIs' dumps of one fp64 run agree within identify_differences
(relative 1e-8, absolute floor 1e-15: FVCORR).

ADVICE.md (c): mgcfd_tpu's --measure-ops advances the state by the
measured cycle before -v and the dumps; the port's restores it, so its
dumps after -g N --measure-ops are those of N cycles. The tests hold the
port's behaviour (test_measure_ops_leaves_the_dumps_alone)."""
import os
import shutil

import numpy as np
import pytest
import torch

from mgcfd_tpu.cli.main import build_parser as jax_parser
from mgcfd_tpu.cli.main import main as jax_main
from mgcfd_tpu.cli.main import read_config_file as jax_read_config
from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu_torch.cli.main import build_parser, config_from_args
from mgcfd_tpu_torch.cli.main import main as cli_main
from mgcfd_tpu_torch.cli.main import read_config_file
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.mesh import write_multigrid_mesh
from mgcfd_tpu_torch.validate import identify_differences, read_solution

torch.set_num_threads(1)
VARIANT = MeshVariant.FVCORR
DUMPS = ["--output-variables", "--output-step-factors", "--output-volumes",
         "--output-fluxes", "--output-edge-fluxes"]
SUFFIX = "size=1x.cycles=2.level=0"
DUMP_FILES = ["variables", "step_factors", "volumes", "fluxes", "edge_p",
              "edge_mx", "edge_my", "edge_mz", "edge_pe"]

# mgcfd_tpu's flags the port refuses, and the words that say why
REFUSED = {"--partitions": "item 9", "--partition-2d": "item 9",
           "--shard-levels": "item 9",
           "--compile-cache": "no counterpart",
           "--dump-hlo": "no counterpart"}
# a value for each flag that takes one
VALUES = {"-i": "input.dat", "-c": None, "-d": ".", "-o": "out/",
          "-m": "1", "-g": "1", "-p": "events.conf", "--dtype": "float64",
          "--shard-levels": "2", "--partitions": "2",
          "--partition-2d": "2x2", "--monitor": "instrumented",
          "--synthetic": "4,4,4,2", "--accumulate": "segment",
          "--checkpoint-dir": "ck", "--checkpoint-every": "1",
          "--platform": "cpu", "--profile-dir": "prof",
          "--plan-cache": "plans", "--compile-cache": "cc",
          "--dump-hlo": "hlo"}


def jax_flags():
    """(first option string, takes a value) of each of mgcfd_tpu's
    add_argument calls."""
    return [(a.option_strings[0], a.nargs != 0)
            for a in jax_parser()._actions if a.dest != "help"]


@pytest.fixture(scope="module")
def tet_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tet")
    jm = jax_tet(8, 8, 8, 2, seed=1, h=0.1, variant=JaxVariant.FVCORR)
    write_multigrid_mesh(str(d), mesh_from_arrays(jm))
    return d


def test_the_parsers_have_the_same_flags():
    mine = {a.option_strings[0]: a.nargs != 0
            for a in build_parser()._actions if a.dest != "help"}
    assert len(jax_flags()) == 37
    assert mine == dict(jax_flags())


@pytest.mark.parametrize("flag,takes", jax_flags())
def test_every_jax_flag_taken_or_refused(flag, takes, tmp_path, capsys):
    """Each flag of mgcfd_tpu's CLI sets the port's configuration without
    error, or the CLI exits naming item 9 or saying that the flag has no
    counterpart."""
    conf = tmp_path / "run.conf"
    conf.write_text("cycles = 1\n")
    value = str(conf) if flag == "-c" else VALUES.get(flag)
    argv = ["--synthetic", "4,4,4,2", "--platform", "cpu", flag] + (
        [value] if takes else [])
    if flag in REFUSED:
        with pytest.raises(SystemExit):
            cli_main(argv)
        assert REFUSED[flag] in capsys.readouterr().err
        return
    cfg = config_from_args(build_parser().parse_args(argv))
    cfg.validate()


def test_config_file_sets_the_same_fields(tmp_path):
    conf = tmp_path / "sub" / "run.conf"
    conf.parent.mkdir()
    conf.write_text(
        "# every key of the reference and of mgcfd_tpu\n"
        "input_file = input.dat\ninput_file_directory = ../data\n"
        "output_file_prefix = out/\nmesh_duplicate_count = 2\n"
        "cycles = 7\noutput_variables = Y\noutput_step_factors = Y\n"
        "output_fluxes = N\noutput_volumes = Y\noutput_edge_fluxes = Y\n"
        "dtype = float64\npartitions = 4\nshard_levels = 2\n"
        "partition_2d = 2x2\npapi_config_file = papi.conf\n"
        "compile_cache = cc\nomp_num_threads = 8\n"
        "output_old_variables = Y\nunknown_key = 1\n")
    mine, ref = SolverConfig(), JaxConfig()
    read_config_file(str(conf), mine)
    jax_read_config(str(conf), ref)
    for f in ref.__dataclass_fields__:
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.input_file_directory == str(tmp_path / "sub/../data")
    for key in ("partitions", "shard_levels", "partition_2d"):
        c = tmp_path / f"{key}.conf"
        c.write_text(f"{key} = {'2x2' if key == 'partition_2d' else 2}\n")
        with pytest.raises(SystemExit):
            cli_main(["-c", str(c), "--synthetic", "4,4,4,2",
                      "--platform", "cpu"])


def run_dumps(main, tet_dir, out, extra=()):
    argv = ["-i", str(tet_dir / "input.dat"), "-g", "2", "--dtype",
            "float64", "-o", f"{out}/", *DUMPS, *extra]
    assert main(argv) == 0
    return {name: np.loadtxt(f"{out}/{name}.{SUFFIX}")
            for name in DUMP_FILES}


def test_dumps_agree_with_jax(tet_dir, tmp_path):
    """Every dump of one fp64 run of 2 cycles through both CLIs: the same
    file names, values within identify_differences (the fluxes file is
    the zero array in both)."""
    ref = run_dumps(jax_main, tet_dir, tmp_path / "jax",
                    ["--platform", "cpu"])
    got = run_dumps(cli_main, tet_dir, tmp_path / "port",
                    ["--platform", "cpu"])
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "port"))
    assert not got["fluxes"].any() and not ref["fluxes"].any()
    for name in DUMP_FILES:
        identify_differences(got[name], ref[name], VARIANT)


def test_validate_exit_codes(tet_dir, tmp_path, capsys):
    """-v against a solution file the port dumped at fp64: PASS and exit
    0; one value moved by 1e-6 of itself: the reference's message and
    exit 1; no solution file: the reference's notice and exit 0."""
    d = tmp_path / "files"
    shutil.copytree(tet_dir, d)
    conf = d / "run.conf"
    conf.write_text("input_file = input.dat\ninput_file_directory = ./\n"
                    "cycles = 2\ndtype = float64\n")
    base = ["-c", str(conf), "--platform", "cpu"]
    assert cli_main(base + ["-v"]) == 0
    assert "could not open variables solution file" in \
        capsys.readouterr().out
    assert cli_main(base + ["--output-variables", "-o",
                            str(tmp_path / "out") + "/"]) == 0
    sol = d / f"solution.variables.{SUFFIX}"
    shutil.copy(tmp_path / "out" / f"variables.{SUFFIX}", sol)
    capsys.readouterr()
    assert cli_main(base + ["-v"]) == 0
    assert "PASS: variables[] validated successfully" in \
        capsys.readouterr().out
    v = read_solution(str(sol), 512)
    v[7, 4] *= 1 + 1e-6
    np.savetxt(sol, v, fmt="%.17e")
    assert cli_main(base + ["-v"]) == 1
    assert "Validation of variables[] failed" in capsys.readouterr().out


def test_measure_ops_leaves_the_dumps_alone(tet_dir, tmp_path):
    """The port's --measure-ops restores the state after its cycle, so
    the dumps are those of -g 2 without it (ADVICE.md (c): mgcfd_tpu's
    are a cycle further on)."""
    a = run_dumps(cli_main, tet_dir, tmp_path / "a", ["--platform", "cpu"])
    b = run_dumps(cli_main, tet_dir, tmp_path / "b",
                  ["--platform", "cpu", "--measure-ops"])
    for name in DUMP_FILES:
        np.testing.assert_array_equal(a[name], b[name])


def test_resume_runs_the_remaining_cycles(tet_dir, tmp_path, capsys):
    """-g 1 with a checkpoint a cycle, then -g 2 --resume: "Resumed at
    cycle 1; running 1 more", and the dump equals that of a straight
    -g 2 run bit for bit."""
    ck = str(tmp_path / "ck")
    common = ["-i", str(tet_dir / "input.dat"), "--dtype", "float64",
              "--platform", "cpu", "--checkpoint-dir", ck]
    assert cli_main(common + ["-g", "1", "--checkpoint-every", "1"]) == 0
    capsys.readouterr()
    assert cli_main(common + ["-g", "2", "--resume", "--output-variables",
                              "-o", str(tmp_path / "r") + "/"]) == 0
    assert "Resumed at cycle 1; running 1 more" in capsys.readouterr().out
    straight = run_dumps(cli_main, tet_dir, tmp_path / "s",
                         ["--platform", "cpu"])
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "r" / f"variables.{SUFFIX}"),
        straight["variables"])


@pytest.mark.parametrize("extra", [
    ["--flux-cripple", "--accumulate", "window"],
    ["--flux-fission", "--accumulate", "ell"],
    ["--flux-precompute-edge-weights", "--accumulate", "scatter",
     "--plan-cache", "PLANS"]])
def test_variant_flags_dump_the_same_state(tet_dir, tmp_path, extra):
    """The kernel-variant flags through the CLI: the dumped variables
    equal the default run's within identify_differences."""
    extra = [str(tmp_path / "plans") if x == "PLANS" else x for x in extra]
    a = run_dumps(cli_main, tet_dir, tmp_path / "a", ["--platform", "cpu"])
    b = run_dumps(cli_main, tet_dir, tmp_path / "b",
                  ["--platform", "cpu", *extra])
    identify_differences(b["variables"], a["variables"], VARIANT)
