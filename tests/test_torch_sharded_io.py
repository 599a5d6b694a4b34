"""The sharded solver's checkpoints, monitor and entry points against
mgcfd_tpu's: checkpoints that move between partition counts, a 2-D
decomposition and the single-device solvers of both packages; the
instrumented sharded solver's reports and measure_production; the CLI's
--partitions against mgcfd_tpu's CLI; gen_job's partition points; the
dry run."""
import json
import os

import numpy as np
import pytest
import torch

import sharded_ranks as ranks
from mgcfd_tpu.bench import gen_job as jax_gen
from mgcfd_tpu.cli.main import main as jax_main
from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.monitor import InstrumentedShardedSolver as JaxInstrumented
from mgcfd_tpu.monitor.opstats import measure_production as jax_measure
from mgcfd_tpu.parallel import ShardedSolver as JaxSharded
from mgcfd_tpu.solver import MGCFDSolver as JaxSolver
from mgcfd_tpu_torch.bench import gen_job
from mgcfd_tpu_torch.cli.main import main as cli_main
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.mesh import write_multigrid_mesh
from mgcfd_tpu_torch.parallel import dryrun
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.validate import identify_differences

torch.set_num_threads(1)
H = (0.1, 0.1, 0.1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def box():
    jm = jax_mg_box(12, 10, 10, 3, h=H, volume_jitter=0.2,
                    variant=JaxVariant.FVCORR)
    return jm, mesh_from_arrays(jm)


def levels_of(z, n):
    return [z[f"arr_{lev}"] for lev in range(n)]


def test_checkpoints_move_between_decompositions(box, tmp_path):
    """A P = 4 run with a 2-D decomposition writes ckpt-000002; a 1-D P = 2
    run, the port's single-device solver and mgcfd_tpu's resume from it
    to exactly its state, and after 2 more cycles agree with the
    uninterrupted run of 4."""
    jm, mesh = box
    ck = str(tmp_path / "ck")
    first = tmp_path / "first.npz"
    base = dict(dtype="float64", accumulate="segment")
    ranks.launch(ranks.solve, 4, mesh,
                 dict(base, num_partitions=4, partition_2d="2x2",
                      checkpoint_dir=ck, checkpoint_every=2), 2, str(first))
    assert sorted(os.listdir(ck)) == ["ckpt-000002.npz"]
    at2 = levels_of(ranks.load(first), 3)
    whole = MGCFDSolver(mesh, SolverConfig(**base), device="cpu")
    whole.run(4)

    res = tmp_path / "res.npz"
    ranks.launch(ranks.resume, 2, mesh,
                 dict(base, num_partitions=2, checkpoint_dir=ck,
                      resume=True), 2, str(res))
    got = ranks.load(res)
    assert int(got["cycles"]) == 4
    single = MGCFDSolver(mesh, SolverConfig(**base, checkpoint_dir=ck,
                                            resume=True), device="cpu")
    jax_single = JaxSolver(jm, JaxConfig(dtype="float64", checkpoint_dir=ck,
                                         resume=True))
    for lev in range(3):
        np.testing.assert_array_equal(got[f"start{lev}"], at2[lev])
        np.testing.assert_array_equal(single.variables(lev), at2[lev])
        np.testing.assert_array_equal(np.asarray(jax_single.variables(lev)),
                                      at2[lev])
    single.run(2)
    jax_single.run(2)
    for lev in range(3):
        want = whole.variables(lev)
        for v in (got[f"arr_{lev}"], single.variables(lev)):
            np.testing.assert_allclose(v, want, rtol=1e-10, atol=1e-14)
        assert identify_differences(np.asarray(jax_single.variables(lev)),
                                    want, mesh.variant,
                                    raise_on_fail=False) == 0


def test_resumes_from_jax_sharded_and_single_device(box, tmp_path):
    """mgcfd_tpu's ShardedSolver (P = 4) and the port's single-device
    solver write checkpoints; the port's sharded solver resumes from each
    to exactly that state."""
    jm, mesh = box
    ck_j, ck_s = str(tmp_path / "j"), str(tmp_path / "s")
    js = JaxSharded(jm, JaxConfig(dtype="float64", num_partitions=4,
                                  checkpoint_dir=ck_j, checkpoint_every=2))
    js.run(2)
    ss = MGCFDSolver(mesh, SolverConfig(dtype="float64", checkpoint_dir=ck_s,
                                        checkpoint_every=2), device="cpu")
    ss.run(2)
    for ck, want in ((ck_j, [np.asarray(js.variables(lev))
                             for lev in range(3)]),
                     (ck_s, [ss.variables(lev) for lev in range(3)])):
        out = tmp_path / "r.npz"
        ranks.launch(ranks.resume, 4, mesh,
                     dict(dtype="float64", accumulate="window",
                          num_partitions=4, shard_levels=2,
                          checkpoint_dir=ck, resume=True), 1, str(out))
        got = ranks.load(out)
        for lev in range(3):
            np.testing.assert_array_equal(got[f"start{lev}"], want[lev])


def test_instrumented_sharded_against_jax(tmp_path):
    """The instrumented sharded solver: the same (function, level) rows
    and iteration counts as mgcfd_tpu's InstrumentedShardedSolver, the
    same Times.csv and LoopNumIters.csv layout (Num threads = P), the
    state of the plain run; measure_production of the sharded solver
    charges at least mgcfd_tpu's functions."""
    jm = jax_mg_box(10, 8, 8, 2, h=H, volume_jitter=0.2,
                    variant=JaxVariant.FVCORR)
    mesh = mesh_from_arrays(jm)
    cfg = dict(dtype="float64", accumulate="window", num_partitions=2)
    ref = JaxInstrumented(jm, JaxConfig(monitor_mode="instrumented", **cfg))
    stats = ref.run(2)
    jdir, mdir = tmp_path / "jax", tmp_path / "mine"
    ref.write_reports(f"{jdir}/")
    out = tmp_path / "ins.npz"
    ranks.launch(ranks.instrumented, 2, mesh, cfg, 2, f"{mdir}/", str(out))
    got = ranks.load(out)
    assert sorted(str(k) for k in got["keys"]) == \
        sorted(f"{f}:{lev}" for f, lev in stats.times)
    for (f, lev), n in stats.iters.items():
        assert int(got[f"iters:{f}:{lev}"]) == n, (f, lev)
    for name in ("Times.csv", "LoopNumIters.csv"):
        mine = (mdir / name).read_text().splitlines()
        theirs = (jdir / name).read_text().splitlines()
        assert mine[0] == theirs[0], name
        # Num threads, then (LoopNumIters.csv) every kernel cell
        assert mine[1].split(",")[12] == theirs[1].split(",")[12] == "2"
    assert mine[1].split(",")[16:] == theirs[1].split(",")[16:]
    plain = MGCFDSolver(mesh, SolverConfig(dtype="float64",
                                           accumulate="window"),
                        device="cpu")
    plain.run(2)
    for lev in range(2):
        np.testing.assert_allclose(got[f"arr_{lev}"], plain.variables(lev),
                                   rtol=1e-10, atol=1e-14)
    js = JaxSharded(jm, JaxConfig(dtype="float64", num_partitions=2))
    js.run(1)
    jax_keys = {f"{k}:{lev}" for k, lev in jax_measure(js, cycles=1)}
    # the replicated level's RK stages are fused_stage launches charged to
    # flux, the single device's fused window stage; mgcfd_tpu's XLA
    # cycle keeps a time_step op there
    assert jax_keys - {"time_step:1"} <= {str(k) for k in got["measured"]}
    assert {"flux:0", "compute_step:0", "restrict:0", "prolong:0",
            "time_step:0"} <= jax_keys


def test_cli_partitions_against_jax(tmp_path):
    """--partitions 2 (the CLI starts its 2 gloo ranks) and mgcfd_tpu's
    --partitions 2: the same dumps within identify_differences."""
    jm = jax_tet(8, 8, 8, 2, seed=1, h=0.1, variant=JaxVariant.FVCORR)
    write_multigrid_mesh(str(tmp_path / "tet"), mesh_from_arrays(jm))
    dumps = ["--output-variables", "--output-step-factors",
             "--output-volumes"]
    argv = ["-i", str(tmp_path / "tet" / "input.dat"), "-g", "2",
            "--dtype", "float64", "--partitions", "2", "--platform", "cpu",
            *dumps]
    assert cli_main(argv + ["-o", f"{tmp_path}/mine/"]) == 0
    assert jax_main(argv + ["-o", f"{tmp_path}/jax/"]) == 0
    for name in ("variables", "step_factors", "volumes"):
        f = f"{name}.size=1x.cycles=2.level=0"
        got = np.loadtxt(tmp_path / "mine" / f)
        want = np.loadtxt(tmp_path / "jax" / f)
        assert identify_differences(got, want, jm.variant,
                                    raise_on_fail=False) == 0, name


def test_gen_job_partition_points(tmp_path, monkeypatch):
    """A profile with partitions [1, 2] and shard levels [1, 2]: mgcfd_tpu's
    job names, and each partitioned job's command carries --partitions
    and --shard-levels and parses in the port."""
    profile = {"compile": {"dtypes": ["float64"],
                           "accumulate": ["segment", "window"]},
               "run": {"partitions": [1, 2], "shard levels": [1, 2],
                       "platform": "cpu"},
               "setup": {"synthetic": "6,6,6,2"}}
    monkeypatch.chdir(tmp_path)
    names = []
    for gen, sub in ((gen_job, "mine"), (jax_gen, "jax")):
        p = dict(profile, setup=dict(profile["setup"],
                                     **{"jobs dir": str(tmp_path / sub)}))
        (tmp_path / f"{sub}.json").write_text(json.dumps(p))
        d = gen.generate_jobs(str(tmp_path / f"{sub}.json"), REPO)
        names.append(sorted(n for n in os.listdir(d)
                            if os.path.isdir(os.path.join(d, n))))
    assert names[0] == names[1]
    assert "float64.window.noflags.P2.S2.r0" in names[0]
    script = (tmp_path / "mine" / "float64.window.noflags.P2.S2.r0"
              / "run.sh").read_text()
    cmd = next(line for line in script.splitlines()
               if "mgcfd_tpu_torch.cli.main" in line)
    assert "--partitions 2 --shard-levels 2" in cmd
    from mgcfd_tpu_torch.cli.main import build_parser, config_from_args
    args = cmd.split(" > ")[0].split()[3:]
    cfg = config_from_args(build_parser().parse_args(args))
    cfg.validate()
    assert (cfg.num_partitions, cfg.shard_levels) == (2, 2)


def test_cli_under_torchrun_needs_its_world_size(monkeypatch, capsys):
    """Under torchrun (WORLD_SIZE set) the CLI joins torchrun's group, which
    must have --partitions ranks."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit):
        cli_main(["--synthetic", "4,4,4,2", "--platform", "cpu",
                  "--partitions", "2"])
    assert "WORLD_SIZE=3" in capsys.readouterr().err


def test_dryrun(capfd):
    dryrun(2)
    assert "dryrun(2): ok" in capfd.readouterr().out


def test_stop_servers_leaves_no_process():
    """run_ranks' forkserver and resource tracker outlive it; stop_servers
    ends both and waits for them, and the next launch starts them anew."""
    from multiprocessing import forkserver, resource_tracker
    from mgcfd_tpu_torch.parallel.launch import stop_servers

    def servers():
        return (forkserver._forkserver._forkserver_pid,
                resource_tracker._resource_tracker._pid)

    for _ in range(2):
        ranks.launch(ranks.joined, 2)
        pids = servers()
        assert None not in pids
        for pid in pids:
            os.kill(pid, 0)     # alive
        stop_servers()
        assert servers() == (None, None)
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    stop_servers()              # nothing started: nothing to do


def test_gloo_on_a_card_only_when_asked(tmp_path):
    """A gloo group whose ranks sit on a card is the shared-card check, and
    only a group made with share_card=True may be one: Comm refuses a card
    under any other gloo group, and share_card refuses a CPU device."""
    import torch.distributed as dist
    from mgcfd_tpu_torch.parallel import comm
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="share_card is for ranks on a card"):
        comm.init_process_group(0, 1, f"file://{tmp_path}/store0", cpu,
                                share_card=True)
    comm.init_process_group(0, 1, f"file://{tmp_path}/store1", cpu)
    try:
        assert not comm.Comm(cpu).via_host
        with pytest.raises(ValueError, match="share_card=True"):
            comm.Comm(torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
    # a group made by hand, not through init_process_group
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store2",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="share_card=True"):
            comm.Comm(torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
