"""The port's sweep harness (bench/gen_job.py, bench/aggregate.py) against
mgcfd_tpu's: jobs from mgcfd_tpu's profiles whose command lines the
port's parser takes, the same job names as mgcfd_tpu's generator (its
points with partitions > 1 left out: the port refuses such a profile),
and aggregate over two tiny CPU jobs."""
import json
import os
import shlex
import subprocess
from pathlib import Path

import pytest

from mgcfd_tpu.bench import gen_job as jax_gen
from mgcfd_tpu_torch.bench import aggregate, gen_job
from mgcfd_tpu_torch.cli.main import build_parser, config_from_args

REPO = Path(__file__).resolve().parent.parent
PROFILES = sorted((REPO / "mgcfd_tpu" / "bench" / "profiles").glob("*.json"))


def jobs_of(jobs_dir):
    return sorted(p.name for p in Path(jobs_dir).iterdir() if p.is_dir())


def command_of(job_dir):
    """The CLI arguments of a job's run.sh (after `-m <module>`)."""
    line = next(l for l in (Path(job_dir) / "run.sh").read_text()
                .splitlines() if " -m mgcfd_tpu_torch.cli.main " in l)
    argv = shlex.split(line.split(" > run.log")[0])
    return argv[argv.index("-m") + 2:]


def single_device(profile: dict, jobs_dir) -> dict:
    """The profile's single-device points, top-level '_doc' dropped (a
    string there stops mgcfd_tpu's generator), written to jobs_dir."""
    p = {k: dict(v) for k, v in profile.items() if isinstance(v, dict)}
    p.setdefault("run", {})["partitions"] = [1]
    p.setdefault("setup", {})["jobs dir"] = str(jobs_dir)
    return p


@pytest.mark.parametrize("profile", PROFILES, ids=lambda p: p.stem)
def test_profiles_give_jax_job_names(profile, tmp_path, monkeypatch):
    """The port's generator on each of mgcfd_tpu's profiles: the same job
    names as mgcfd_tpu's for the single-device points; every job's
    command parses and validates in the port; no --dump-hlo or
    --compile-cache. A profile with partitions > 1 is refused, naming
    item 9."""
    monkeypatch.chdir(tmp_path)
    raw = json.loads(profile.read_text())
    if any(p != 1 for p in raw.get("run", {}).get("partitions", [1])):
        with pytest.raises(ValueError, match="item 9"):
            gen_job.generate_jobs(str(profile), str(REPO))
    sd = single_device(raw, tmp_path / "mine")
    ref = single_device(raw, tmp_path / "jax")
    for name, p in (("mine.json", sd), ("jax.json", ref)):
        (tmp_path / name).write_text(json.dumps(p))
    mine = gen_job.generate_jobs(str(tmp_path / "mine.json"), str(REPO))
    theirs = jax_gen.generate_jobs(str(tmp_path / "jax.json"), str(REPO))
    assert jobs_of(mine) and jobs_of(mine) == jobs_of(theirs)
    for job in jobs_of(mine):
        argv = command_of(Path(mine) / job)
        assert "--dump-hlo" not in argv and "--compile-cache" not in argv
        config_from_args(build_parser().parse_args(argv)).validate()
        events = (Path(mine) / job / "events.conf").read_text().split()
        assert {"CALLS", "MODEL_BYTES", "MODEL_OPERATIONS"} <= set(events)


@pytest.mark.parametrize("acc", ["segment", "window", "shift_t", "ell"])
def test_flag_sets_pruned_as_jax(acc):
    flags = gen_job.FLUX_FLAGS
    assert gen_job.flag_sets(flags, 0, acc) == jax_gen.flag_sets(flags, 0,
                                                                 acc)


def test_device_peaks():
    assert aggregate.device_peaks("NVIDIA H100 80GB HBM3") == (67e12,
                                                               3.35e12)
    assert aggregate.device_peaks("cpu") == (0.0, 0.0)
    assert aggregate.device_peaks("") == (0.0, 0.0)


def test_aggregate_two_cpu_jobs(tmp_path):
    """Two jobs on a 6^3 box at fp64 on the CPU, without and with
    FLUX_FISSION, run through their run.sh; aggregate collates both: the
    edge throughput of every function, GFLOP/s and GB/s from
    KernelCosts.csv, the update column only under fission (internal +
    boundary + wall edges a call), no peak share on the CPU."""
    profile = {"compile": {"dtypes": ["float64"], "accumulate": ["segment"],
                           "flux flags": ["FLUX_FISSION"]},
               "run": {"mg cycles": 1, "platform": "cpu",
                       "unit walltime": 1.0},
               "setup": {"jobs dir": str(tmp_path / "jobs"),
                         "synthetic": "6,6,6,2"}}
    (tmp_path / "p.json").write_text(json.dumps(profile))
    jobs = gen_job.generate_jobs(str(tmp_path / "p.json"), str(REPO))
    names = jobs_of(jobs)
    assert names == ["float64.segment.FLUX_FISSION.P1.r0",
                     "float64.segment.noflags.P1.r0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for name in names:
        r = subprocess.run(["bash", str(Path(jobs) / name / "run.sh")],
                           env=env, capture_output=True, text=True,
                           timeout=300)
        log = Path(jobs) / name / "run.log"
        assert r.returncode == 0, log.read_text()
    rows = aggregate.aggregate(aggregate.collate(jobs))
    out = aggregate.write_combined(str(tmp_path / "all.csv"), rows)
    assert os.path.getsize(out) > 0
    by = {(r["config"], r["kernel"], r["level"]): r for r in rows}
    fis, plain = "float64.segment.FLUX_FISSION.P1", \
        "float64.segment.noflags.P1"
    assert (plain, "update", 0) not in by
    edges = 5 * 6 * 6 * 3     # a 6^3 box's internal edges
    upd = by[(fis, "update", 0)]
    # level 0: one visit a cycle, 3 RK stages a visit
    assert by[(fis, "flux", 0)]["iterations"] == 3 * edges
    assert upd["iterations"] > 3 * edges
    for r in rows:
        assert r["iters/sec"] > 0 and r["GFLOPs/sec"] > 0
        assert r["GB/sec"] > 0 and r["pct peak HBM"] == 0.0
        assert r["Instruction set"] == "cpu" and r["CPU"] == "cpu"
    assert by[(fis, "flux", 0)]["Flux fission"] == "Y"
