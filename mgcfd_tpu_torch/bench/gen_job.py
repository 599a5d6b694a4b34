"""Benchmark job generation (mgcfd_tpu/bench/gen_job.py, same profile
schema): a JSON profile describes an iteration space; each point becomes
a job directory with a self-contained run.sh that calls
`python -m mgcfd_tpu_torch.cli.main`, and the batch gets submit_all.sh
and list_errored_jobs.sh. The reference's compile-time axes are runtime
axes of the one program:

  reference axis                      axis here
  compilers (gnu/intel/clang/cray) -> dtypes (float32/float64/bfloat16)
  ISA targets (SSE42/AVX2/...)     -> accumulate modes (the port's:
                                      segment/scatter/ell/shift/pallas/
                                      window, and shift_t = shift with
                                      the variable-major state)
  flux-flag powerset               -> the same flag names, runtime
                                      switches (FLUX_CRIPPLE still
                                      excludes the others)
  mesh multiplier raising          -> -m passthrough
  thread counts                    -> partition counts (ranks)

Profile schema (mgcfd_tpu/bench/profiles/annotated.json):
  {"compile": {"dtypes": [...], "accumulate": [...],
               "flux flags": [...], "min flag set size": 0},
   "run": {"partitions": [...], "num repeats": N, "mg cycles": N,
           "mesh multi": N, "unit walltime": secs, "platform": "...",
           "validate": bool, "events": [...]},
   "setup": {"jobs dir": "...", "input dat": "...", "data dirpath": "...",
             "synthetic": "NX,NY,NZ,L"}}
A partition count above 1 gives jobs of the sharded solver
(--partitions P, which starts its P ranks itself; "shard levels", default
[1], adds --shard-levels S and a .S<S> name suffix), as mgcfd_tpu's do.
Jobs get no --dump-hlo and no --compile-cache (the port compiles no XLA
program), and the profile's "compile cache" key is ignored.
"""
from __future__ import annotations

import itertools
import json
import os
import stat
import sys

# FLUX_REUSE_FLUX is structurally always on (the b-side value is the
# exact negation of the a-side everywhere), so it is not a sweep axis
FLUX_FLAGS = ["FLUX_CRIPPLE", "FLUX_PRECOMPUTE_EDGE_WEIGHTS",
              "FLUX_FISSION", "FLUX_REUSE_DIV", "FLUX_REUSE_FACTOR"]
# the cost file's events per job (monitor/events.py)
DEFAULT_EVENTS = ["CALLS", "MODEL_BYTES", "MODEL_OPERATIONS"]
EDGE_STREAM_MODES = ("segment", "scatter", "ell")

DEFAULTS = {
    "compile": {"dtypes": ["float32"], "accumulate": ["segment"],
                "flux flags": [], "min flag set size": 0},
    "run": {"partitions": [1], "num repeats": 1, "mg cycles": 10,
            "mesh multi": 1, "unit walltime": 60.0, "platform": "",
            "validate": False},
    "setup": {"jobs dir": "jobs", "input dat": "input.dat",
              "data dirpath": ".", "synthetic": ""},
}


def _merged(profile: dict) -> dict:
    cfg = {k: dict(v) for k, v in DEFAULTS.items()}
    for cat, vals in profile.items():
        if isinstance(vals, dict):
            cfg.setdefault(cat, {}).update(vals)
    return cfg


def flag_sets(flags: list[str], min_size: int,
              accumulate: str = "segment") -> list[tuple[str, ...]]:
    """Powerset of flux flags, pruned as mgcfd_tpu prunes it: FLUX_CRIPPLE
    excludes every other flux flag, and FLUX_FISSION goes only with the
    edge-stream modes (SolverConfig.validate refuses it elsewhere)."""
    out = []
    fission_ok = accumulate in EDGE_STREAM_MODES
    for r in range(min_size, len(flags) + 1):
        for combo in itertools.combinations(flags, r):
            if "FLUX_CRIPPLE" in combo and len(combo) > 1:
                continue
            if "FLUX_FISSION" in combo and not fission_ok:
                continue
            out.append(combo)
    return out


def estimate_walltime(unit: float, cycles: int, multi: int,
                      partitions: int = 1) -> int:
    """unit_walltime * cycles * multi / sqrt(partitions), floored at 60 s
    (mgcfd_tpu's heuristic)."""
    return max(60, int(unit * cycles * max(1, multi)
                       / max(1.0, partitions ** 0.5)))


def job_name(dtype: str, acc: str, flags: tuple[str, ...], parts: int,
             repeat: int, shard_levels: int = 1) -> str:
    """mgcfd_tpu's job name for the same point."""
    f = ".".join(sorted(flags)) if flags else "noflags"
    sl = f".S{shard_levels}" if shard_levels != 1 else ""
    return f"{dtype}.{acc}.{f}.P{parts}{sl}.r{repeat}"


def job_command(dtype: str, acc: str, flags, run: dict, setup: dict,
                parts: int = 1, shard_levels: int = 1) -> list[str]:
    """The CLI call of one job, run from its directory."""
    cli = [sys.executable, "-m", "mgcfd_tpu_torch.cli.main"]
    if setup.get("synthetic"):
        cli += ["--synthetic", setup["synthetic"]]
    else:
        cli += ["-i", setup["input dat"], "-d", setup["data dirpath"]]
    acc_flags = (["--accumulate", "shift", "--transposed"]
                 if acc == "shift_t" else ["--accumulate", acc])
    cli += ["-g", str(run["mg cycles"]), "-m", str(run["mesh multi"]),
            "-o", "./", "--dtype", dtype, *acc_flags,
            "--monitor", "instrumented", "-p", "events.conf"]
    if parts > 1:
        cli += ["--partitions", str(parts)]
        if shard_levels != 1:
            cli += ["--shard-levels", str(shard_levels)]
    if run.get("platform"):
        cli += ["--platform", run["platform"]]
    if run.get("validate"):
        cli += ["-v"]
    for fl in flags:
        cli += [f"--{fl.lower().replace('_', '-')}"]
    return cli


def generate_jobs(profile_path: str, repo_root: str | None = None) -> str:
    with open(profile_path) as f:
        profile = json.load(f)
    cfg = _merged(profile)
    comp, run, setup = cfg["compile"], cfg["run"], cfg["setup"]
    repo_root = repo_root or os.getcwd()
    jobs_dir = os.path.abspath(setup["jobs dir"])
    os.makedirs(jobs_dir, exist_ok=True)
    events = run.get("events", DEFAULT_EVENTS)

    job_dirs = []
    # the shard-levels axis means something only with parts > 1, so the
    # single-device jobs take it once (mgcfd_tpu's pruning)
    points = [(dtype, acc, parts, sl)
              for dtype, acc, parts in itertools.product(
                  comp["dtypes"], comp["accumulate"], run["partitions"])
              for sl in (run.get("shard levels", [1]) if parts > 1
                         else [1])]
    for dtype, acc, parts, sl in points:
        for flags in flag_sets(comp["flux flags"],
                               comp["min flag set size"], acc):
            for repeat in range(run["num repeats"]):
                name = job_name(dtype, acc, flags, parts, repeat, sl)
                jdir = os.path.join(jobs_dir, name)
                os.makedirs(jdir, exist_ok=True)
                cli = job_command(dtype, acc, flags, run, setup, parts, sl)
                wall = estimate_walltime(run["unit walltime"],
                                         run["mg cycles"],
                                         run["mesh multi"], parts)
                script = f"""#!/bin/bash
# generated by mgcfd_tpu_torch.bench.gen_job; walltime estimate: {wall}s
set -u
cd "$(dirname "$0")"
if [ -f Times.csv ]; then
  echo "Times.csv exists, job already complete; skipping."
  exit 0
fi
touch job-is-running.txt
export PYTHONPATH="{repo_root}${{PYTHONPATH:+:$PYTHONPATH}}"
{" ".join(cli)} > run.log 2>&1
rc=$?
rm -f job-is-running.txt
if [ $rc -eq 0 ]; then touch job-is-complete.txt; else touch job-errored.txt; fi
exit $rc
"""
                with open(os.path.join(jdir, "events.conf"), "w") as f:
                    f.write("# events recorded per solver function "
                            "(KernelCosts.csv rows)\n")
                    f.write("\n".join(events) + "\n")
                spath = os.path.join(jdir, "run.sh")
                with open(spath, "w") as f:
                    f.write(script)
                os.chmod(spath, os.stat(spath).st_mode | stat.S_IEXEC)
                job_dirs.append(jdir)

    submit = os.path.join(jobs_dir, "submit_all.sh")
    with open(submit, "w") as f:
        f.write("#!/bin/bash\nset -u\n")
        for d in job_dirs:
            f.write(f'echo "=== {os.path.basename(d)}"\n"{d}/run.sh"\n')
    os.chmod(submit, os.stat(submit).st_mode | stat.S_IEXEC)

    errored = os.path.join(jobs_dir, "list_errored_jobs.sh")
    with open(errored, "w") as f:
        f.write("#!/bin/bash\n"
                f'find "{jobs_dir}" -name job-errored.txt | sort\n')
    os.chmod(errored, os.stat(errored).st_mode | stat.S_IEXEC)
    return jobs_dir


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="generate benchmark job directories from a JSON "
                    "profile")
    p.add_argument("--json", required=True)
    args = p.parse_args(argv)
    jobs_dir = generate_jobs(args.json)
    print(f"jobs written to {jobs_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
