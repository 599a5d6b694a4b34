"""The readings that the limits in configs/<config>.json are set from:
on the card, at a cell's own size, in one process, the numbers check.py
compares for sound runs of the port on many seeds (the lower readings),
for the control (the port under the configuration's "control" settings:
its bfloat16 path, the precision below float32) and for each planted
fault (faults.py), on a few seeds each; where the configuration has the
port renumber its mesh (order.py), also for its snapshot compared in the
port's own order ("unmapped"), which must fail too. The benchmark's own
runs never run this.

    python3 -m cfdbench.control --workload m6rcm.graph [--seeds 12]
        [--control-seeds 3] [--fault-seeds 3] [--first-seed 1000]

One JSON line a reading: {"kind", "seed", "readings", "correct"}, then a
summary line with each number's largest sound reading and smallest
control and fault readings.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

from cfdbench import check
from cfdbench.faults import FAULTS, plant
from cfdbench.run import cell_spec, cycles_per_call, make_call, \
    mesh_files, port_mesh, reference_mesh, require_card, snapshot, \
    solver_config


def readings_for(spec, kind, seeds, card, mesh, order, ref, sizes):
    """Readings of `seeds` through one solver built for `kind` ("sound",
    "control", "unmapped" or a fault), on the mesh in the program's
    order."""
    from mgcfd_tpu_torch.solver import MGCFDSolver
    from cfdbench.state import initial_state

    config = spec["config"]
    override = config["control"] if kind == "control" else {}
    out = []
    with plant(kind) if kind in FAULTS else contextlib.nullcontext():
        solver = MGCFDSolver(mesh, solver_config(config, **override),
                             device=card.device)
        call = make_call(solver, spec["mix"])
        for seed in seeds:
            s0 = initial_state(sizes, seed, config["state"])
            solver.load_state(order.to_port(s0))
            solver.rms_history = []
            try:
                call()
                prog = snapshot(solver)
                if kind != "unmapped":
                    prog = order.to_file(prog)
            except FloatingPointError as e:
                print(f"{kind} seed {seed}: {e}", file=sys.stderr)
                out.append({"kind": kind, "seed": seed, "readings": None,
                            "correct": False})
                continue
            r = ref.run(s0, cycles_per_call(spec["mix"]))
            values = check.readings(s0, prog, r)
            ok, _ = check.judge(values, config["limits"])
            out.append({"kind": kind, "seed": seed, "readings": values,
                        "correct": ok})
            print(json.dumps(out[-1]), flush=True)
        del solver, call
    gc.collect()
    card.release()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=1000)
    args = p.parse_args(argv)
    spec = cell_spec(args.workload)
    card = require_card(spec["cell"]["chips"])

    from cfdbench.order import renumbered
    from cfdbench.reference import ReferenceSolver

    config = spec["config"]
    input_dat = mesh_files(config)
    mesh, order, _ = renumbered(config, port_mesh(config, input_dat),
                                input_dat)
    sizes = [lv.num_nodes for lv in mesh.levels]
    ref = ReferenceSolver(reference_mesh(config, input_dat), card.device)
    s = args.first_seed
    plan = [("sound", range(s, s + args.seeds))]
    s += args.seeds
    plan.append(("control", range(s, s + args.control_seeds)))
    s += args.control_seeds
    for f in FAULTS + (("unmapped",) if order.perms else ()):
        plan.append((f, range(s, s + args.fault_seeds)))
        s += args.fault_seeds
    rows = []
    for kind, seeds in plan:
        rows += readings_for(spec, kind, list(seeds), card, mesh, order,
                             ref, sizes)
    summary = {}
    for name in check.NAMES + check.OPTIONAL:
        vals = {}
        for row in rows:
            v = row["readings"][name] if row["readings"] else float("inf")
            vals.setdefault(row["kind"], []).append(v)
        summary[name] = {"sound_max": max(vals["sound"]),
                         **{f"{k}_min": min(v) for k, v in vals.items()
                            if k != "sound"}}
    print(json.dumps({"summary": summary, "limits": config["limits"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
