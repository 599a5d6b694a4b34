"""A configuration's levels as the port's stage operands, in one .npz: for
each level asked, the flux CSR plan (the port's build_flux_csr), the
dense (11, N) boundary/wall operand and the volumes, for a kernel study
that times one level visit's launches at the configuration's shapes
(mgcfd_tpu_torch/bench/kernel_ab.py --levels). The benchmark's own runs
never run this.

    python3 -m cfdbench.level_npz --config m6rcm8 --levels 0,1,2,3
        --out build/kernel_ab/m6rcm8.npz

The mesh is generated as configs/<config>.json's "mesh" and "load" say
(generator, order, duplication), in this process, and the file written
whole or not at all. Keys: "levels", and per level L "<L>f_<field>" of
the plan (num_rows, num_cols, row_ptr, owner, col, w), "<L>_nc" and
"<L>_volumes".
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from cfdbench.inputs.duplicate import duplicate_hierarchy
from cfdbench.inputs.make import generate

CONFIGS = Path(__file__).resolve().parent / "configs"
PLAN_KEYS = ("num_rows", "num_cols", "row_ptr", "owner", "col", "w")


def level_arrays(config: dict, levels) -> dict:
    """The .npz's arrays of the configuration's levels `levels`."""
    from mgcfd_tpu_torch.core.constants import far_field_state
    from mgcfd_tpu_torch.ops.tops import build_dense_boundary_wall
    from mgcfd_tpu_torch.prep.csr import build_flux_csr
    mesh = duplicate_hierarchy(generate(config["mesh"]),
                               config["load"]["duplicate"])
    arrays = {"levels": np.asarray(levels, np.int64)}
    for lev in levels:
        lv = mesh.levels[lev]
        plan = build_flux_csr(lv)
        arrays.update({f"{lev}f_{k}": np.asarray(getattr(plan, k))
                       for k in PLAN_KEYS})
        arrays[f"{lev}_nc"] = np.concatenate(build_dense_boundary_wall(
            lv.num_nodes, lv.bedge_b, lv.bedge_w, lv.wedge_b, lv.wedge_w,
            far_field_state(np.float64)[1]))
        arrays[f"{lev}_volumes"] = np.asarray(lv.volumes, np.float64)
    return arrays


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True,
                   help="a configuration's name, configs/<name>.json")
    p.add_argument("--levels", default="0,1,2,3",
                   help="comma-separated level indices")
    p.add_argument("--out", type=Path, required=True)
    args = p.parse_args(argv)
    config = json.loads((CONFIGS / f"{args.config}.json").read_text())
    levels = [int(v) for v in args.levels.split(",")]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    tmp = args.out.with_suffix(".tmp.npz")
    np.savez(tmp, **level_arrays(config, levels))
    tmp.replace(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
