"""The tet flagship: generate_unstructured_hierarchy(68, 64, 70, 4, seed=1)
(304,640 / 38,080 / 4,896 / 648 nodes, 2,278,779 internal edges on the
finest level), mgcfd_tpu's bench.py tet phase (bench.py:261-264), as the
reference's files.

    python -m mgcfd_tpu_torch.bench.tet_flagship --out DIR

generates the hierarchy in the generator's (shuffled) node order, writes
it into DIR (level<i>.dat, mg<i>.dat, input.dat), parses it back with
load_multigrid_mesh(use_cache=False), which takes the native parser
(native/; the Python reader where g++ is missing), then loads it once
more through the .meshcache/ sidecars, which that load fills so that a
later load takes well under a second, and prints one JSON line: the host
seconds of generation, writing, the parse (no sidecar written) and the
cache fill, which reader the parse went through ("reader": "native" when
every level's did), and the level sizes.
The RCM order is the reader's step, as the CLI's -i ... --renumber takes
it: renumber_hierarchy(load_multigrid_mesh(DIR/input.dat)) gives the node
order of bench.py's renumber_hierarchy(generated mesh). (Renumbering
before writing would not: the files list each edge from its lower node,
so an RCM order written and read back flips the orientation of the edges
it reversed, and the solver's flux is not exactly odd in it.)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..mesh.io_dat import load_multigrid_mesh, write_multigrid_mesh
from ..mesh.unstructured import generate_unstructured_hierarchy
from ..utils import spans

TET_FLAGSHIP_SPEC = (68, 64, 70, 4)
SEED = 1


def input_path(out: str) -> str:
    """input.dat under main()'s --out directory."""
    return os.path.join(out, "input.dat")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True,
                   help="directory to write the hierarchy into")
    args = p.parse_args(argv)
    nx, ny, nz, levels = TET_FLAGSHIP_SPEC
    t0 = time.perf_counter()
    mesh = generate_unstructured_hierarchy(nx, ny, nz, levels, seed=SEED,
                                           name="tet-flagship")
    t1 = time.perf_counter()
    path = write_multigrid_mesh(args.out, mesh)
    t2 = time.perf_counter()
    native = spans.counters().get("mesh.reads.native", 0)
    load_multigrid_mesh(path, use_cache=False)
    t3 = time.perf_counter()
    parsed_natively = spans.counters().get("mesh.reads.native", 0) - native
    load_multigrid_mesh(path)
    t4 = time.perf_counter()
    print(json.dumps({
        "generate_s": t1 - t0, "write_s": t2 - t1, "parse_s": t3 - t2,
        "cache_fill_s": t4 - t3,
        "reader": ("native" if parsed_natively == mesh.num_levels
                   else "python"),
        "nodes": [lv.num_nodes for lv in mesh.levels],
        "internal_edges": [lv.num_internal_edges for lv in mesh.levels]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
