"""A configuration's mesh as the reference's files, made once per checkout.

ensure(mesh_spec, directory) generates the hierarchy the spec names,
renumbers or shuffles it when asked, and writes it into `directory` (a
fixed path inside the checkout), with the spec beside it in mesh.json. A
later call with the same spec finds the files and writes nothing: every
run of a cell after the first reads the same bytes.

Three generators, each with its own keys:
  box   structured box levels of the (nx, ny, nz) nodes each level lists
        (inputs/box.py), degree 6;
  tet   unstructured tetrahedral median-dual levels over jittered grids of
        the (nx, ny, nz) points each level lists (inputs/tet.py), about 7
        internal edges a node;
  cell  one cell-centred tetrahedral level, Rodinia cfd's kind of mesh:
        each tetrahedron of a jittered grid of (nx, ny, nz) points cut
        into Kuhn tetrahedra is a node with its 4 faces (inputs/cell.py).
"""
from __future__ import annotations

import json
import os
import shutil

from .box import generate_box_hierarchy
from .cell import generate_cell_hierarchy
from .datfiles import write_hierarchy
from .rcm import renumber_hierarchy
from .shuffle import shuffle_hierarchy
from .tet import generate_tet_hierarchy

STAMP = "mesh.json"
# a configuration's "mesh" entry, by generator: every key is read, and no
# other
KEYS = {
    "box": {"generator", "levels", "h", "volume_jitter", "seed", "variant",
            "order"},
    "tet": {"generator", "levels", "h", "jitter", "wall_frac", "seed",
            "variant", "order"},
    "cell": {"generator", "levels", "h", "jitter", "seed", "variant",
             "order"},
}
# structured: the generator's own order ((i, j, k) for the box, shuffled
# by the seed for the tet, as an imported mesh arrives); rcm: renumbered;
# shuffled: every level's ids permuted from the seed (inputs/shuffle.py)
ORDERS = ("structured", "rcm", "shuffled")


def check_spec(spec: dict) -> None:
    """ValueError unless the entry names a known generator and order with
    exactly the keys that generate() reads for that generator, and lists
    one level where the generator makes one."""
    gen = spec.get("generator")
    if not isinstance(gen, str) or gen not in KEYS:
        raise ValueError(f"unknown generator {gen!r} (the generators are "
                         f"{sorted(KEYS)})")
    keys = KEYS[gen]
    if set(spec) != keys:
        raise ValueError(f"{gen} mesh keys {sorted(set(spec) ^ keys)} "
                         f"missing or not read (the keys are "
                         f"{sorted(keys)})")
    if spec["order"] not in ORDERS:
        raise ValueError(f"unknown order {spec['order']!r} ({ORDERS})")
    if gen == "cell" and len(spec["levels"]) != 1:
        raise ValueError(f"the cell generator makes one level, not "
                         f"{len(spec['levels'])}")


def generate(spec: dict):
    """The hierarchy of a configuration's "mesh" entry: the generator's
    levels at the sizes it lists, in the generator's order,
    RCM-renumbered as an unstructured mesh is before it is written, or
    shuffled from the spec's seed as an imported mesh arrives."""
    check_spec(spec)
    if spec["generator"] == "box":
        mesh = generate_box_hierarchy(
            spec["levels"], h=tuple(spec["h"]), variant=spec["variant"],
            volume_jitter=spec["volume_jitter"], seed=spec["seed"])
    elif spec["generator"] == "cell":
        mesh = generate_cell_hierarchy(
            spec["levels"][0], h=tuple(spec["h"]), jitter=spec["jitter"],
            seed=spec["seed"], variant=spec["variant"])
    else:
        mesh = generate_tet_hierarchy(
            spec["levels"], h=tuple(spec["h"]), jitter=spec["jitter"],
            wall_frac=spec["wall_frac"], seed=spec["seed"],
            variant=spec["variant"])
    if spec["order"] == "rcm":
        return renumber_hierarchy(mesh)
    if spec["order"] == "shuffled":
        return shuffle_hierarchy(mesh, spec["seed"])
    return mesh


def ensure(spec: dict, directory: str) -> str:
    """input.dat of the spec's files under `directory`, written unless a
    previous call left them there."""
    path = os.path.join(directory, "input.dat")
    stamp = os.path.join(directory, STAMP)
    if os.path.exists(stamp):
        with open(stamp) as f:
            if json.load(f) == spec:
                return path
    tmp = directory + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(directory, ignore_errors=True)
    write_hierarchy(tmp, generate(spec))
    with open(os.path.join(tmp, STAMP), "w") as f:
        json.dump(spec, f)
    os.replace(tmp, directory)
    return path
