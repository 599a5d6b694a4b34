"""A configuration's mesh as the reference's files, made once per checkout.

ensure(mesh_spec, directory) generates the hierarchy the spec names,
renumbers it when asked, and writes it into `directory` (a fixed path
inside the checkout), with the spec beside it in mesh.json. A later call
with the same spec finds the files and writes nothing: every run of a
cell after the first reads the same bytes.
"""
from __future__ import annotations

import json
import os
import shutil

from .box import generate_box_hierarchy
from .datfiles import write_hierarchy
from .rcm import renumber_hierarchy

STAMP = "mesh.json"
# a configuration's "mesh" entry: every key is read, and no other
KEYS = {"generator", "levels", "h", "volume_jitter", "seed", "variant",
        "order"}
ORDERS = ("structured", "rcm")


def check_spec(spec: dict) -> None:
    """ValueError unless the entry names a known generator and order with
    exactly the keys that generate() reads."""
    if set(spec) != KEYS:
        raise ValueError(f"mesh keys {sorted(set(spec) ^ KEYS)} missing "
                         f"or not read (the keys are {sorted(KEYS)})")
    if spec["generator"] != "box" or spec["order"] not in ORDERS:
        raise ValueError(f"unknown generator {spec['generator']!r} or "
                         f"order {spec['order']!r} (box; {ORDERS})")


def generate(spec: dict):
    """The hierarchy of a configuration's "mesh" entry: the box's levels
    at the sizes it lists, in the (i, j, k) order or RCM-renumbered as
    an unstructured mesh is before it is written."""
    check_spec(spec)
    mesh = generate_box_hierarchy(
        spec["levels"], h=tuple(spec["h"]), variant=spec["variant"],
        volume_jitter=spec["volume_jitter"], seed=spec["seed"])
    return renumber_hierarchy(mesh) if spec["order"] == "rcm" else mesh


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
