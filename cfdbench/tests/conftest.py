"""Tiny configurations for the CPU tests: the box and RCM hierarchies at
a few hundred nodes, with the limits of the full-size configurations, a
tetrahedral one over the generator of configs/tetrcm.json; and
tiny_config("rcm.shuffled"), the box stored shuffled and renumbered by
the port on load; and tiny_config("fvcorr"), configs/fvcorr193k.json's one
cell-centred level at a few hundred cells."""
import copy
import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
TINY_LEVELS = [[10, 9, 11], [8, 7, 9], [6, 6, 7]]
TINY_TET_LEVELS = [[10, 9, 11], [7, 6, 8], [5, 5, 6]]
# the cell generator's one level: 6 x 5 x 6 x 5 = 900 tetrahedra
TINY_CELL_LEVELS = [[6, 7, 6]]


def tiny_config(kind: str) -> dict:
    cell = kind == "fvcorr"
    name = "fvcorr193k" if cell else f"m6{kind}"
    with open(os.path.join(PKG, "configs", f"{name}.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    cfg["name"] = f"tiny{kind}"
    cfg["mesh"]["levels"] = TINY_CELL_LEVELS if cell else TINY_LEVELS
    cfg["nodes"] = [6 * int(np.prod(np.subtract(d, 1))) if cell
                    else int(np.prod(d)) for d in cfg["mesh"]["levels"]]
    return cfg


def tet_spec(order: str = "rcm") -> dict:
    """A "mesh" entry of the tet generator at TINY_TET_LEVELS."""
    return {"generator": "tet", "levels": TINY_TET_LEVELS, "h": [0.1] * 3,
            "jitter": 0.35, "wall_frac": 0.2, "seed": 0,
            "variant": "m6wing", "order": order}


def tiny_tet_config() -> dict:
    """m6rcm's configuration over a tiny tet hierarchy in RCM order."""
    cfg = tiny_config("rcm")
    cfg["name"] = "tinytet"
    cfg["mesh"] = tet_spec()
    cfg["nodes"] = [int(np.prod(d)) for d in TINY_TET_LEVELS]
    return cfg


@pytest.fixture(params=["box", "rcm"])
def kind(request):
    return request.param
