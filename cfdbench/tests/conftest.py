"""Tiny configurations for the CPU tests: the box and RCM hierarchies at
a few hundred nodes, with the limits of the full-size configurations."""
import copy
import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
TINY_LEVELS = [[10, 9, 11], [8, 7, 9], [6, 6, 7]]


def tiny_config(kind: str) -> dict:
    with open(os.path.join(PKG, "configs", f"m6{kind}.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    cfg["name"] = f"tiny{kind}"
    cfg["mesh"]["levels"] = TINY_LEVELS
    cfg["nodes"] = [int(np.prod(d)) for d in TINY_LEVELS]
    return cfg


@pytest.fixture(params=["box", "rcm"])
def kind(request):
    return request.param
