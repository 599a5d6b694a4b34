"""The initial state a run hands to the port and to the reference, made
from --seed: the free stream on every node of every level, its density,
x-momentum and energy each scaled by 1 + amplitude * u, and small
transverse momenta transverse * |m_x| * u (u uniform in [-1, 1], drawn
per node and variable). The values are rounded through float32, so a
float32 run starts from exactly the state the reference starts from. The
seed changes the values only, never a size: every seed runs the same
work."""
from __future__ import annotations

import numpy as np

from .reference.euler import far_field


def initial_state(num_nodes: list, seed: int, spec: dict) -> dict:
    """{"variables": [(N, 5)], "residuals": [(N, 5)]} per level, float64
    numpy; spec: the configuration's "state" entry."""
    rng = np.random.default_rng(seed % (1 << 64))
    ff = far_field()[0]
    amp, trans = spec["amplitude"], spec["transverse"]
    variables = []
    for n in num_nodes:
        q = np.tile(ff, (n, 1))
        q[:, [0, 1, 4]] *= 1.0 + amp * rng.uniform(-1.0, 1.0, (n, 3))
        q[:, 2:4] = trans * ff[1] * rng.uniform(-1.0, 1.0, (n, 2))
        variables.append(q.astype(np.float32).astype(np.float64))
    return {"variables": variables,
            "residuals": [np.zeros((n, 5)) for n in num_nodes]}
