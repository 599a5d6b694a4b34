"""The port's own node order, for a configuration whose load renumbers
("load": {"renumber": true}): the program orders the mesh it loaded with
its own renumber layer, as its CLI's --renumber does, and the harness
recovers, level by level, which node of the files each of the program's
nodes is, from the node coordinates that both readers parse from the same
.coords text. The map comes from the coordinates alone: neither the
port's renumber code nor inputs/rcm.py gives it, so the check holds the
port to the reference whatever order the port chooses.

The initial state is drawn in file order and handed to the port in its
order (Order.to_port); the checked snapshot comes back in file order
(Order.to_file), where the float64 reference, run on the mesh as read,
meets it. Without the key both are the identity and the mesh is the one
loaded.
"""
from __future__ import annotations

import time

import numpy as np


def node_map(file_coords: np.ndarray,
             port_coords: np.ndarray) -> np.ndarray:
    """perm with port_coords == file_coords[perm]: the program's node i is
    the files' node perm[i]. ValueError unless the two hold the same
    points, each once."""
    if file_coords is None or port_coords is None or \
            file_coords.shape != port_coords.shape:
        raise ValueError("node coordinates missing or of different shapes: "
                         "no map between the files' order and the port's")
    fo = np.lexsort(file_coords.T[::-1])
    po = np.lexsort(port_coords.T[::-1])
    fs = file_coords[fo]
    if (fs[1:] == fs[:-1]).all(axis=1).any():
        raise ValueError("repeated node coordinates: the map between the "
                         "files' order and the port's is not one-to-one")
    if not np.array_equal(fs, port_coords[po]):
        raise ValueError("the port's node coordinates are not the files'")
    perm = np.empty(fo.shape[0], np.int64)
    perm[po] = fo
    return perm


class Order:
    """The program's node order against the files', one map a level (None:
    the same order)."""

    def __init__(self, perms=None):
        self.perms = perms

    def to_port(self, state: dict) -> dict:
        """A node-major state in file order, in the program's."""
        if self.perms is None:
            return state
        return {k: [a[p] for a, p in zip(v, self.perms)]
                for k, v in state.items()}

    def to_file(self, snap: dict) -> dict:
        """run.snapshot's output in the program's order, in file order."""
        if self.perms is None:
            return snap
        out = dict(snap)
        for k in ("variables", "residuals"):
            out[k] = []
            for a, p in zip(snap[k], self.perms):
                b = np.empty_like(a)
                b[p] = a
                out[k].append(b)
        return out


def renumbered(config: dict, mesh, input_dat: str) -> tuple:
    """(the mesh the program runs, its Order, {span: host seconds}): the
    loaded mesh and the identity where the configuration does not
    renumber; else the port's renumber_hierarchy of it, timed as
    renumber_s, and the map from the coordinates, timed as node_map_s."""
    if not config["load"].get("renumber"):
        return mesh, Order(), {}
    from mgcfd_tpu_torch.prep.renumber import renumber_hierarchy
    from cfdbench.inputs.datfiles import read_coords

    t0 = time.perf_counter()
    mesh = renumber_hierarchy(mesh)
    t1 = time.perf_counter()
    perms = [node_map(f, lv.coords)
             for f, lv in zip(read_coords(input_dat), mesh.levels)]
    t2 = time.perf_counter()
    return mesh, Order(perms), {"renumber_s": t1 - t0,
                                "node_map_s": t2 - t1}
