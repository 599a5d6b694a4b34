"""A hierarchy in a seeded shuffled node order, as an imported mesh
arrives from its generator: each level's node ids permuted by a
permutation of its own, drawn from the seed, with the edges, the boundary
and wall ends, and the multigrid map's rows and values relabelled to
match. Edges keep their order and their orientation; the .dat writer and
reader then list and orient them by the new ids, as an imported file
does."""
from __future__ import annotations

import numpy as np

from .level import Hierarchy
from .rcm import apply_node_order


def level_orders(num_nodes: list, seed: int) -> list:
    """order[new_id] = old_id for each level, level l's from the seed's
    l-th spawned stream."""
    return [np.random.default_rng(np.random.SeedSequence(
        seed, spawn_key=(lev,))).permutation(n)
        for lev, n in enumerate(num_nodes)]


def shuffle_hierarchy(mesh: Hierarchy, seed: int) -> Hierarchy:
    """Every level relabelled by level_orders; the input is not
    modified."""
    orders = level_orders([lv.num_nodes for lv in mesh.levels], seed)
    levels = [apply_node_order(lv, o) for lv, o in zip(mesh.levels, orders)]
    for fine, order in zip(levels, orders[1:]):
        if fine.mg_mapping is not None:
            inv = np.empty_like(order)
            inv[order] = np.arange(order.shape[0])
            fine.mg_mapping = inv[fine.mg_mapping]
    return Hierarchy(levels=levels, variant=mesh.variant,
                     problem_size=mesh.problem_size)
