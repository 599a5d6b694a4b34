"""Bytes and operations of the two solver functions whose rooflines the
benchmark reports, counted from the mesh, as the reference app's
functions define their data: each input read once, each output written
once. Nothing here depends on how the port lays out or walks the edges,
so the yardstick reads the same work whatever implements it.

  flux         compute_flux_edge with the boundary and wall faces: the
               variables (N x 5), the internal edge list (2 ids an edge)
               and weights (3 an edge), each face's node id and weights
               in; the fluxes (N x 5) out.
  indirect_rw  the same walk's data-movement twin: the variables, the
               internal edge list and weights in; its accumulator out.

Node ids are the app's 4-byte ints; values take the run's dtype. One
operation is an add, multiply, divide or square root: an internal edge
takes two node completions (17 each: 1/rho, velocity 3, |v|^2 5,
pressure 4, sound speed 3, |v| 1), 63 for the edge's flux from them and
10 to add it into both ends; a far-field face 18 (the pressure, its
three products, three adds); a wall face 133 (the completion, the flux
tensor, the far-field sum, the contraction with the normal and the
adds); the rw twin 13 an edge. Each level visit runs RK = 3 calls of
each; a V-cycle visits level 0 and the coarsest level once and every
other level twice.

At the M6 configurations' level 0 (304,640 nodes, 900,328 internal edges,
27,184 faces) in float32 one flux call is 6.09 MB of variables, 7.20 MB
of edge ids, 10.80 MB of weights, 0.43 MB of faces and 6.09 MB of
fluxes: 30.6 MB, inside the card's 50 MB L2; under -m 8, 245 MB.
"""
from __future__ import annotations

INDEX_BYTES = 4
RK = 3
FLUX_OPS_PER_EDGE = 2 * 17 + 63 + 10
BOUNDARY_OPS_PER_FACE = 18
WALL_OPS_PER_FACE = 133
RW_OPS_PER_EDGE = 13
DTYPE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}
FUNCTIONS = ("flux", "indirect_rw")


def level_sizes(mesh) -> list:
    """[{nodes, internal, boundary, wall}] per level of a hierarchy."""
    return [{"nodes": lv.num_nodes, "internal": int(lv.edge_a.shape[0]),
             "boundary": int(lv.bedge_b.shape[0]),
             "wall": int(lv.wedge_b.shape[0])} for lv in mesh.levels]


def visits(num_levels: int) -> list:
    """Visits of each level in one V-cycle."""
    return [1 if i in (0, num_levels - 1) else 2 for i in range(num_levels)]


def call(function: str, size: dict, dtype: str) -> tuple:
    """(bytes, operations) of one call of `function` on a level."""
    s = DTYPE_BYTES[dtype]
    n, ei = size["nodes"], size["internal"]
    faces = size["boundary"] + size["wall"]
    state = 2 * 5 * n * s                    # variables in, result out
    edges = ei * (2 * INDEX_BYTES + 3 * s)
    if function == "flux":
        return (state + edges + faces * (INDEX_BYTES + 3 * s),
                FLUX_OPS_PER_EDGE * ei
                + BOUNDARY_OPS_PER_FACE * size["boundary"]
                + WALL_OPS_PER_FACE * size["wall"])
    if function == "indirect_rw":
        return state + edges, RW_OPS_PER_EDGE * ei
    raise ValueError(f"no count for {function!r}")


def per_cycle(function: str, sizes: list, dtype: str) -> list:
    """[(calls, bytes, operations)] per level for one V-cycle."""
    v = visits(len(sizes))
    return [(RK * v[i], *call(function, size, dtype))
            for i, size in enumerate(sizes)]


def least_time(function: str, sizes: list, dtype: str,
               bytes_per_s: float, ops_per_s: float) -> dict:
    """The least time one V-cycle's calls of `function` could take: per
    call the larger of bytes / bandwidth and operations / peak rate.
    Returns {"seconds", "bound": "bytes" or "operations" (what bounds the
    most time), "bytes", "operations"} per cycle."""
    total = by_bytes = 0.0
    nbytes = nops = 0
    for calls, b, o in per_cycle(function, sizes, dtype):
        tb, to = b / bytes_per_s, o / ops_per_s
        total += calls * max(tb, to)
        by_bytes += calls * tb if tb >= to else 0.0
        nbytes += calls * b
        nops += calls * o
    return {"seconds": total,
            "bound": "bytes" if by_bytes >= total / 2 else "operations",
            "bytes": nbytes, "operations": nops}
