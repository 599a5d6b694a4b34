"""Bytes and operations of each kernel call and of each solver function:
the model behind the bounds of chip_smoke.py's kernel records and the
MODEL_BYTES / MODEL_OPERATIONS rows of the monitor's cost file
(monitor/events.py), kept in one place so that the two cannot drift.

Bytes: each input read once and each output written once (index arrays
at their stored width: the CSR's int32, the edge lists' int64).
Operations: each add, multiply, divide and square root is one, counted
from the kernel sources (csrc/) and, for what the eager ops compute, from
ops/. Each function returns (bytes, operations) of one call.
"""
from __future__ import annotations

from ..core.constants import RK

# a node's completion [rho, m, E, p, speed + sos, 1/rho] (complete8)
FLUX_OPS_PER_ROW = 17
# flux_math, one half-edge's flux from two completed nodes
FLUX_MATH_OPS = 63
# per CSR entry: the neighbour's completion and flux_math
FLUX_OPS_PER_ENTRY = FLUX_OPS_PER_ROW + FLUX_MATH_OPS
FUSED_EXTRA_OPS_PER_ROW = 60  # boundary/wall flux, update, validity
RW_OPS_PER_ENTRY = 25
WSUM_OPS_PER_ENTRY = 10
# the span kernels evaluate two edge values per node and span (one per
# endpoint), each a neighbour completion and flux_math, or in rw mode 12
# additions
SHIFT_FLUX_OPS_PER_SPAN_ROW = 2 * FLUX_OPS_PER_ENTRY
SHIFT_RW_OPS_PER_SPAN_ROW = 2 * 12
# the dense boundary/wall flux from a completed node (fused_stage.bw_flux)
BW_OPS_PER_ROW = 58
# the step factor: completion, dt, the min, the division by V
STEP_OPS_PER_NODE = 22
# the time step: sf / (RK + 1 - j), then old + factor * flux (one fewer
# where step_factor gives the stage's factor)
TIME_STEP_OPS_PER_NODE = 11
# the edge-stream paths: per internal edge both completions, flux_math and
# the two accumulations; per boundary or wall edge a completion, its flux
# and the accumulation; the rw twin's 3 additions and its accumulations
EDGE_FLUX_OPS = 2 * FLUX_OPS_PER_ROW + FLUX_MATH_OPS + 10
EDGE_BW_OPS = FLUX_OPS_PER_ROW + BW_OPS_PER_ROW + 5
EDGE_RW_OPS = 13
# the plain prolongation: four inverse distances and the weighted sums an
# edge; the normalisation and the update a node
PROLONG_OPS_PER_EDGE = 70
PROLONG_OPS_PER_NODE = 15
NC_ROWS = 11   # the aggregated boundary/wall normals and wall constant
_WEIGHT_ROWS = {"flux": 4, "rw": 3, "wsum": 1}


def csr_bytes(csr, wrows: int, sz: int) -> int:
    """Bytes of a CSR's row_ptr, col and `wrows` weight rows."""
    return 4 * (csr.num_rows + 1) + 4 * csr.num_entries \
        + sz * wrows * csr.num_entries


def edge_csr_cost(mode: str, csr, sz: int):
    """edge_csr in `mode` over `csr`: (5, cols) in, (5, rows) out."""
    e = csr.num_entries
    nbytes = csr_bytes(csr, _WEIGHT_ROWS[mode], sz) \
        + sz * 5 * (csr.num_cols + csr.num_rows)
    ops = {"flux": FLUX_OPS_PER_ENTRY * e + FLUX_OPS_PER_ROW * csr.num_rows,
           "rw": RW_OPS_PER_ENTRY * e, "wsum": WSUM_OPS_PER_ENTRY * e}[mode]
    return nbytes, ops


def fused_stage_cost(csr, sz: int):
    """fused_stage: q, old, fac and nc in; the new state out and the
    count added into an int64."""
    n = csr.num_rows
    return (csr_bytes(csr, 4, sz) + sz * n * (5 + 5 + 1 + NC_ROWS + 5) + 8,
            FLUX_OPS_PER_ENTRY * csr.num_entries
            + (FLUX_OPS_PER_ROW + FUSED_EXTRA_OPS_PER_ROW) * n)


def shift_cost(mode: str, sh, sz: int):
    """shift.flux or shift.rw over a plan of D spans: the state and the
    span weights (4 rows, or 3 in rw mode) in, (5, N) out."""
    n, d = sh.num_nodes, len(sh.deltas)
    if mode == "flux":
        return (sz * n * (5 + 4 * d + 5),
                (SHIFT_FLUX_OPS_PER_SPAN_ROW * d + FLUX_OPS_PER_ROW) * n)
    return sz * n * (5 + 3 * d + 5), SHIFT_RW_OPS_PER_SPAN_ROW * d * n


def shift_fused_stage_cost(sh, sz: int):
    n, d = sh.num_nodes, len(sh.deltas)
    return (sz * n * (5 + 4 * d + 5 + 1 + NC_ROWS + 5) + 8,
            (SHIFT_FLUX_OPS_PER_SPAN_ROW * d + FLUX_OPS_PER_ROW
             + FUSED_EXTRA_OPS_PER_ROW) * n)


def wsum_cost(csr, sz: int, keep: bool = False, correct: bool = False):
    """edge_csr in wsum mode with its epilogues: keep reads the kept
    state on the rows with no entries; correct reads the fine state and
    residual and takes two operations an element."""
    nbytes, ops = edge_csr_cost("wsum", csr, sz)
    if keep:
        empty = int((csr.row_ptr[1:] == csr.row_ptr[:-1]).sum())
        nbytes += sz * 5 * empty
    if correct:
        nbytes += sz * 10 * csr.num_rows
        ops += 10 * csr.num_rows
    return nbytes, ops


def step_factor_cost(n: int, sz: int, legacy: bool = False):
    """step_factor over n nodes: q and cbrt(V) in, then V in and the RK
    stage factors out (legacy: q and V in, the factors out); the
    STEP_OPS_PER_NODE of the step factor and a multiply a stage."""
    return (sz * n * (5 + (1 if legacy else 2) + RK),
            (STEP_OPS_PER_NODE + RK) * n)


def _edges_cost(lvl, mode: str, sz: int):
    """The edge-stream formulation ('segment', node-major 'shift'): the
    state and the edge lists in, (N, 5) out."""
    n, e = lvl.num_nodes, int(lvl.edge_a.shape[0])
    nbytes = sz * 10 * n + e * (16 + 3 * sz)
    if mode == "rw":
        return nbytes, EDGE_RW_OPS * e
    nb = int(lvl.bedge_b.shape[0]) + int(lvl.wedge_b.shape[0])
    return nbytes + nb * (8 + 3 * sz), EDGE_FLUX_OPS * e + EDGE_BW_OPS * nb


def _span_cost(lvl, mode: str, sz: int):
    """The span formulation ('pallas', transposed 'shift'): the spans and
    the spill edges, as a CSR ('pallas') or an edge list ('shift')."""
    nbytes, ops = shift_cost(mode, lvl.shift, sz)
    if lvl.spill_csr is not None:
        b, o = edge_csr_cost(mode, lvl.spill_csr, sz)
        # the state in and the sum out are the span kernel's already
        nbytes += b - sz * 10 * lvl.num_nodes
        ops += o
    elif lvl.spill is not None and lvl.spill[0].shape[0]:
        e = int(lvl.spill[0].shape[0])
        nbytes += e * (16 + 3 * sz)
        ops += (EDGE_FLUX_OPS if mode == "flux" else EDGE_RW_OPS) * e
    return nbytes, ops


def _fission_cost(lvl, function: str, sz: int):
    """flux_fission's two phases on the edge stream: 'flux' reads the
    state and the edge lists and writes every edge's values; 'update'
    reads the values and the destinations and writes (N, 5)."""
    n, e = lvl.num_nodes, int(lvl.edge_a.shape[0])
    nb = int(lvl.bedge_b.shape[0]) + int(lvl.wedge_b.shape[0])
    if function == "flux":
        return (sz * 5 * n + e * (16 + 3 * sz) + nb * (8 + 3 * sz)
                + sz * 5 * (e + nb),
                (EDGE_FLUX_OPS - 10) * e + (EDGE_BW_OPS - 5) * nb)
    return (sz * 5 * (e + nb) + 8 * (2 * e + nb) + sz * 5 * n,
            5 * (3 * e + nb))


def function_cost(function: str, levels, level: int, accumulate: str,
                  variable_major: bool, sz: int, fission: bool = False,
                  stage_factors: bool = False, legacy: bool = False):
    """One call of a solver function on `level` (a DeviceLevel of
    `levels`) of a path: compute_step, flux, update (fission only),
    time_step, indirect_rw, restrict (this level onto the next) or
    prolong (the next onto this). Flux includes the boundary and wall
    edges: on the variable-major paths their aggregated normals (11, N)
    and BW_OPS_PER_ROW a node; under fission it is the per-edge values
    alone and update their accumulation. With stage_factors (the
    variable-major visits of solver.py) compute_step is step_factor, the
    RK stages' factors (`legacy`: the variant's step factor), and the time
    step takes its factor as it is."""
    lvl = levels[level]
    n = lvl.num_nodes
    if fission and function in ("flux", "update"):
        return _fission_cost(lvl, function, sz)
    if function == "compute_step":
        if stage_factors:
            return step_factor_cost(n, sz, legacy)
        return sz * n * (5 + 1 + 1 + 1), STEP_OPS_PER_NODE * n
    if function == "time_step":
        return (sz * n * (1 + 5 + 5 + 5),
                (TIME_STEP_OPS_PER_NODE - stage_factors) * n)
    if function in ("flux", "indirect_rw"):
        mode = "flux" if function == "flux" else "rw"
        if not variable_major:
            return _edges_cost(lvl, mode, sz)
        if accumulate == "window":
            nbytes, ops = edge_csr_cost(mode, lvl.csr, sz)
        else:
            nbytes, ops = _span_cost(lvl, mode, sz)
        if mode == "flux":
            nbytes += sz * NC_ROWS * n
            ops += (BW_OPS_PER_ROW + 5) * n
        return nbytes, ops
    coarse = levels[level + 1].num_nodes
    if function == "restrict":
        if lvl.restrict_csr is not None:
            return wsum_cost(lvl.restrict_csr, sz, keep=True)
        m = int(lvl.mg_mapping.shape[0])
        return (sz * 5 * (n + 2 * coarse) + 8 * m,
                5 * m + 6 * coarse)
    if function == "prolong":
        if lvl.prolong_csr is not None:
            return wsum_cost(lvl.prolong_csr, sz, correct=True)
        e = int(lvl.edge_a.shape[0])
        return (sz * 5 * (coarse + 3 * n) + 8 * n + sz * 3 * (n + coarse)
                + 16 * e,
                PROLONG_OPS_PER_EDGE * e + PROLONG_OPS_PER_NODE * n)
    raise ValueError(f"unknown solver function {function!r}")
