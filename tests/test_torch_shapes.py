"""The launch shapes of csrc/shift_flux.cu and of edge_csr.cu's wsum mode,
and plain walks of the work each of their threads does.

- kernels/shift.py launch_shape mirrors the C entry point's choice of
  the span kernel's shape (channel split, unrolled span loop) from the
  mode, the dtype, N and the plan's span count; edge_csr.wsum_shape
  mirrors the wsum kernel's choice of a thread per (row, channel) and of
  its loads.
- walk_split below redoes what a thread of the span kernel's rw mode
  does with the channel split, for every (node, channel) at once: one
  channel's neighbours i + d and i - d (quiescent gas outside [0, N))
  and the rows' weights (zero for rows below 0), span by span in plan
  order. walk_wsum redoes a thread per (row, channel) of the wsum
  transfers, taking the entries in the groups its chunked or batched
  loads take them (wsum_groups) and summing them in CSR order.
At fp64 and fp32 each walk must equal the plain version (shift_plain,
edge_csr_plain) bit for bit: the same elementwise operations on the same
values, summed in the same order. The plain versions are held to the JAX
package's Pallas kernels in tests/test_torch_shift.py and
tests/test_torch_csr.py.
"""
import numpy as np
import pytest
import torch

from mgcfd_tpu_torch.core.constants import far_field_state
from mgcfd_tpu_torch.kernels import DeviceCSR, DeviceShift, edge_csr, shift
from mgcfd_tpu_torch.kernels.edge_csr import (BATCHED, CHUNK, CHUNKED,
                                              FULL_LEVEL, PLAIN, THIN_BELOW,
                                              WsumShape, wsum_shape)
from mgcfd_tpu_torch.kernels.shift import (CHANNEL_LANES, MAX_UNROLLED,
                                           FluxShape, launch_shape)
from mgcfd_tpu_torch.mesh import generate_unstructured_hierarchy
from mgcfd_tpu_torch.mesh.generate import (generate_box_mesh,
                                           generate_multigrid_box)
from mgcfd_tpu_torch.prep.csr import build_prolong_csr, build_restrict_csr
from mgcfd_tpu_torch.prep.shift import build_shift_plan

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64, torch.bfloat16)


# --- the launch shape --------------------------------------------------------

# (nodes, spans) -> the rw shape (split, unroll at fp32 and bf16, unroll
# at fp64) and flux mode's unroll (one node a thread at every dtype),
# around each threshold of choose_shape: THIN_BELOW, FULL_LEVEL and
# MAX_UNROLLED
SPAN_SHAPES = {
    (648, 3): (True, True, True, True),
    (THIN_BELOW - 1, MAX_UNROLLED): (True, True, True, True),
    (THIN_BELOW, MAX_UNROLLED): (False, True, True, True),
    (47565, MAX_UNROLLED + 1): (False, False, False, False),
    (FULL_LEVEL - 1, 3): (False, True, True, True),
    (FULL_LEVEL, 3): (False, True, False, True),
    (304640, 1): (False, True, False, True),
    (304640, 16): (False, False, False, False),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["rw", "flux"])
def test_launch_shape_mirrors_the_c_choice(dtype, mode):
    """choose_shape: rw mode one (node, channel) a thread below
    THIN_BELOW nodes, else one node a thread, as flux mode always; the
    span loop unrolled for plans of at most MAX_UNROLLED spans, but not
    in rw mode at fp64 from FULL_LEVEL nodes on."""
    for (n, spans), (split, unroll, unroll64, flux_unroll) in \
            SPAN_SHAPES.items():
        want = FluxShape(split=split,
                         unroll=unroll64 if dtype == torch.float64
                         else unroll) if mode == "rw" \
            else FluxShape(split=False, unroll=flux_unroll)
        assert launch_shape(mode, dtype, n, spans) == want, (n, spans)


def test_the_flagship_levels_take_their_shapes():
    """The box flagship's levels (304,640, 38,080, 4,896 and 648 nodes,
    three spans each): levels 2 and 3 split the rw channels; every level
    unrolls its span loop but rw mode's level 0 at fp64."""
    sizes = (304640, 38080, 4896, 648)
    for dtype in DTYPES:
        got = [launch_shape("rw", dtype, n, 3) for n in sizes]
        assert [s.split for s in got] == [False, False, True, True]
        assert [s.unroll for s in got] == \
            [dtype != torch.float64, True, True, True]
        assert all(launch_shape("flux", dtype, n, 3).unroll for n in sizes)


# (rows, entries) of the box flagship's and a 64^3 tet's transfers ->
# the wsum shape at fp32 and bf16, and at fp64
WSUM_SHAPES = {
    # box flagship: restrictions (8 entries a row) and prolongations
    (38080, 304640): (WsumShape(True, CHUNKED), WsumShape(True, CHUNKED)),
    (304640, 748008): (WsumShape(False, BATCHED), WsumShape(False, PLAIN)),
    (4896, 38080): (WsumShape(True, CHUNKED), WsumShape(True, CHUNKED)),
    (38080, 92346): (WsumShape(False, BATCHED), WsumShape(False, BATCHED)),
    (648, 4896): (WsumShape(True, CHUNKED), WsumShape(True, CHUNKED)),
    (4896, 11518): (WsumShape(True, BATCHED), WsumShape(True, BATCHED)),
    # the tet's: 8 entries a row on average, 1-22 each; prolongations of
    # 4.33, 4.18 and 3.87 on average
    (32768, 262144): (WsumShape(True, CHUNKED), WsumShape(True, CHUNKED)),
    (262144, 1134396): (WsumShape(True, CHUNKED), WsumShape(True, CHUNKED)),
    (4096, 32768): (WsumShape(True, CHUNKED), WsumShape(True, CHUNKED)),
    (32768, 136960): (WsumShape(True, CHUNKED), WsumShape(True, CHUNKED)),
    (512, 4096): (WsumShape(True, CHUNKED), WsumShape(True, CHUNKED)),
    (4096, 15867): (WsumShape(True, BATCHED), WsumShape(True, BATCHED)),
}


@pytest.mark.parametrize("dtype", DTYPES)
def test_wsum_shape_mirrors_the_c_choice(dtype):
    """choose_wsum: rows of CHUNK entries or more on average per (row,
    channel) with chunked loads; shorter rows batched, split below
    THIN_BELOW rows, and at fp64 from FULL_LEVEL rows on per row with
    plain loads."""
    for (rows, entries), (want, want64) in WSUM_SHAPES.items():
        got = wsum_shape(rows, entries, dtype)
        assert got == (want64 if dtype == torch.float64 else want), \
            (rows, entries)


@pytest.mark.parametrize("n_rows", [1, 63, 64, 65, 300])
def test_channel_lanes_cover_each_row_and_channel_once(n_rows):
    """The per-channel kernels' block layout (kChannelLanes): thread t of
    block b is channel t // lanes of row b * lanes + t % lanes."""
    blocks = -(-n_rows // CHANNEL_LANES)
    seen = []
    for b in range(blocks):
        for t in range(5 * CHANNEL_LANES):
            c, row = t // CHANNEL_LANES, b * CHANNEL_LANES + t % CHANNEL_LANES
            if row < n_rows:
                seen.append((row, c))
    assert sorted(seen) == [(r, c) for r in range(n_rows) for c in range(5)]


# --- plain walks of a span-kernel thread -------------------------------------

def _quiet(c):
    return 1.0 if c in (0, 4) else 0.0


def _shifted(row, off, fill):
    """row[j + off] for every j, `fill` where j + off is outside [0, N)."""
    n = row.shape[0]
    j = torch.arange(n) + off
    inside = (j >= 0) & (j < n)
    return torch.where(inside, row[j.clamp(0, n - 1)], fill)


def walk_split(sh, q):
    """shift_flux.cu's rw mode with the channel split: thread (c, i) adds
    (q_i + q_{i+d}) + e_d(i) and subtracts (q_{i-d} + q_i) + e_d(i - d)
    per span, e_d(j) = (wx + wy) + wz of row j, zero for j < 0; all
    threads at once."""
    out = []
    for c in range(5):
        qi, acc = q[c], torch.zeros_like(q[c])
        for k, d in enumerate(sh.deltas):
            e = (sh.w[k, 0] + sh.w[k, 1]) + sh.w[k, 2]
            acc = acc + ((qi + _shifted(qi, d, _quiet(c))) + e)
            acc = acc - ((_shifted(qi, -d, _quiet(c)) + qi)
                         + _shifted(e, -d, 0.0))
        out.append(acc)
    return torch.stack(out)


def _tet(level):
    return lambda: generate_unstructured_hierarchy(
        12, 12, 12, 2, seed=1, h=0.1).levels[level]


# (level maker, build_shift_plan keywords): box levels of 3840, 480 and
# 60 nodes, spans not all multiples of anything, an odd node count, a
# one-span plan, and the tet's levels with 16-span plans
LEVELS = {
    "mg box L0": (lambda: generate_multigrid_box(16, 12, 20, 3).levels[0],
                  {}),
    "mg box L1": (lambda: generate_multigrid_box(16, 12, 20, 3).levels[1],
                  {}),
    "mg box L2": (lambda: generate_multigrid_box(16, 12, 20, 3).levels[2],
                  {}),
    "box 5x20x150": (lambda: generate_box_mesh(5, 20, 150), {}),
    "box 7x9x13 odd": (lambda: generate_box_mesh(7, 9, 13), {}),
    "box one-span": (lambda: generate_box_mesh(8, 9, 10), {"max_deltas": 1}),
    "tet 12^3 L0": (_tet(0), {"min_density": 0.002}),
    "tet 12^3 L1": (_tet(1), {"min_density": 0.002}),
}


@pytest.fixture(scope="module", params=list(LEVELS))
def level(request):
    make, kw = LEVELS[request.param]
    lvl = make()
    return request.param, lvl, build_shift_plan(lvl, **kw)


def _state(n, seed, dtype):
    ff = far_field_state(np.float64)[0]
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(ff[:, None] + 0.05 * rng.standard_normal((5, n)))
    q[0, n // 2] = -5.0          # a NaN speed of sound in flux mode
    return q.to(dtype)


def _equal(got, want):
    return torch.equal(torch.isnan(got), torch.isnan(want)) and \
        torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_split_walk_equals_the_plain_version(level, dtype):
    name, lvl, plan = level
    n = lvl.num_nodes
    sh = DeviceShift.from_plan(plan, n, "cpu", dtype)
    q = _state(n, 1, dtype)
    assert _equal(walk_split(sh, q), shift.shift_plain("rw", sh, q))


# --- plain walk of a wsum thread ---------------------------------------------

def wsum_groups(start, end, loads):
    """The entries [start, end) of one row in the groups that a wsum
    thread loads together (csrc/edge_csr.cu wsum_row): BATCHED CHUNK at a
    time from the row's start; CHUNKED one by one up to the first entry on
    a CHUNK boundary, then whole chunks, then one by one; PLAIN one by
    one."""
    if loads == BATCHED:
        return [list(range(h, min(h + CHUNK, end)))
                for h in range(start, end, CHUNK)]
    groups, h = [], start
    if loads == CHUNKED:
        while h < end and h % CHUNK:
            groups.append([h])
            h += 1
        while h + CHUNK <= end:
            groups.append(list(range(h, h + CHUNK)))
            h += CHUNK
    groups += [[k] for k in range(h, end)]
    return groups


@pytest.mark.parametrize("loads", [PLAIN, CHUNKED, BATCHED])
def test_wsum_groups_cover_each_row_once_in_order(loads):
    """Every start and length up to three chunks: the groups, in order,
    are the row's entries in CSR order; a chunked load starts on a CHUNK
    boundary and holds CHUNK entries."""
    for start in range(3 * CHUNK):
        for length in range(3 * CHUNK + 1):
            groups = wsum_groups(start, start + length, loads)
            assert [h for g in groups for h in g] == \
                list(range(start, start + length))
            if loads == CHUNKED:
                assert all(g[0] % CHUNK == 0 for g in groups if len(g) > 1)
                assert all(len(g) in (1, CHUNK) for g in groups)


def walk_wsum(csr, x, loads):
    """edge_csr.cu's wsum kernels: thread (c, row) loads its row's entries
    in the groups of wsum_groups and, after each group's loads, adds
    w[0, h] x[c, col[h]] for its entries in order; all threads at once."""
    rp = csr.row_ptr.tolist()
    order = [[h for g in wsum_groups(rp[r], rp[r + 1], loads) for h in g]
             for r in range(csr.num_rows)]
    longest = max((len(o) for o in order), default=0)
    step = torch.tensor([o + [-1] * (longest - len(o)) for o in order],
                        dtype=torch.int64).reshape(csr.num_rows, longest)
    col = csr.col.to(torch.int64)
    out = torch.zeros((5, csr.num_rows), dtype=x.dtype)
    for c in range(5):
        acc = torch.zeros(csr.num_rows, dtype=x.dtype)
        for t in range(longest):
            h = step[:, t]
            valid = h >= 0
            hk = h.clamp(min=0)
            acc = torch.where(valid, acc + csr.w[0, hk] * x[c, col[hk]],
                              acc)
        out[c] = acc
    return out


def _transfers():
    box = generate_multigrid_box(16, 12, 20, 3)
    tet = generate_unstructured_hierarchy(10, 10, 10, 3, seed=1, h=0.1)
    out = {}
    for label, mesh in (("box", box), ("tet", tet)):
        for i in range(mesh.num_levels - 1):
            f, c = mesh.levels[i], mesh.levels[i + 1]
            out[f"{label} L{i} restriction"] = build_restrict_csr(
                f.mg_mapping, f.num_nodes, c.num_nodes)[0]
            out[f"{label} L{i} prolongation"] = build_prolong_csr(f, c)
    return out


@pytest.fixture(scope="module")
def transfers():
    return _transfers()


@pytest.mark.parametrize("loads", [CHUNKED, BATCHED])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", ["box L0 restriction",
                                   "box L0 prolongation",
                                   "box L1 prolongation",
                                   "tet L0 restriction",
                                   "tet L0 prolongation",
                                   "tet L1 restriction",
                                   "tet L1 prolongation"])
def test_wsum_walk_equals_the_plain_version(transfers, which, dtype,
                                            loads):
    plan = transfers[which]
    csr = DeviceCSR.from_plan(plan, "cpu", dtype)
    x = _state(csr.num_cols, 2, dtype)
    rows = np.diff(plan.row_ptr)
    if which.startswith("tet"):
        assert rows.min() != rows.max()      # irregular rows
    got = walk_wsum(csr, x, loads)
    assert _equal(got, edge_csr.edge_csr_plain("wsum", csr, x))
