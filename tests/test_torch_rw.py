"""The launch shapes of csrc/edge_csr.cu's rw mode, and plain walks of the
work each shape's threads do.

- kernels/edge_csr.py rw_shape mirrors the C entry point's choice
  (choose_rw) of the rw shape from the rows, the entries and the dtype.
- tile_schedule redoes what a block of the tile shape does: its rows'
  contiguous entries in chunks, each entry marked with its row by the
  row's thread, each row's thread adding its entries chunk by chunk.
  group_schedule redoes what a warp of a lane-group shape does: the
  passes its longest row needs, each lane's entries stored in the warp's
  slots, the folding lanes reading their group's slots in order.
- walk_rw adds the entries' values, (((q_i + q_j) + w0) + w1) + w2 with
  q_i read through the tile's marks, in the order a shape adds them.
At fp64 and fp32 each walk must equal the plain version (edge_csr_plain)
bit for bit: the same elementwise operations on the same values, summed
in the same order. The plain version is held to the JAX package's Pallas
kernel in tests/test_torch_csr.py.
"""
import numpy as np
import pytest
import torch

from mgcfd_tpu_torch.core.constants import far_field_state
from mgcfd_tpu_torch.kernels import DeviceCSR, edge_csr
from mgcfd_tpu_torch.kernels.edge_csr import (FULL_LEVEL, RW_GROUP8,
                                              RW_GROUP8X2, RW_GROUPS,
                                              RW_LONG_ROW, RW_ROW,
                                              RW_SHAPES, RW_TILE,
                                              RW_TILE_ROWS, THIN_BELOW,
                                              rw_chunk_entries, rw_shape)
from mgcfd_tpu_torch.mesh import generate_unstructured_hierarchy
from mgcfd_tpu_torch.mesh.generate import generate_multigrid_box
from mgcfd_tpu_torch.prep.csr import build_edge_csr, build_flux_csr
from mgcfd_tpu_torch.prep.renumber import renumber_hierarchy

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64, torch.bfloat16)


# --- the launch shape --------------------------------------------------------

# (rows, entries) of the box flagship's and the tet flagship's levels and
# around choose_rw's thresholds -> the shape at fp32 and bf16, and at fp64
RW_CHOICES = {
    # box flagship: 5.9, 5.8, 5.6 and 5.3 entries a row
    (304640, 1800656): (RW_ROW, RW_TILE),
    (38080, 221684): (RW_ROW, RW_ROW),
    (4896, 27644): (RW_GROUP8, RW_GROUP8),
    (648, 3438): (RW_GROUP8, RW_GROUP8),
    # tet flagship (RCM): 15.0, 14.5, 13.8 and 12.3 entries a row
    (304640, 4557558): (RW_TILE, RW_TILE),
    (38080, 553762): (RW_ROW, RW_ROW),
    (4896, 67418): (RW_GROUP8X2, RW_GROUP8X2),
    (648, 7990): (RW_GROUP8X2, RW_GROUP8X2),
    # the thresholds
    (THIN_BELOW - 1, RW_LONG_ROW * (THIN_BELOW - 1)):
        (RW_GROUP8X2, RW_GROUP8X2),
    (THIN_BELOW - 1, RW_LONG_ROW * (THIN_BELOW - 1) - 1):
        (RW_GROUP8, RW_GROUP8),
    (THIN_BELOW, RW_LONG_ROW * THIN_BELOW): (RW_ROW, RW_ROW),
    (FULL_LEVEL - 1, RW_LONG_ROW * (FULL_LEVEL - 1)): (RW_ROW, RW_ROW),
    (FULL_LEVEL, RW_LONG_ROW * FULL_LEVEL): (RW_TILE, RW_TILE),
    (FULL_LEVEL, RW_LONG_ROW * FULL_LEVEL - 1): (RW_ROW, RW_TILE),
}


@pytest.mark.parametrize("dtype", DTYPES)
def test_rw_shape_mirrors_the_c_choice(dtype):
    """choose_rw: below THIN_BELOW rows lane groups (two entries a lane on
    rows of RW_LONG_ROW entries or more on average); from FULL_LEVEL rows
    on the tile for long rows, and at fp64 for any; else a thread per
    row."""
    for (rows, entries), (want, want64) in RW_CHOICES.items():
        got = rw_shape(rows, entries, dtype)
        assert got == (want64 if dtype == torch.float64 else want), \
            (rows, entries)


def test_rw_shapes_are_named_once():
    assert sorted(RW_SHAPES) == list(range(len(RW_SHAPES)))
    assert {RW_ROW, RW_TILE, *RW_GROUPS} == set(RW_SHAPES)
    assert all(g >= 5 and 32 % g == 0 for g, _ in RW_GROUPS.values())


# --- the tile: chunks, marks, sums ------------------------------------------

def tile_schedule(row_ptr, n_rows, B, E):
    """What the tile shape's blocks do: for each block (rows r0 .. r0 + B)
    and each chunk [c0, c1) of its entries, (r0, c0, marks, adds) with
    marks[e] the tile row (thread) that marked entry c0 + e and adds[t]
    the entries that row t's thread adds after the chunk's barrier."""
    out = []
    for r0 in range(0, n_rows, B):
        r1 = min(r0 + B, n_rows)
        e0, e1 = row_ptr[r0], row_ptr[r1]
        for c0 in range(e0, e1, E):
            c1 = min(c0 + E, e1)
            marks = [None] * (c1 - c0)
            adds = []
            for t in range(B):
                own = r0 + t < n_rows
                h0 = row_ptr[r0 + t] if own else e1
                h1 = row_ptr[r0 + t + 1] if own else e1
                a0, a1 = max(h0, c0), min(h1, c1)
                for h in range(a0, a1):
                    assert marks[h - c0] is None, "an entry marked twice"
                    marks[h - c0] = t
                adds.append(list(range(a0, a1)))
            out.append((r0, c0, marks, adds))
    return out


def tile_order(row_ptr, n_rows, B, E):
    """Each row's entries in the order its thread adds them, and each
    entry's row as read through the marks."""
    order = [[] for _ in range(n_rows)]
    owner = {}
    for r0, c0, marks, adds in tile_schedule(row_ptr, n_rows, B, E):
        assert None not in marks, "an entry of the chunk left unmarked"
        for e, t in enumerate(marks):
            owner[c0 + e] = r0 + t
        for t, hs in enumerate(adds):
            if r0 + t < n_rows:
                order[r0 + t] += hs
    return order, owner


def _row_ptr(lengths):
    return [0, *np.cumsum(lengths).tolist()]


@pytest.mark.parametrize("B,E", [(4, 8), (3, 5), (8, 4)])
def test_tile_chunks_cover_each_row_once_in_order(B, E):
    """A row of every start and every length up to three chunks, at every
    place in its tile (the last: the next tile's first row), beside empty
    and short rows, in tiles of B rows and chunks of E entries: each entry
    marked once with its own row, each row's entries added in CSR order,
    rows that cross chunks included."""
    for start in range(2 * E):
        for length in range(3 * E + 1):
            for at in range(1, B + 1):
                lengths = [start] + [0] * (at - 1) + [length, 0, 2, 1]
                rp = _row_ptr(lengths)
                n = len(lengths)
                order, owner = tile_order(rp, n, B, E)
                for r in range(n):
                    assert order[r] == list(range(rp[r], rp[r + 1]))
                    assert all(owner[h] == r for h in order[r])


def test_tile_chunks_at_the_kernel_constants():
    """The kernel's tile (256 rows) and chunks (1024 entries at fp32, 512
    at fp64) on rows of 15 entries: tiles of ~3,840 entries cross chunks."""
    lengths = [15] * 700 + [40, 0, 3] * 30
    rp = _row_ptr(lengths)
    for dtype in (torch.float32, torch.float64):
        order, owner = tile_order(rp, len(lengths), RW_TILE_ROWS,
                                  rw_chunk_entries(dtype))
        for r in range(len(lengths)):
            assert order[r] == list(range(rp[r], rp[r + 1]))
            assert all(owner[h] == r for h in order[r])


# --- the lane groups: passes, slots, folds -----------------------------------

def group_schedule(row_ptr, n_rows, G, K):
    """What a lane-group shape's warps do: for each warp (rows wr0 ..
    wr0 + 32 // G) and each of the passes its longest row needs, per
    group: the slots each lane (g, k) writes with its entry, and the slots
    the folding lanes read, in order. Yields (row, pass, writes {slot:
    entry}, reads [slot])."""
    P, R = G * K, 32 // G
    for wr0 in range(0, n_rows, R):
        rows = range(wr0, min(wr0 + R, n_rows))
        passes = max(-(-(row_ptr[r + 1] - row_ptr[r]) // P) for r in rows)
        for i in rows:
            hs, he = row_ptr[i], row_ptr[i + 1]
            for p in range(passes):
                base = hs + p * P
                writes = {}
                for g in range(G):
                    for k in range(K):
                        h = base + k * G + g
                        if h < he:
                            slot = k * G + g
                            assert slot not in writes
                            writes[slot] = h
                reads = list(range(min(P, he - base)))
                yield i, p, writes, reads


def group_order(row_ptr, n_rows, G, K):
    """Each row's entries in the order its folding lanes add them."""
    order = [[] for _ in range(n_rows)]
    for i, _, writes, reads in group_schedule(row_ptr, n_rows, G, K):
        assert all(s in writes for s in reads), "a slot read unwritten"
        order[i] += [writes[s] for s in reads]
    return order


@pytest.mark.parametrize("shape", sorted(RW_GROUPS))
def test_lane_groups_cover_each_row_once_in_order(shape):
    """A row of every start and every length up to three passes, beside
    rows of other lengths in its warp: each entry written to one slot and
    added once, in CSR order."""
    G, K = RW_GROUPS[shape]
    P = G * K
    for start in range(2 * P):
        for length in range(3 * P + 1):
            lengths = [start, length] + [(3 * k) % (P + 2)
                                         for k in range(40)]
            rp = _row_ptr(lengths)
            order = group_order(rp, len(lengths), G, K)
            for r in range(len(lengths)):
                assert order[r] == list(range(rp[r], rp[r + 1]))


# --- the walks against the plain version ------------------------------------

def walk_rw(csr, x, shape):
    """edge_csr.cu's rw mode at `shape`: each entry's value (((q_i + q_j)
    + w0) + w1) + w2, q_i of the row its tile marked it with, added into
    its row's sum from zero in the order the shape adds them; all rows at
    once."""
    rp = csr.row_ptr.tolist()
    n = csr.num_rows
    owner = csr.owner.tolist()
    if shape == RW_TILE:
        order, owner_of = tile_order(rp, n, RW_TILE_ROWS,
                                     rw_chunk_entries(x.dtype))
        owner = [owner_of[h] for h in range(csr.num_entries)]
    elif shape in RW_GROUPS:
        order = group_order(rp, n, *RW_GROUPS[shape])
    else:
        order = [list(range(rp[r], rp[r + 1])) for r in range(n)]
    longest = max((len(o) for o in order), default=0)
    step = torch.tensor([o + [-1] * (longest - len(o)) for o in order],
                        dtype=torch.int64).reshape(n, longest)
    col = csr.col.to(torch.int64)
    own = torch.tensor(owner, dtype=torch.int64)
    w = csr.w
    out = torch.zeros((5, n), dtype=x.dtype)
    for c in range(5):
        v = x[c, own] + x[c, col] + w[0] + w[1] + w[2]
        acc = torch.zeros(n, dtype=x.dtype)
        for t in range(longest):
            h = step[:, t]
            acc = torch.where(h >= 0, acc + v[h.clamp(min=0)], acc)
        out[c] = acc
    return out


def _state(n, seed, dtype):
    ff = far_field_state(np.float64)[0]
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(ff[:, None] + 0.05 * rng.standard_normal((5, n)))
    q[0, n // 2] = float("nan")
    return q.to(dtype)


def _equal(got, want):
    return torch.equal(torch.isnan(got), torch.isnan(want)) and \
        torch.equal(got.nan_to_num(), want.nan_to_num())


def _csrs():
    """Flux CSRs of a small RCM-ordered tet's levels (irregular rows, up
    to 22 entries: longer than a group's pass; tiles longer than a chunk)
    and of a box's levels, and one with empty rows and empty tiles."""
    tet = renumber_hierarchy(generate_unstructured_hierarchy(12, 12, 12, 3,
                                                             seed=1))
    box = generate_multigrid_box(16, 12, 20, 3)
    out = {f"tet L{i}": build_flux_csr(lv) for i, lv in enumerate(tet.levels)}
    out.update({f"box L{i}": build_flux_csr(lv)
                for i, lv in enumerate(box.levels[:2])})
    lv = tet.levels[0]
    keep = np.minimum(lv.edge_a, lv.edge_b) >= 900
    keep &= np.arange(keep.shape[0]) % 3 != 0
    out["tet L0 sparse"] = build_edge_csr(lv.num_nodes, lv.edge_a[keep],
                                          lv.edge_b[keep], lv.edge_w[keep])
    return out


@pytest.fixture(scope="module")
def csrs():
    return _csrs()


@pytest.mark.parametrize("shape", sorted(RW_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", ["tet L0", "tet L1", "tet L2", "box L0",
                                   "box L1", "tet L0 sparse"])
def test_rw_walk_equals_the_plain_version(csrs, which, dtype, shape):
    plan = csrs[which]
    csr = DeviceCSR.from_plan(plan, "cpu", dtype)
    rows = np.diff(plan.row_ptr)
    if which.startswith("tet"):
        assert rows.min() != rows.max()      # irregular rows
    if which == "tet L0":
        assert rows.max() > 16                # longer than a group's pass
        tile = plan.row_ptr[RW_TILE_ROWS] - plan.row_ptr[0]
        assert tile > rw_chunk_entries(dtype)  # rows cross chunks
    if which == "tet L0 sparse":
        assert rows[:RW_TILE_ROWS].sum() == 0  # an empty tile
    x = _state(csr.num_cols, 2, dtype)
    assert _equal(walk_rw(csr, x, shape),
                  edge_csr.edge_csr_plain("rw", csr, x))
