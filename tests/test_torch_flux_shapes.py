"""The launch shapes of csrc/edge_csr.cu's flux mode, and plain walks of the
work each shape's threads do.

- kernels/edge_csr.py flux_shape mirrors the C entry point's choice
  (choose_flux) of the flux shape from the rows, the entries and the
  dtype.
- tile_walk redoes what a block of a tile shape does: its rows' contiguous
  entries in chunks, each entry marked with its row by the row's thread,
  each entry's neighbour read from the tile's window (the tile's own rows,
  completed from `own`) or completed from x, each row's thread adding its
  entries chunk by chunk.
- walk_flux evaluates each entry's flux value from the owner and the
  neighbour the shape reads, and adds the values into each row's sum from
  zero in the order the shape adds them.
At fp64 and fp32 each walk must equal the plain version (edge_csr_plain)
bit for bit: the same elementwise operations on the same values, summed
in the same order. At fp64 it is also held to the JAX package's Pallas
kernel (interpret mode), as tests/test_torch_csr.py holds the plain
version.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.ops import tops as JT
from mgcfd_tpu.pallas.flux_window import PallasWindowFlux
from mgcfd_tpu.prep.window import build_window_plan
from mgcfd_tpu.validate.golden import identify_differences
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.constants import far_field_state
from mgcfd_tpu_torch.kernels import DeviceCSR, edge_csr
from mgcfd_tpu_torch.kernels.edge_csr import (FLUX_ROW, FLUX_SHAPES,
                                              FLUX_MID_LEVEL, FLUX_TILE,
                                              FLUX_TILE_ROWS, FULL_LEVEL,
                                              RW_LONG_ROW, THIN_BELOW,
                                              chunk_entries, complete8,
                                              flux_math, flux_shape)
from mgcfd_tpu_torch.mesh import generate_unstructured_hierarchy
from mgcfd_tpu_torch.mesh.generate import generate_multigrid_box
from mgcfd_tpu_torch.parallel import partition
from mgcfd_tpu_torch.parallel.sharded import conditioned
from mgcfd_tpu_torch.prep.csr import build_edge_csr, build_flux_csr
from mgcfd_tpu_torch.prep.renumber import renumber_hierarchy

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64, torch.bfloat16)


# --- the launch shape --------------------------------------------------------

# (rows, entries) of the box flagship's and the tet flagship's levels, of
# shard 0's level-0 CSR of the tet flagship at P = 1, 2 and 4, and around
# choose_flux's thresholds -> the shape at fp32 and bf16, and at fp64
FLUX_CHOICES = {
    # box flagship: 5.9, 5.8, 5.6 and 5.3 entries a row; its spill edges
    # on one-span plans 2.0
    (304640, 1800656): (FLUX_ROW, FLUX_ROW),
    (38080, 221684): (FLUX_ROW, FLUX_ROW),
    (4896, 27644): (FLUX_ROW, FLUX_ROW),
    (648, 3438): (FLUX_ROW, FLUX_ROW),
    (304640, 600040): (FLUX_ROW, FLUX_ROW),
    # tet flagship (RCM): 15.0, 14.5, 13.8 and 12.3 entries a row; its
    # level 0 is also shard 0 at P = 1
    (304640, 4557558): (FLUX_TILE, FLUX_TILE),
    (38080, 553762): (FLUX_ROW, FLUX_TILE),
    (4896, 67418): (FLUX_TILE, FLUX_TILE),
    (648, 7990): (FLUX_TILE, FLUX_TILE),
    # shard 0 of the tet flagship's level 0 at P = 2 and 4
    (152320, 2261087): (FLUX_TILE, FLUX_TILE),
    (76160, 1110378): (FLUX_TILE, FLUX_TILE),
    # the thresholds
    (THIN_BELOW - 1, RW_LONG_ROW * (THIN_BELOW - 1)): (FLUX_TILE, FLUX_TILE),
    (THIN_BELOW - 1, RW_LONG_ROW * (THIN_BELOW - 1) - 1): (FLUX_ROW,
                                                           FLUX_ROW),
    (THIN_BELOW, RW_LONG_ROW * THIN_BELOW): (FLUX_ROW, FLUX_TILE),
    (FLUX_MID_LEVEL - 1, RW_LONG_ROW * (FLUX_MID_LEVEL - 1)): (FLUX_ROW,
                                                               FLUX_TILE),
    (FLUX_MID_LEVEL, RW_LONG_ROW * FLUX_MID_LEVEL): (FLUX_TILE, FLUX_TILE),
    (FULL_LEVEL - 1, RW_LONG_ROW * (FULL_LEVEL - 1)): (FLUX_TILE, FLUX_TILE),
    (FULL_LEVEL, RW_LONG_ROW * FULL_LEVEL): (FLUX_TILE, FLUX_TILE),
    (FULL_LEVEL, RW_LONG_ROW * FULL_LEVEL - 1): (FLUX_ROW, FLUX_ROW),
}


@pytest.mark.parametrize("dtype", DTYPES)
def test_flux_shape_mirrors_the_c_choice(dtype):
    """choose_flux: rows of RW_LONG_ROW entries or more on average take
    the tile, but a thread per row from THIN_BELOW up to FLUX_MID_LEVEL
    rows at fp32 and bf16; shorter rows a thread per row."""
    for (rows, entries), (want, want64) in FLUX_CHOICES.items():
        got = flux_shape(rows, entries, dtype)
        assert got == (want64 if dtype == torch.float64 else want), \
            (rows, entries)


def test_flux_shapes_are_named_once():
    assert sorted(FLUX_SHAPES) == list(range(len(FLUX_SHAPES)))
    assert set(FLUX_SHAPES) == {FLUX_ROW, FLUX_TILE}
    # an entry's row is a byte of shared memory
    assert 0 < FLUX_TILE_ROWS <= 256


# --- the tile: chunks, marks, window, sums ----------------------------------

def tile_walk(row_ptr, col, n_rows, B, E):
    """What a tile shape's blocks do: each block owns rows r0 .. r1 =
    min(r0 + B, n_rows) and their entries; per chunk [c0, c1) each row's
    thread marks its entries with its row, every entry is evaluated with
    the marked row as owner and its neighbour from the window when r0 <=
    col < r1, then each row's thread adds its entries. Returns (order,
    owner, window): each row's entries in the order its thread adds them,
    each entry's owner as read through the marks, and whether its
    neighbour was read from the window."""
    order = [[] for _ in range(n_rows)]
    owner = [None] * len(col)
    window = [None] * len(col)
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
            assert None not in marks, "an entry of the chunk left unmarked"
            for e, t in enumerate(marks):
                h = c0 + e
                assert owner[h] is None, "an entry evaluated twice"
                owner[h] = r0 + t
                window[h] = r0 <= col[h] < r1
            for t, hs in enumerate(adds):
                if r0 + t < n_rows:
                    order[r0 + t] += hs
    return order, owner, window


def _row_ptr(lengths):
    return [0, *np.cumsum(lengths).tolist()]


@pytest.mark.parametrize("B,E", [(4, 8), (3, 5), (8, 4)])
def test_tile_chunks_cover_each_row_once_in_order(B, E):
    """A row of every start and every length up to three chunks, at every
    place in its tile, beside empty and short rows, in tiles of B rows and
    chunks of E entries: each entry evaluated once with its own row as
    owner, each row's entries added in CSR order, rows that cross chunks
    included; a neighbour read from the window exactly when it is one of
    the tile's rows."""
    for start in range(2 * E):
        for length in range(3 * E + 1):
            for at in range(1, B + 1):
                lengths = [start] + [0] * (at - 1) + [length, 0, 2, 1]
                rp = _row_ptr(lengths)
                n = len(lengths)
                col = [(h * 7) % (n + 3) for h in range(rp[-1])]
                order, owner, window = tile_walk(rp, col, n, B, E)
                for r in range(n):
                    assert order[r] == list(range(rp[r], rp[r + 1]))
                    assert all(owner[h] == r for h in order[r])
                for h, j in enumerate(col):
                    r0 = owner[h] - owner[h] % B
                    assert window[h] == (r0 <= j < min(r0 + B, n))


def test_tile_chunks_at_the_kernel_constants():
    """The kernel's tiles (128 rows) and chunks (1024 entries at fp32 and
    bf16, 512 at fp64) on rows of 15 entries: tiles of 1,920 entries cross
    chunks."""
    lengths = [15] * 700 + [40, 0, 3] * 30
    rp = _row_ptr(lengths)
    n = len(lengths)
    col = [(h * 13) % n for h in range(rp[-1])]
    for dtype in DTYPES:
        order, owner, _ = tile_walk(rp, col, n, FLUX_TILE_ROWS,
                                    chunk_entries(dtype))
        for r in range(n):
            assert order[r] == list(range(rp[r], rp[r + 1]))
            assert all(owner[h] == r for h in order[r])


def stage_copies(n_half, w_offset, E, c0, c1):
    """csr_tile.cuh stage_chunk's copies of a chunk [c0, c1) of bfloat16
    weights, w starting w_offset elements past a 4-byte boundary: (first
    element of w, first slot of the shared (4, E + 2) buffer, elements).
    Pairs of entries where every weight row starts on a 4-byte boundary,
    else entry by entry."""
    if n_half % 2 == 0 and w_offset % 2 == 0:
        p0, p1 = c0 >> 1, (c1 + 1) >> 1
        return [(k * n_half + 2 * p, k * (E + 2) + 2 * (p - p0), 2)
                for p in range(p0, p1) for k in range(4)]
    s = (c0 & 1) - c0
    return [(k * n_half + h, k * (E + 2) + h + s, 1)
            for h in range(c0, c1) for k in range(4)]


@pytest.mark.parametrize("n_half,w_offset", [(8, 0), (9, 0), (8, 1),
                                             (9, 1), (2, 0), (1, 0)])
def test_bf16_weight_staging_is_aligned_and_in_bounds(n_half, w_offset):
    """Every chunk of every start and length: each 4-byte copy starts on a
    4-byte boundary of w and of the buffer, no copy reads past the end of
    w (4 n_half elements), and entry h of weight row k lands where the
    tile reads it, slot k (E + 2) + h - c0 + (c0 & 1). An odd n_half (a
    shard's CSR: 2,261,087 entries at P = 2) or an unaligned w gives
    misaligned pairs, row 3's last reading past the end."""
    E = 6
    for c0 in range(n_half):
        for c1 in range(c0 + 1, min(c0 + E, n_half) + 1):
            sw = {}
            for src, dst, n in stage_copies(n_half, w_offset, E, c0, c1):
                if n == 2:
                    assert (w_offset + src) % 2 == 0 and dst % 2 == 0
                assert src + n <= 4 * n_half
                sw.update({dst + e: src + e for e in range(n)})
            assert max(sw) < 4 * (E + 2)
            for k in range(4):
                for h in range(c0, c1):
                    assert sw[k * (E + 2) + h - c0 + (c0 & 1)] == \
                        k * n_half + h


# --- the walks against the plain version ------------------------------------

def walk_flux(csr, x, shape, own=None):
    """edge_csr.cu's flux mode at `shape`: each entry's flux_math value,
    the owner completed from `own` (x's first columns without it) at the
    row its tile marked it with, the neighbour from the tile's window
    (completed from `own`) or completed from x, added into its row's sum
    from zero in the order the shape adds them; all rows at once."""
    n = csr.num_rows
    rp, col = csr.row_ptr.tolist(), csr.col.tolist()
    owner = csr.owner.tolist()
    window = [False] * csr.num_entries
    if shape == FLUX_TILE:
        order, owner, window = tile_walk(rp, col, n, FLUX_TILE_ROWS,
                                         chunk_entries(x.dtype))
    else:
        order = [list(range(rp[r], rp[r + 1])) for r in range(n)]
    own = x[:, :n] if own is None else own
    q_own, q_nbr = complete8(own), complete8(x)
    o = torch.tensor(owner, dtype=torch.int64)
    j = csr.col.to(torch.int64)
    win = torch.tensor(window, dtype=torch.bool)
    jw = torch.where(win, j, 0)
    qo = [v[o] for v in q_own]
    qn = [torch.where(win, a[jw], b[j]) for a, b in zip(q_own, q_nbr)]
    w = csr.w
    vals = flux_math(qo, qn, w[0], w[1], w[2], w[3])
    longest = max((len(r) for r in order), default=0)
    step = torch.tensor([r + [-1] * (longest - len(r)) for r in order],
                        dtype=torch.int64).reshape(n, longest)
    out = torch.zeros((5, n), dtype=x.dtype)
    for c in range(5):
        acc = torch.zeros(n, dtype=x.dtype)
        for t in range(longest):
            h = step[:, t]
            acc = torch.where(h >= 0, acc + vals[c][h.clamp(min=0)], acc)
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


def _pool_csr(n_rows=200, n_pool=100, seed=4):
    """A [block | pool] CSR whose last, short tile's rows neighbour the
    first pool columns: row i has the entries (i, i + 1 mod n_rows) and
    (i, n_rows + i mod n_pool), so a tile that read a column past n_rows
    from its window would show."""
    a = np.concatenate([np.arange(n_rows)] * 2)
    b = np.concatenate([(np.arange(n_rows) + 1) % n_rows,
                        n_rows + np.arange(n_rows) % n_pool])
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(a,
                                                         minlength=n_rows))])
    w = np.random.default_rng(seed).standard_normal((4, a.shape[0]))
    return SimpleNamespace(num_rows=n_rows, num_cols=n_rows + n_pool,
                           num_entries=a.shape[0], row_ptr=row_ptr,
                           owner=a, col=b, w=w)


def _csrs():
    """Flux CSRs of a small RCM-ordered tet's levels (irregular rows, up to
    22 entries; level 0's tiles longer than a chunk), of a box's levels,
    one with empty rows and an empty tile, shard 0's [block | pool] CSR of
    the tet's level 0 at P = 2 and at P = 4 (an odd entry count), and a [block | pool] CSR whose short last
    tile neighbours the pool's first columns."""
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
    clv = conditioned(tet).levels[0]
    for P in (2, 4):
        out[f"shard 0 of {P}"] = partition.shard_flux_csr(
            clv, partition.partition_level(clv, P), 0)
    out["pool"] = _pool_csr()
    return out


@pytest.fixture(scope="module")
def csrs():
    return _csrs()


@pytest.mark.parametrize("shape", sorted(FLUX_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", ["tet L0", "tet L1", "tet L2", "box L0",
                                   "box L1", "tet L0 sparse",
                                   "shard 0 of 2", "shard 0 of 4", "pool"])
def test_flux_walk_equals_the_plain_version(csrs, which, dtype, shape):
    plan = csrs[which]
    csr = DeviceCSR.from_plan(plan, "cpu", dtype)
    rows = np.diff(plan.row_ptr)
    if which.startswith("tet"):
        assert rows.min() != rows.max()      # irregular rows
    if which == "tet L0":
        tile = plan.row_ptr[FLUX_TILE_ROWS] - plan.row_ptr[0]
        assert tile > chunk_entries(dtype)   # tiles cross chunks
    if which == "tet L0 sparse":
        assert rows[:FLUX_TILE_ROWS].sum() == 0  # an empty tile
    x = _state(csr.num_cols, 2, dtype)
    own = None
    if csr.num_cols > csr.num_rows:         # [block | pool]: own apart
        own = x[:, :csr.num_rows].clone()
        if shape == FLUX_TILE:
            _, _, window = tile_walk(plan.row_ptr.tolist(),
                                     plan.col.tolist(), csr.num_rows,
                                     FLUX_TILE_ROWS, chunk_entries(dtype))
            assert not any(w and j >= csr.num_rows
                           for w, j in zip(window, plan.col.tolist()))
        if which == "pool":                  # the short last tile's rows
            last = csr.num_rows - csr.num_rows % FLUX_TILE_ROWS
            assert (plan.col[plan.row_ptr[last]:] >= csr.num_rows).any()
    if which == "shard 0 of 4":
        assert plan.num_entries % 2 == 1       # an odd entry count
    want = edge_csr.edge_csr_plain("flux", csr, x, own)
    assert _equal(walk_flux(csr, x, shape, own), want)
    # on CPU tensors at() takes the plain version whatever the shape: this
    # holds only that it takes flux mode, a shape and `own`
    assert _equal(edge_csr.flux.at(csr, x, shape, own), want)


# --- the walk against the JAX package's Pallas kernel -----------------------

@pytest.fixture(scope="module")
def jmesh():
    return jax_tet(8, 8, 8, 2, seed=5)


@pytest.mark.parametrize("shape", sorted(FLUX_SHAPES))
def test_flux_walk_matches_pallas_window(jmesh, shape):
    """Each shape's walk at fp64 on a small tet's level 0 (rows longer
    than a chunk's share of a tile, tiles shorter than the level) against
    PallasWindowFlux in interpret mode, within identify_differences."""
    jl = jmesh.levels[0]
    pl = mesh_from_arrays(jmesh).levels[0]
    n = pl.num_nodes
    plan = build_window_plan(jl)
    ff = far_field_state(np.float64)[0]
    rng = np.random.default_rng(1)
    q = np.tile(ff[:, None], (1, plan.padded_nodes))
    q[:, :n] += 0.05 * rng.standard_normal((5, n))
    qj = jnp.asarray(q)
    want = np.asarray(PallasWindowFlux(plan, n, dtype=jnp.float64,
                                       interpret=True)(qj))
    if plan.spill_a.shape[0]:
        sa, sb = jnp.asarray(plan.spill_a), jnp.asarray(plan.spill_b)
        val = JT.t_internal_edge_flux(qj[:, sa], qj[:, sb],
                                      jnp.asarray(plan.spill_w).T)
        want = want + np.asarray(JT.t_segment_accumulate(
            jnp.concatenate([val, -val], axis=1),
            jnp.concatenate([sa, sb]), plan.padded_nodes))
    csr = DeviceCSR.from_plan(build_flux_csr(pl), "cpu", torch.float64)
    got = walk_flux(csr, torch.as_tensor(q[:, :n].copy()), shape).numpy()
    assert n > FLUX_TILE_ROWS
    assert identify_differences(got, want[:, :n], jmesh.variant) == 0
