"""The host-side geometry of the two tiled RK-stage kernels
(csrc/shift_fused_stage.cu, csrc/fused_stage.cu) and a plain PyTorch walk
of each schedule.

- kernels/shift.py span_schedule sorts a plan's spans into halo, marched
  and direct ones; the march's pencils, steps and chunks must cover every
  node exactly once.
- row_tiles below cuts a CSR into the kernel's row tiles and entry
  chunks, as the kernel does.
- walk_shift and walk_csr below redo, tile by tile, what the kernels do,
  with their index arithmetic: windows completed once with quiescent gas
  outside [0, N), halo-span values over [base - d, base + B), the marched
  span's carried value, direct spans, entry chunks with the neighbour
  read from the tile's window or completed from the state. At fp64 each must
  equal the plain version (shift_fused_stage_plain, fused_stage_plain)
  bit for bit: the same elementwise operations on the same values, summed
  in the same order. The plain versions are held to the JAX package's
  Pallas kernels in tests/test_torch_shift.py and tests/test_torch_csr.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mgcfd_tpu_torch.core.constants import far_field_state
from mgcfd_tpu_torch.kernels import DeviceCSR, DeviceShift, shift
from mgcfd_tpu_torch.kernels.edge_csr import complete8, flux_math
from mgcfd_tpu_torch.kernels.fused_stage import bw_flux, fused_stage_plain
from mgcfd_tpu_torch.kernels.shift import (DIRECT, HALO, MARCHED, MAX_HALO,
                                           TILE_NODES, span_schedule)
from mgcfd_tpu_torch.mesh import generate_unstructured_hierarchy
from mgcfd_tpu_torch.mesh.generate import (generate_box_mesh,
                                           generate_multigrid_box)
from mgcfd_tpu_torch.ops.tops import build_dense_boundary_wall
from mgcfd_tpu_torch.prep.csr import build_flux_csr
from mgcfd_tpu_torch.prep.shift import build_shift_plan

torch.set_num_threads(1)

# rows per tile of csrc/fused_stage.cu (kTileRows), and entries per chunk
# (chunk_entries: 20 KiB of flux values in the compute type)
TILE_ROWS = 128
CHUNK_ENTRIES = {torch.float32: 1024, torch.bfloat16: 1024,
                 torch.float64: 512}


def row_tiles(row_ptr, chunk):
    """fused_stage.cu's schedule: per tile (rows [r0, r1), its chunks of
    at most `chunk` entries as (c0, c1)), as its blocks walk it."""
    row_ptr = np.asarray(row_ptr)
    n = row_ptr.shape[0] - 1
    tiles = []
    for r0 in range(0, n, TILE_ROWS):
        r1 = min(r0 + TILE_ROWS, n)
        e0, e1 = int(row_ptr[r0]), int(row_ptr[r1])
        tiles.append((r0, r1, [(c0, min(c0 + chunk, e1))
                               for c0 in range(e0, e1, chunk)]))
    return tiles


def _tet(level):
    return lambda: generate_unstructured_hierarchy(
        12, 12, 12, 2, seed=1, h=0.1).levels[level]


# (level maker, build_shift_plan keywords)
LEVELS = {
    "box 11x8x8": (lambda: generate_box_mesh(11, 8, 8, volume_jitter=0.2,
                                             seed=3), {}),
    "mg box L0": (lambda: generate_multigrid_box(16, 12, 20, 3).levels[0],
                  {}),
    "mg box L1": (lambda: generate_multigrid_box(16, 12, 20, 3).levels[1],
                  {}),
    "mg box L2": (lambda: generate_multigrid_box(16, 12, 20, 3).levels[2],
                  {}),
    "box one-span": (lambda: generate_box_mesh(9, 7, 10), {"max_deltas": 1}),
    "box 5x20x150 marched and direct": (
        lambda: generate_box_mesh(5, 20, 150), {}),
    "tet 12^3 L0": (_tet(0), {"min_density": 0.002}),
    "tet 12^3 L1": (_tet(1), {"min_density": 0.002}),
}


@pytest.fixture(scope="module", params=list(LEVELS))
def level(request):
    make, kw = LEVELS[request.param]
    lvl = make()
    return request.param, lvl, build_shift_plan(lvl, **kw)


# --- the span schedule ------------------------------------------------------

def test_span_schedule_places_every_span_once(level):
    name, lvl, plan = level
    n = lvl.num_nodes
    sch = span_schedule(plan.deltas, n)
    d = list(plan.deltas)
    assert len(sch.kinds) == len(d)   # one kind per span, in plan order
    assert set(sch.kinds) <= {HALO, MARCHED, DIRECT}
    halo = [x for x, k in zip(d, sch.kinds) if k == HALO]
    long = [x for x in d if x > MAX_HALO]
    assert halo == [x for x in d if x <= MAX_HALO]
    assert sch.halo % 8 == 0 and sch.halo <= MAX_HALO
    assert sch.halo == -(-max(halo, default=0) // 8) * 8
    marched = [x for x, k in zip(d, sch.kinds) if k == MARCHED]
    if long:
        assert marched == [max(long)]
        assert sch.stride == max(long)
    else:
        assert marched == [] and sch.stride == TILE_NODES
    direct = sorted(x for x, k in zip(d, sch.kinds) if k == DIRECT)
    assert direct == sorted(long)[:-1]
    assert sch.pencils == -(-sch.stride // TILE_NODES)
    assert sch.steps == -(-n // sch.stride)
    if name == "box 5x20x150 marched and direct":
        assert sch.kinds == (HALO, DIRECT, MARCHED)


def march_nodes(sch, n):
    """Every node a block owns, block by block and step by step, as the
    kernel's index arithmetic gives them."""
    owned = []
    for b in range(sch.blocks):
        r0 = (b % sch.pencils) * TILE_NODES
        s0 = (b // sch.pencils) * sch.chunk
        width = min(TILE_NODES, sch.stride - r0)
        for s in range(s0, min(s0 + sch.chunk, sch.steps)):
            base = r0 + s * sch.stride
            owned.extend(i for i in range(base, base + width) if i < n)
    return owned


@pytest.mark.parametrize("chunk", [None, 1, 3])
def test_march_chunks_cover_every_node_once(level, chunk):
    _, lvl, plan = level
    n = lvl.num_nodes
    sch = span_schedule(plan.deltas, n)
    if chunk is not None:
        sch = dataclasses.replace(sch, chunk=chunk)
    owned = march_nodes(sch, n)
    assert len(owned) == n
    assert sorted(owned) == list(range(n))


# --- the CSR row tiles --------------------------------------------------------

@pytest.mark.parametrize("cap", [CHUNK_ENTRIES[torch.bfloat16],
                                 CHUNK_ENTRIES[torch.float64], 7])
def test_row_tiles_cover_rows_and_respect_the_cap(level, cap):
    _, lvl, _ = level
    plan = build_flux_csr(lvl)
    tiles = row_tiles(plan.row_ptr, cap)
    rows, entries = [], []
    for r0, r1, chunks in tiles:
        assert r0 % TILE_ROWS == 0 and 0 < r1 - r0 <= TILE_ROWS
        rows.extend(range(r0, r1))
        assert (chunks[0][0] if chunks else plan.row_ptr[r1]) == \
            plan.row_ptr[r0]
        for c0, c1 in chunks:
            assert 0 < c1 - c0 <= cap
            entries.extend(range(c0, c1))
        if chunks:
            assert chunks[-1][1] == plan.row_ptr[r1]
    assert rows == list(range(plan.num_rows))
    assert entries == list(range(plan.num_entries))


# --- plain walks of the two schedules ------------------------------------------

def _state(n, seed):
    ff = far_field_state(np.float64)[0]
    rng = np.random.default_rng(seed)
    return torch.as_tensor(ff[:, None] + 0.05 * rng.standard_normal((5, n)))


def _operands(lvl):
    n = lvl.num_nodes
    bdn, wln, wlc = build_dense_boundary_wall(
        n, lvl.bedge_b, lvl.bedge_w, lvl.wedge_b, lvl.wedge_w,
        far_field_state(np.float64)[1])
    nc = torch.as_tensor(np.concatenate([bdn, wln, wlc]))
    q, old = _state(n, 1), _state(n, 2)
    q[0, n // 2] = -5.0          # a NaN speed of sound, and a count
    fac = torch.as_tensor(1e-3 * (1 + np.random.default_rng(3).random(n)))
    spill = 1e-3 * _state(n, 4)
    return nc, q, old, fac, spill


def _states(q, idx):
    """Completed states of nodes idx; quiescent gas outside [0, N)."""
    n = q.shape[1]
    inside = (idx >= 0) & (idx < n)
    quiet = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0], dtype=q.dtype)
    return complete8(torch.where(inside, q[:, idx.clamp(0, n - 1)],
                                 quiet[:, None]))


def _weights(w, idx):
    """Weight rows of idx; zero outside [0, N)."""
    n = w.shape[1]
    inside = (idx >= 0) & (idx < n)
    return torch.where(inside, w[:, idx.clamp(0, n - 1)], 0.0)


def _cut(st, lo, hi):
    return [x[lo:hi] for x in st]


def _edge(a, b, w):
    return flux_math(a, b, w[0], w[1], w[2], w[3])


def _update(qi, acc, nc, old, fac, spill, i):
    a = acc + bw_flux(qi, nc[:, i])
    if spill is not None:
        a = a + spill[:, i]
    return old[:, i] + fac[i] * a


def _invalid(qn):
    return int((~torch.isfinite(qn)).sum() + (qn[0] < 0).sum()
               + (qn[4] < 0).sum())


def walk_shift(sh, nc, q, old, fac, spill=None):
    """shift_fused_stage.cu's schedule, block by block and step by step."""
    sch, n, B, H = sh.schedule, sh.num_nodes, TILE_NODES, sh.schedule.halo
    march = sch.kinds.index(MARCHED) if MARCHED in sch.kinds else None
    out = torch.full_like(q, float("nan"))
    writes = torch.zeros(n, dtype=torch.int64)
    bad = 0
    t = torch.arange(B)
    for b in range(sch.blocks):
        r0 = (b % sch.pencils) * B
        s0 = (b // sch.pencils) * sch.chunk
        in_pencil = r0 + t < sch.stride
        prev = None
        for s in range(s0, min(s0 + sch.chunk, sch.steps)):
            base = r0 + s * sch.stride
            if base >= n:
                break
            i = base + t
            own = in_pencil & (i < n)
            win = _states(q, torch.arange(base - H, base + B + H))
            qi = _cut(win, H, H + B)
            if march is not None:
                dm = sh.deltas[march]
                ahead = _states(q, i + dm)
                if s == s0:
                    prev = _edge(_states(q, i - dm), qi,
                                 _weights(sh.w[march], i - dm))
            acc = torch.zeros((5, B), dtype=q.dtype)
            for k, d in enumerate(sh.deltas):
                if sch.kinds[k] == HALO:
                    vals = _edge(_cut(win, H - d, H + B),
                                 _cut(win, H, H + B + d),
                                 _weights(sh.w[k], torch.arange(base - d,
                                                                base + B)))
                    a, bv = vals[:, d:], vals[:, :B]
                elif sch.kinds[k] == MARCHED:
                    a = _edge(qi, ahead, _weights(sh.w[k], i))
                    bv, prev = prev, a
                else:
                    a = _edge(qi, _states(q, i + d), _weights(sh.w[k], i))
                    bv = _edge(_states(q, i - d), qi,
                               _weights(sh.w[k], i - d))
                acc = (acc + a) - bv
            io = i[own]
            qn = _update([x[own] for x in qi], acc[:, own], nc, old, fac,
                         spill, io)
            out[:, io] = qn
            writes[io] += 1
            bad += _invalid(qn)
    assert bool((writes == 1).all()), "a node written other than once"
    return out, bad


def walk_csr(csr, nc, q, old, fac, chunk):
    """fused_stage.cu's schedule, tile by tile and chunk by chunk; the
    window holds the tile's own nodes."""
    n, B = csr.num_rows, TILE_ROWS
    rp = csr.row_ptr.to(torch.int64)
    col = csr.col.to(torch.int64)
    out = torch.full_like(q, float("nan"))
    bad = 0
    for r0, r1, chunks in row_tiles(rp.numpy(), chunk):
        win = _states(q, torch.arange(r0, r0 + B))
        W = B
        # each entry's row within the tile, as the rows' threads mark them
        row_of = torch.repeat_interleave(torch.arange(r1 - r0),
                                         rp[r0 + 1:r1 + 1] - rp[r0:r1])
        e0 = int(rp[r0])
        acc = torch.zeros((5, r1 - r0), dtype=q.dtype)
        for c0, c1 in chunks:
            h = torch.arange(c0, c1)
            j = col[h]
            pj = j - r0
            inwin = (pj >= 0) & (pj < W)
            from_win = [x[pj.clamp(0, W - 1)] for x in win]
            from_q = complete8(q[:, j])
            qn = [torch.where(inwin, a, b) for a, b in zip(from_win, from_q)]
            o = row_of[c0 - e0:c1 - e0]
            qo = [x[o] for x in win]
            v = flux_math(qo, qn, csr.w[0, h], csr.w[1, h], csr.w[2, h],
                          csr.w[3, h])
            acc.index_add_(1, o, v)
        i = torch.arange(r0, r1)
        qn = _update(_cut(win, 0, r1 - r0), acc, nc, old, fac, None, i)
        out[:, i] = qn
        bad += _invalid(qn)
    return out, bad


def _equal(got, want):
    return torch.equal(torch.isnan(got), torch.isnan(want)) and \
        torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("with_spill", [False, True])
def test_shift_walk_equals_the_plain_version(level, with_spill):
    _, lvl, plan = level
    n = lvl.num_nodes
    sh = DeviceShift.from_plan(plan, n, "cpu", torch.float64)
    nc, q, old, fac, spill = _operands(lvl)
    spill = spill if with_spill else None
    got, got_bad = walk_shift(sh, nc, q, old, fac, spill)
    want, want_bad = shift.shift_fused_stage_plain(sh, nc, q, old, fac,
                                                   spill)
    assert _equal(got, want)
    assert got_bad == int(want_bad) > 0


@pytest.mark.parametrize("chunk", [CHUNK_ENTRIES[torch.float64], 7])
def test_csr_walk_equals_the_plain_version(level, chunk):
    _, lvl, _ = level
    csr = DeviceCSR.from_plan(build_flux_csr(lvl), "cpu", torch.float64)
    nc, q, old, fac, _ = _operands(lvl)
    want, want_bad = fused_stage_plain(csr, nc, q, old, fac)
    got, got_bad = walk_csr(csr, nc, q, old, fac, chunk)
    assert _equal(got, want)
    assert got_bad == int(want_bad) > 0
