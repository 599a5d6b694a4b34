"""The fused window stage's stored primitives (kernels/fused_stage.py
primitives, solver._primitive_chain): the step factor's first pass and
the first two RK stages store each node's 1/rho and speed + speed of
sound of the state they read or write, and each fused stage gathers them
in place of a divide and two square roots per CSR entry.

On the CPU the wrappers take the plain versions: gather_sectors, the
locality a level must have to get its buffers, against a loop, and the
levels that get them; window cycles that
gather the primitives equal the cycles that complete every node, bit for
bit, at float64, float32 and bfloat16 on a small RCM tet and RCM boxes
(the legacy step factor's FVCORR box among them, whose first stage reads
none), with and without invalid values planted; each stage reads what
the step factor or the stage before it stored, never the buffer it
writes; the operand checks; the sharded solver's block levels have no
buffers, and its replicated levels give the same bits with and without
theirs.

The test marked `card` holds the buffers' addresses across a CUDA
graph's capture and replays; it skips without a card (this file imports
no JAX):

    python -m pytest --noconftest -q -m card tests/test_torch_primitives.py
"""
import numpy as np
import pytest
import torch

import sharded_ranks as ranks
from mgcfd_tpu_torch import kernels
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import RK, MeshVariant
from mgcfd_tpu_torch.kernels import DeviceCSR, boundary_rows
from mgcfd_tpu_torch.core.types import MultigridMesh
from mgcfd_tpu_torch.kernels import fused_stage as fused_stage_mod
from mgcfd_tpu_torch.kernels.fused_stage import (GATHER_FOOTPRINT_MAX,
                                                 GATHER_SECTORS_MAX,
                                                 fused_stage,
                                                 gather_footprint,
                                                 gather_sectors,
                                                 primitive_buffers,
                                                 primitives)
from mgcfd_tpu_torch.monitor.costs import (FLUX_OPS_PER_ROW, PRIMITIVE_OPS,
                                           fused_stage_cost)
from mgcfd_tpu_torch.mesh import (generate_multigrid_box,
                                  generate_unstructured_hierarchy)
from mgcfd_tpu_torch.prep.csr import build_flux_csr
from mgcfd_tpu_torch.prep.renumber import (apply_node_order,
                                           renumber_hierarchy)
from mgcfd_tpu_torch.solver import MGCFDSolver, solver as solver_mod

DTYPES = (torch.float64, torch.float32, torch.bfloat16)
NAMES = {torch.float32: "float32", torch.float64: "float64",
         torch.bfloat16: "bfloat16"}
BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}
H = (0.1, 0.1, 0.1)


def same(a, b) -> bool:
    """Equal dtype, shape and bits, a NaN equal to any NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    bits = BITS[a.element_size()]
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(bits), b[~nan].view(bits))


@pytest.fixture(scope="module")
def meshes():
    return {
        "tet": renumber_hierarchy(generate_unstructured_hierarchy(
            9, 8, 9, 2, seed=3)),
        "box": renumber_hierarchy(generate_multigrid_box(
            9, 8, 10, 3, h=H, volume_jitter=0.2)),
        "fvcorr": renumber_hierarchy(generate_multigrid_box(
            9, 8, 10, 2, h=H, volume_jitter=0.2,
            variant=MeshVariant.FVCORR)),
    }


def window_solver(mesh, dtype) -> MGCFDSolver:
    """The window path from a state scaled per node by 1 + 0.01 sin(i),
    so that no two nodes share their primitives."""
    s = MGCFDSolver(mesh, SolverConfig(dtype=NAMES[dtype],
                                       accumulate="window"), device="cpu")
    for v in s.state["variables"]:
        i = torch.arange(v.shape[1], dtype=torch.float64)
        v.mul_((1.0 + 0.01 * torch.sin(i)).to(v.dtype)[None])
    return s


def cycles(s: MGCFDSolver, k: int):
    """k cycles from a copy of s's state: [(rms, invalid)], the state."""
    start = {key: [t.clone() for t in v] for key, v in s.state.items()}
    got = [s.cycle() for _ in range(k)]
    out = (got, {key: list(v) for key, v in s.state.items()})
    s.state = start
    return out


# --- on the CPU: the plain versions ------------------------------------------

@pytest.mark.parametrize("plant", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: NAMES[d])
@pytest.mark.parametrize("kind", ["tet", "box", "fvcorr"])
def test_gathered_cycles_equal_the_completed(meshes, kind, dtype, plant):
    """Three cycles with every window level's buffers (each of these
    levels gets them) against three with none (every node completed at
    every entry): each level's state and residual, each cycle's RMS and
    invalid count, bit for bit."""
    s = window_solver(meshes[kind], dtype)
    assert all(lvl.prims is not None for lvl in s.dmesh.levels)
    if plant:
        v0 = s.state["variables"][0]
        v0[4, v0.shape[1] // 3] = -1.0
    (got, got_state) = cycles(s, 3)
    for lvl in s.dmesh.levels:
        lvl.prims = None
    (want, want_state) = cycles(s, 3)
    for (rms, inv), (rms_w, inv_w) in zip(got, want):
        assert same(rms, rms_w) and int(inv) == int(inv_w)
        assert (int(inv) > 0) == plant
    for key in ("variables", "residuals"):
        for lev, (a, b) in enumerate(zip(got_state[key], want_state[key])):
            assert same(a, b), (key, lev)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: NAMES[d])
@pytest.mark.parametrize("kind", ["tet", "box", "fvcorr"])
def test_each_stage_reads_what_the_launch_before_it_stored(
        meshes, kind, dtype, monkeypatch):
    """Every visit of a cycle: the step factor's first pass stores q's
    primitives into the level's first buffer (none under the legacy step
    factor), stage 1 reads them and stores its output's into the second,
    stage 2 reads those and stores into the first, stage 3 reads them
    and stores none; what each stage reads is its input's primitives,
    bit for bit, and never the buffer it writes."""
    s = window_solver(meshes[kind], dtype)
    legacy = s.dmesh.variant.uses_legacy_step_factor
    calls = []
    step, stage = kernels.step_factor.step_factor, solver_mod.fused_stage

    def step_spy(q, volumes, cbrt_volumes, legacy, scratch=None,
                 prims_out=None):
        out = step(q, volumes, cbrt_volumes, legacy, scratch, prims_out)
        if prims_out is not None:
            assert same(prims_out, primitives(q))
        calls.append(("step", None, prims_out))
        return out

    def stage_spy(csr, bnd, q, *args, prims_in=None, prims_out=None,
                  **kw):
        if prims_in is not None:
            assert same(prims_in, primitives(q))
            assert prims_out is None or prims_out is not prims_in
        out = stage(csr, bnd, q, *args, prims_in=prims_in,
                    prims_out=prims_out, **kw)
        if prims_out is not None:
            assert same(prims_out, primitives(out[0]))
        calls.append((csr, prims_in, prims_out))
        return out

    monkeypatch.setattr(kernels.step_factor, "step_factor", step_spy)
    monkeypatch.setattr(solver_mod, "fused_stage", stage_spy)
    s.cycle()
    L = len(s.dmesh.levels)
    visits = [*range(L), *range(L - 2, 0, -1)]
    assert len(calls) == (RK + 1) * len(visits)
    for v, lev in enumerate(visits):
        a, b = s.dmesh.levels[lev].prims
        got = calls[(RK + 1) * v:(RK + 1) * (v + 1)]
        assert got[0][2] is (None if legacy else a)
        assert all(c[0] is s.dmesh.levels[lev].csr for c in got[1:])
        for c, (reads, stores) in zip(got[1:], [(got[0][2], b), (b, a),
                                                 (a, None)]):
            assert c[1] is reads and c[2] is stores, (lev, c)


def test_only_the_fused_window_stage_has_buffers(meshes):
    """The buffers: (2, N) in the compute type, two a level, distinct, on
    the fused window path (where gathers_primitives holds); none unfused
    or on the span paths."""
    mesh = meshes["box"]
    s = MGCFDSolver(mesh, SolverConfig(dtype="bfloat16",
                                       accumulate="window"), device="cpu")
    for lvl in s.dmesh.levels:
        a, b = lvl.prims
        for t in (a, b):
            assert t.shape == (2, lvl.num_nodes) and t.dtype == torch.float32
        assert a.data_ptr() != b.data_ptr()
    for cfg in (dict(accumulate="window", fuse_window_stage=False),
                dict(accumulate="pallas"), dict(accumulate="segment")):
        s = MGCFDSolver(mesh, SolverConfig(dtype="float32", **cfg),
                        device="cpu")
        assert all(lvl.prims is None for lvl in s.dmesh.levels), cfg


def test_gather_sectors_counts_each_warp_loads_sectors():
    """gather_sectors against a loop: 32 consecutive entries a load, the
    neighbours outside the owner's 128-row tile, by 32-byte sectors of
    the compute type (8 nodes at float32 and bfloat16, 4 at float64)."""
    rng = np.random.default_rng(5)
    n, h = 1000, 3000
    owner = np.sort(rng.integers(0, n, h))
    col = np.where(rng.random(h) < 0.5, owner + rng.integers(-20, 20, h),
                   rng.integers(0, n, h)).clip(0, n - 1)
    row_ptr = np.searchsorted(owner, np.arange(n + 1))
    for dtype, nodes in ((torch.float32, 8), (torch.bfloat16, 8),
                         (torch.float64, 4)):
        csr = DeviceCSR(num_rows=n, num_cols=n,
                        row_ptr=torch.as_tensor(row_ptr, dtype=torch.int32),
                        col=torch.as_tensor(col, dtype=torch.int32),
                        owner=torch.as_tensor(owner),
                        w=torch.zeros((4, h), dtype=dtype))
        want = [len({c // nodes for c, o in zip(col[g:g + 32],
                                                owner[g:g + 32])
                     if c // 128 != o // 128}) for g in range(0, h, 32)]
        assert gather_sectors(csr) == pytest.approx(np.mean(want))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: NAMES[d])
def test_levels_gather_where_their_neighbours_lie_close(meshes, dtype,
                                                        monkeypatch):
    """A level gets its buffers where gather_sectors is at most
    GATHER_SECTORS_MAX of its dtype or its state and primitives take at
    most GATHER_FOOTPRINT_MAX bytes: the RCM box's levels by their
    sectors, the same box level with its nodes in a random order by its
    size alone, and with no footprint allowed not at all."""
    box = meshes["box"].levels[0]
    order = np.random.default_rng(1).permutation(box.num_nodes)
    scattered = MultigridMesh(levels=[apply_node_order(box, order)],
                              variant=MeshVariant.M6_WING)
    for footprint in (GATHER_FOOTPRINT_MAX, 0):
        monkeypatch.setattr(fused_stage_mod, "GATHER_FOOTPRINT_MAX",
                            footprint)
        for mesh, close in ((meshes["box"], True), (scattered, False)):
            s = MGCFDSolver(mesh, SolverConfig(dtype=NAMES[dtype],
                                               accumulate="window"),
                            device="cpu")
            for lvl in s.dmesh.levels:
                small = gather_footprint(lvl.csr) <= footprint
                assert (gather_sectors(lvl.csr)
                        <= GATHER_SECTORS_MAX[dtype]) == close
                assert small == (footprint > 0)
                assert (lvl.prims is not None) == (close or small)


def test_primitive_operands_are_checked(meshes):
    lvl = meshes["tet"].levels[0]
    n = lvl.num_nodes
    csr = DeviceCSR.from_plan(build_flux_csr(lvl), "cpu", torch.bfloat16)
    nc = boundary_rows(torch.zeros((11, n), dtype=torch.bfloat16))
    q = torch.ones((5, n), dtype=torch.bfloat16)
    fac = torch.full((n,), 1e-3, dtype=torch.bfloat16)
    good = torch.zeros((2, n))
    for bad in (torch.zeros((2, n), dtype=torch.bfloat16),
                torch.zeros((2, n - 1)), torch.zeros((n, 2)).T):
        for key in ("prims_in", "prims_out"):
            with pytest.raises(ValueError, match=key):
                fused_stage(csr, nc, q, q, fac, **{key: bad})
    with pytest.raises(ValueError, match="must not be the buffer"):
        fused_stage(csr, nc, q, q, fac, prims_in=good, prims_out=good)
    vol = torch.ones(n, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="legacy"):
        kernels.step_factor.step_factor(q, vol, vol, True, prims_out=good)
    out = fused_stage(csr, nc, q, q, fac, prims_in=primitives(q),
                      prims_out=good)[0]
    assert same(good, primitives(out))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: NAMES[d])
def test_the_stage_cost_counts_the_primitive_operands(meshes, dtype):
    """monitor/costs.py fused_stage_cost: each buffer given adds its
    (2, N) compute-type bytes; gathering takes PRIMITIVE_OPS off every
    completion (each entry's neighbour and each row's own), storing adds
    a completion a row."""
    lvl = meshes["tet"].levels[0]
    n = lvl.num_nodes
    csr = DeviceCSR.from_plan(build_flux_csr(lvl), "cpu", dtype)
    bnd = boundary_rows(torch.zeros((11, n), dtype=dtype))
    sz = torch.empty((), dtype=dtype).element_size()
    a, b = primitive_buffers(n, dtype, "cpu")
    nbytes, ops = fused_stage_cost(csr, bnd, sz)
    for kw, more, fewer in (({"prims_in": a}, 1, csr.num_entries + n),
                            ({"prims_out": b}, 1, 0),
                            ({"prims_in": a, "prims_out": b}, 2,
                             csr.num_entries + n)):
        got_bytes, got_ops = fused_stage_cost(csr, bnd, sz, **kw)
        assert got_bytes - nbytes == more * 2 * n * a.element_size()
        stored = FLUX_OPS_PER_ROW * n if "prims_out" in kw else 0
        assert got_ops - ops == stored - PRIMITIVE_OPS * fewer


def test_sharded_block_levels_have_no_buffers(tmp_path):
    """ShardedSolver on the window path over 2 gloo ranks: its block
    level reads none, its replicated level has them, and the run gives
    the same bits without them."""
    mesh = generate_unstructured_hierarchy(11, 10, 10, 2, seed=3)
    out = tmp_path / "prims.npz"
    ranks.launch(ranks.primitive_buffers, 2, mesh,
                 dict(dtype="float64", accumulate="window",
                      num_partitions=2), 2, str(out))
    got = ranks.load(out)
    assert list(got["has_buffers"]) == [False, True]
    for lev in range(mesh.num_levels):
        assert np.array_equal(got[f"with{lev}"], got[f"without{lev}"],
                              equal_nan=True), lev
    assert np.array_equal(got["rms_with"], got["rms_without"])


# --- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run there with python -m pytest "
                    "--noconftest -m card tests/test_torch_primitives.py")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: NAMES[d])
def test_buffers_keep_their_addresses_through_the_graph(card, meshes,
                                                        dtype):
    """run_batched's CUDA graph captures launches that name each level's
    two buffers: after the capture and replays they are the same tensors
    at the same addresses, hold the primitives of what the last stages
    stored, and the replays equal eager cycles bit for bit."""
    mesh = renumber_hierarchy(generate_unstructured_hierarchy(
        24, 24, 24, 3, seed=3))
    s = MGCFDSolver(mesh, SolverConfig(dtype=NAMES[dtype],
                                       accumulate="window"), device=card)
    gathering = [lvl for lvl in s.dmesh.levels if lvl.prims is not None]
    assert gathering
    before = [(lvl.prims, [t.data_ptr() for t in lvl.prims])
              for lvl in gathering]
    start = {key: [t.clone() for t in v] for key, v in s.state.items()}
    kernels.reset_launch_counts()
    s.run_batched(6, 3)
    torch.cuda.synchronize()
    for lvl, (bufs, ptrs) in zip(gathering, before):
        assert lvl.prims is bufs
        assert [t.data_ptr() for t in lvl.prims] == ptrs
    # each buffer holds what a stage or the step factor stored
    for lvl in gathering:
        assert all(torch.isfinite(t).all() for t in lvl.prims)
    assert s._graph is not None
    got = {key: list(v) for key, v in s.state.items()}
    s.state = start
    for _ in range(6):
        s.cycle()
    torch.cuda.synchronize()
    for key in ("variables", "residuals"):
        for lev, (a, b) in enumerate(zip(got[key], s.state[key])):
            assert same(a, b), (key, lev)
