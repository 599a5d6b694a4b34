"""The cycle's updates as kernel epilogues (kernels/fused_stage.py,
kernels/shift.py, kernels/edge_csr.py, solver/solver.py): the fused
stages' residual and invalid count, the restriction's kept coarse state
and the prolongation's update of the fine state, each stored by the
kernel that holds its operands, in place of the eager PyTorch ops that
took them around the kernel before.

On the CPU the wrappers take the plain versions: each epilogue equals the
eager composition it replaces, bit for bit, at float32, float64 and
bfloat16 (the residual; the restriction, with coarse rows that no fine
node maps to; the prolongation; the invalid count, on states seeded with
NaN, Inf, rho < 0 and E < 0); the restriction plan's `mapped` is its rows
with entries; K = 3 cycles of the window and span paths on a small RCM
box equal the eager composition's; the counters epilogue.*; the operand
checks; the cost model.

The tests marked `card` hold each kernel with its epilogue to the same
kernel without it followed by the eager ops, bit for bit (NaN equal to
NaN), on M6-size levels 0-3 at float32, float64 and bfloat16: both fused
stages, every wsum shape; three cycles of the window path against the
eager composition; the counters over run_batched; at most 6 plain-PyTorch
kernels in a captured window-path cycle. They skip without a card; on
the card (this file imports no JAX):

    python -m pytest --noconftest -q -m card tests/test_torch_epilogue.py
"""
import types

import numpy as np
import pytest
import torch

from mgcfd_tpu_torch import kernels
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import RK, MeshVariant, far_field_state
from mgcfd_tpu_torch.core.types import MultigridMesh
from mgcfd_tpu_torch.kernels import (DeviceCSR, DeviceShift, build,
                                     edge_csr, shift)
from mgcfd_tpu_torch.kernels.fused_stage import fused_stage
from mgcfd_tpu_torch.mesh.generate import (generate_box_mesh,
                                           generate_multigrid_box)
from mgcfd_tpu_torch.monitor import costs
from mgcfd_tpu_torch.ops import calc_rms, tops
from mgcfd_tpu_torch.prep.csr import (build_flux_csr, build_prolong_csr,
                                      build_restrict_csr)
from mgcfd_tpu_torch.prep.renumber import renumber_hierarchy
from mgcfd_tpu_torch.prep.shift import build_shift_plan
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.solver.solver import t_indirect_rw, t_stage_factors
from mgcfd_tpu_torch.utils import spans

DTYPES = (torch.float32, torch.float64, torch.bfloat16)
NAMES = {torch.float32: "float32", torch.float64: "float64",
         torch.bfloat16: "bfloat16"}
BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}
STAGES = ("window", "span", "span+spill")


@pytest.fixture(autouse=True)
def clean_counts():
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


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


def state(n: int, dtype, device="cpu", seed: int = 0, plant=False):
    """The far field scaled per node and channel by 1 + 0.05 u, (5, n);
    with plant, a NaN, an Inf, a negative density and a negative energy
    at four nodes."""
    rng = np.random.default_rng(seed)
    q = far_field_state(np.float64)[0][:, None] \
        * (1.0 + 0.05 * rng.uniform(-1, 1, (5, n)))
    if plant:
        q[1, n // 7] = np.nan
        q[3, n // 5] = np.inf
        q[0, n // 3] = -2.0
        q[4, n // 2] = -2.0
    return torch.as_tensor(q).to(device, dtype)


def noise(shape, dtype, device="cpu", seed: int = 0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape)).to(device, dtype)


def stage_call(kind: str, lv, dtype, device="cpu"):
    """One fused stage of a level as the visits launch it: fn(q, old, fac,
    count=None, residual=False) and nc; window: fused_stage over the
    level's flux CSR; span: shift.fused_stage over its span plan, with a
    spill operand in 'span+spill'."""
    n = lv.num_nodes
    bdn, wln, wlc = tops.build_dense_boundary_wall(
        n, lv.bedge_b, lv.bedge_w, lv.wedge_b, lv.wedge_w,
        far_field_state(np.float64)[1])
    nc = torch.as_tensor(np.concatenate([bdn, wln, wlc])).to(device, dtype)
    if kind == "window":
        csr = DeviceCSR.from_plan(build_flux_csr(lv), device, dtype)
        return lambda q, old, fac, **epi: fused_stage(csr, nc, q, old, fac,
                                                      **epi)
    sh = DeviceShift.from_plan(build_shift_plan(lv), n, device, dtype)
    spill = 1e-3 * noise((5, n), dtype, device, seed=5) \
        if kind == "span+spill" else None
    return lambda q, old, fac, **epi: shift.fused_stage(sh, nc, q, old, fac,
                                                        spill, **epi)


def visit_both_ways(run, q0, fac):
    """The three stages of a visit from q0 (old = q0): as the solver
    composed them before the epilogues (each stage's count added to an
    int64, then q - old), and with them. Returns ((q, res, count) eager,
    (q, res, count) through the epilogues)."""
    total = torch.zeros((), dtype=torch.int64, device=q0.device)
    q = q0
    for _ in range(RK):
        q, inv = run(q, q0, fac)
        total = total + inv
    eager = (q, q - q0, total)
    count = torch.zeros((), dtype=torch.int64, device=q0.device)
    p = q0
    for j in range(RK):
        out = run(p, q0, fac, count=count, residual=j == RK - 1)
        assert out[1] is count
        p = out[0]
    return eager, (p, out[2], count)


# --- on the CPU: the plain versions ------------------------------------------

@pytest.fixture(scope="module")
def box():
    return generate_multigrid_box(6, 5, 7, 2, h=(0.1, 0.1, 0.1))


@pytest.mark.parametrize("plant", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", STAGES)
def test_stage_epilogues_equal_the_eager_ops(box, kind, dtype, plant):
    """The residual and the count of both fused stages' plain versions:
    the state as without them, the residual the eager q - old, the count
    the sum of the stages' counts, with invalid values planted too."""
    lv = box.levels[0]
    run = stage_call(kind, lv, dtype)
    q0 = state(lv.num_nodes, dtype, plant=plant)
    fac = 1e-3 * (1 + noise((lv.num_nodes,), dtype, seed=2).abs())
    (q, res, total), (p, got_res, count) = visit_both_ways(run, q0, fac)
    assert same(p, q) and same(got_res, res)
    assert int(count) == int(total)
    if plant:
        assert int(total) >= 4 * RK
    else:
        assert int(total) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_count_adds_to_what_the_counter_holds(box, dtype):
    lv = box.levels[0]
    run = stage_call("window", lv, dtype)
    q = state(lv.num_nodes, dtype, plant=True)
    fac = torch.full((lv.num_nodes,), 1e-3, dtype=dtype)
    _, inv = run(q, q, fac)
    count = torch.full((1,), 7, dtype=torch.int64)
    out, got = run(q, q, fac, count=count)
    assert got is count and int(count) == 7 + int(inv) and int(inv) >= 4
    assert inv.dtype == torch.int64 and inv.shape == (1,)
    assert out.dtype == dtype


def restriction_with_orphans(nf: int, nc: int, orphans, seed: int = 3):
    """A restriction plan whose mapping takes every coarse id but those of
    `orphans`, in a seeded order."""
    rng = np.random.default_rng(seed)
    ids = np.setdiff1d(np.arange(nc), np.asarray(orphans))
    return build_restrict_csr(rng.permutation(np.resize(ids, nf)), nf, nc)


def test_mapped_is_the_rows_with_entries(box):
    """apply_restrict's store reads no mask: the plan's `mapped` is
    exactly its rows with entries, on the solver's plans and with coarse
    nodes that no fine node maps to."""
    plans = [build_restrict_csr(f.mg_mapping, f.num_nodes, c.num_nodes)
             for f, c in zip(box.levels, box.levels[1:])]
    plans.append(restriction_with_orphans(200, 40, [0, 17, 39]))
    for plan, mapped in plans:
        assert np.array_equal(mapped, np.diff(plan.row_ptr) > 0)
    assert int((~plans[-1][1]).sum()) == 3


@pytest.mark.parametrize("dtype", DTYPES)
def test_restriction_keeps_the_rows_no_child_maps_to(dtype):
    plan, mapped = restriction_with_orphans(200, 40, [0, 17, 39])
    csr = DeviceCSR.from_plan(plan, "cpu", dtype)
    x = noise((5, 200), dtype, seed=1)
    vc = noise((5, 40), dtype, seed=2)
    mask = torch.as_tensor(mapped)
    want = torch.where(mask[None], edge_csr.restrict(csr, x), vc)
    got = edge_csr.restrict(csr, x, keep=vc)
    assert same(got, want)
    assert same(got[:, ~mask], vc[:, ~mask])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prolongation_update_equals_the_eager_ops(box, dtype):
    fine, coarse = box.levels
    csr = DeviceCSR.from_plan(build_prolong_csr(fine, coarse), "cpu", dtype)
    n = fine.num_nodes
    rc = 1e-2 * noise((5, coarse.num_nodes), dtype, seed=1)
    rf = 1e-2 * noise((5, n), dtype, seed=2)
    vf = state(n, dtype, seed=3)
    want = vf + (rf - edge_csr.prolong(csr, rc))
    assert same(edge_csr.prolong(csr, rc, correct=(vf, rf)), want)


def eager_cycle(s: MGCFDSolver, mapped):
    """MGCFDSolver.cycle on the window or span path as it was composed
    before the epilogues: each visit's int64 adds of the stages' counts
    and its q - old, the restriction's torch.where of the mask
    (mapped[lev], level lev + 1's nodes with a child) and the
    prolongation's two eager ops around the kernels. Returns (rms,
    invalid count)."""
    levels = s.dmesh.levels
    L = len(levels)
    legacy = s.dmesh.variant.uses_legacy_step_factor
    variables, residuals = s.state["variables"], s.state["residuals"]
    window = s.config.accumulate == "window"
    total = torch.zeros((), dtype=torch.int64, device=s.device)

    def visit(lev):
        nonlocal total
        lvl = levels[lev]
        q = old = variables[lev]
        fac = t_stage_factors(lvl, q, legacy)
        invalid = torch.zeros((), dtype=torch.int64, device=s.device)
        for j in range(RK):
            if window:
                q, inv = fused_stage(lvl.csr, lvl.nc, q, old, fac[j])
            else:
                spill = (None if lvl.spill_csr is None
                         else edge_csr.flux(lvl.spill_csr, q))
                q, inv = shift.fused_stage(lvl.shift, lvl.nc, q, old,
                                           fac[j], spill)
            invalid = invalid + inv
            t_indirect_rw(lvl, q, s.config)
        variables[lev], residuals[lev] = q, q - old
        total = total + invalid

    rms = None
    for lev in range(L - 1):
        visit(lev)
        if lev == 0:
            rms = calc_rms(residuals[0], levels[0].num_nodes)
        mean = edge_csr.restrict(levels[lev].restrict_csr, variables[lev])
        variables[lev + 1] = torch.where(mapped[lev][None], mean,
                                         variables[lev + 1])
    visit(L - 1)
    for lev in range(L - 2, -1, -1):
        variables[lev] = variables[lev] + (residuals[lev] - edge_csr.prolong(
            levels[lev].prolong_csr, residuals[lev + 1]))
        if lev > 0:
            visit(lev)
    return rms, total


def mapped_masks(mesh: MultigridMesh, device):
    return [torch.as_tensor(np.bincount(f.mg_mapping, minlength=c.num_nodes)
                            > 0).to(device)
            for f, c in zip(mesh.levels, mesh.levels[1:])]


def perturb(s: MGCFDSolver, plant: bool) -> None:
    """Scale every level's state per node by 1 + 0.01 sin(i); with plant,
    a negative energy at one node of level 0."""
    for v in s.state["variables"]:
        i = torch.arange(v.shape[1], device=v.device, dtype=torch.float64)
        v.mul_((1.0 + 0.01 * torch.sin(i)).to(v.dtype)[None])
    if plant:
        v0 = s.state["variables"][0]
        v0[4, v0.shape[1] // 3] = -1.0


def cycles_both_ways(s: MGCFDSolver, mesh, k: int):
    """k cycles of s from its state through the epilogues, then k through
    eager_cycle from the same state: ((rms, invalid) each cycle, states)
    for each."""
    start = {key: [t.clone() for t in v] for key, v in s.state.items()}
    out = []
    for step in (s.cycle, lambda: eager_cycle(s, mapped_masks(
            mesh, s.device))):
        s.state = {key: [t.clone() for t in v] for key, v in start.items()}
        got = [step() for _ in range(k)]
        out.append((got, {key: list(v) for key, v in s.state.items()}))
    return out


@pytest.mark.parametrize("plant", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("accumulate", ["window", "pallas"])
def test_cycles_equal_the_eager_composition(accumulate, dtype, plant):
    """K = 3 cycles on a small RCM box: every level's state and residual,
    each cycle's RMS and invalid count as the eager composition's."""
    mesh = renumber_hierarchy(generate_multigrid_box(7, 6, 8, 3,
                                                     h=(0.1, 0.1, 0.1)))
    s = MGCFDSolver(mesh, SolverConfig(dtype=NAMES[dtype],
                                       accumulate=accumulate), device="cpu")
    perturb(s, plant)
    (got, got_state), (want, want_state) = cycles_both_ways(s, mesh, 3)
    for (rms, inv), (rms_w, inv_w) in zip(got, want):
        assert same(rms, rms_w) and int(inv) == int(inv_w)
        assert (int(inv) > 0) == plant
    for key in ("variables", "residuals"):
        for a, b in zip(got_state[key], want_state[key]):
            assert same(a, b), key


class FakeLibrary:
    """Every C entry point on the host: a launch does nothing, a shape
    query answers a thread a row with plain loads."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def host_launches(monkeypatch):
    monkeypatch.setattr(build, "library", lambda: FakeLibrary())
    monkeypatch.setattr(edge_csr, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))


def test_launches_count_the_epilogues_they_carry(box, host_launches):
    fine, coarse = box.levels
    n, m = fine.num_nodes, coarse.num_nodes
    run = stage_call("window", fine, torch.float64)
    span = stage_call("span", fine, torch.float64)
    q = state(n, torch.float64)
    fac = torch.full((n,), 1e-3, dtype=torch.float64)
    count = torch.zeros((), dtype=torch.int64)
    run(q, q, fac)
    run(q, q, fac, count=count)
    run(q, q, fac, count=count, residual=True)
    span(q, q, fac, count=count, residual=True)
    plan, _ = build_restrict_csr(fine.mg_mapping, n, m)
    rcsr = DeviceCSR.from_plan(plan, "cpu", torch.float64)
    pcsr = DeviceCSR.from_plan(build_prolong_csr(fine, coarse), "cpu",
                               torch.float64)
    vc, rc = state(m, torch.float64), state(m, torch.float64)
    edge_csr.restrict(rcsr, q)
    edge_csr.restrict(rcsr, q, keep=vc)
    edge_csr.restrict.at(rcsr, q, edge_csr.WsumShape(True, edge_csr.PLAIN),
                         keep=vc)
    edge_csr.prolong(pcsr, rc, correct=(q, q))
    want = {"residual": 2, "restrict": 2, "prolong": 1, "invalid": 3}
    assert spans.counters("epilogue.") == want
    assert kernels.launch_counts()["fused_stage"] == 3
    capture = kernels.launch_counts(shapes=True)
    assert not any(k.startswith("epilogue.")
                   for k in kernels.launch_counts())
    assert {k: n for k, n in capture.items() if k.startswith("epilogue.")} \
        == {f"epilogue.{k}": n for k, n in want.items()}
    # what a replay of a CUDA graph of this capture adds
    kernels.add_launch_counts(capture)
    assert spans.counters("epilogue.") == {k: 2 * v for k, v in
                                           want.items()}
    assert kernels.launch_counts()["edge_csr.wsum.restrict"] == 6
    kernels.reset_launch_counts()
    assert not any(spans.counters("epilogue.").values())


def test_epilogue_operands_are_checked(box):
    fine, coarse = box.levels
    n, m = fine.num_nodes, coarse.num_nodes
    run = stage_call("window", fine, torch.float32)
    q = state(n, torch.float32)
    fac = torch.full((n,), 1e-3)
    for bad in (torch.zeros((), dtype=torch.int32),
                torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(ValueError, match="count"):
            run(q, q, fac, count=bad)
    csr = DeviceCSR.from_plan(build_flux_csr(fine), "cpu", torch.float32)
    with pytest.raises(ValueError, match="wsum mode only"):
        edge_csr.rw(csr, q, keep=q)
    plan, _ = build_restrict_csr(fine.mg_mapping, n, m)
    rcsr = DeviceCSR.from_plan(plan, "cpu", torch.float32)
    vc = state(m, torch.float32)
    with pytest.raises(ValueError, match="not both"):
        edge_csr.restrict(rcsr, q, keep=vc, correct=(vc, vc))
    for bad in (vc[:, 1:], vc.double(), vc.T.contiguous().T):
        with pytest.raises(ValueError, match="epilogue operand"):
            edge_csr.restrict(rcsr, q, keep=bad)
    with pytest.raises(ValueError, match="epilogue operand"):
        edge_csr.prolong(rcsr, q, correct=(vc, vc[:, :3]))


def test_costs_count_the_epilogues(box):
    """The transfers' costs with their epilogues: the kept state's reads
    on the restriction's rows with no entries, the prolongation's reads
    of the fine state and residual and its two operations an element."""
    fine, coarse = box.levels
    n = fine.num_nodes
    plan, _ = restriction_with_orphans(200, 40, [0, 17, 39])
    rcsr = DeviceCSR.from_plan(plan, "cpu", torch.float32)
    base = costs.edge_csr_cost("wsum", rcsr, 4)
    assert costs.wsum_cost(rcsr, 4, keep=True) == (base[0] + 4 * 5 * 3,
                                                  base[1])
    pcsr = DeviceCSR.from_plan(build_prolong_csr(fine, coarse), "cpu",
                               torch.float32)
    base = costs.edge_csr_cost("wsum", pcsr, 4)
    assert costs.wsum_cost(pcsr, 4, correct=True) == (
        base[0] + 4 * 10 * n, base[1] + 10 * n)


# --- on the card --------------------------------------------------------------

# the levels of the benchmark's M6 configurations (cfdbench/configs/m6*.json):
# 304,640 / 165,984 / 110,400 / 81,180 nodes
M6_DIMS = ((68, 64, 70), (56, 52, 57), (48, 46, 50), (44, 41, 45))
# a window-path cycle's launches (18 visits' stages and rw twins, 6 step
# factor visits of 2, 3 restrictions, 3 prolongations) and the epilogues
# they carry
WINDOW_CYCLE = {"fused_stage": 18, "edge_csr.rw": 18, "step_factor": 12,
                "edge_csr.wsum.restrict": 3, "edge_csr.wsum.prolong": 3}
EPILOGUE_CYCLE = {"residual": 6, "restrict": 3, "prolong": 3, "invalid": 18}


def m6_hierarchy() -> MultigridMesh:
    """Box levels of M6_DIMS nodes, each spanning level 0's box at spacing
    0.1, a fine node mapped to the nearest coarse node along each axis;
    coarse volumes the sums of their children's."""
    extent = np.array([(d - 1) * 0.1 for d in M6_DIMS[0]])
    levels = [generate_box_mesh(*d, h=tuple(extent / (np.array(d) - 1)),
                                volume_jitter=0.2, seed=lev)
              for lev, d in enumerate(M6_DIMS)]
    for (fx, fy, fz), (cx, cy, cz), fine, coarse in zip(
            M6_DIMS, M6_DIMS[1:], levels, levels[1:]):
        i = np.arange(fx * fy * fz)

        def near(k, nf, nc):
            return np.rint(k * ((nc - 1) / (nf - 1))).astype(np.int64)
        fine.mg_mapping = ((near(i // (fy * fz), fx, cx) * cy
                            + near((i // fz) % fy, fy, cy)) * cz
                           + near(i % fz, fz, cz))
        coarse.volumes = np.bincount(fine.mg_mapping, weights=fine.volumes,
                                     minlength=coarse.num_nodes)
    return MultigridMesh(levels=levels, variant=MeshVariant.M6_WING)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run there with python -m pytest "
                    "--noconftest -m card tests/test_torch_epilogue.py")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def m6(tmp_path_factory):
    """The M6 hierarchy in (i, j, k) order and RCM-renumbered, and a
    solver per (order, dtype) made at first use: 'pallas' (the span
    kernels) on the structured order, 'window' on RCM, through one plan
    cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    meshes = {"ijk": m6_hierarchy()}
    meshes["rcm"] = renumber_hierarchy(meshes["ijk"])
    cache = str(tmp_path_factory.mktemp("plans"))
    solvers = {}

    def solver(order: str, dtype) -> MGCFDSolver:
        key = (order, dtype)
        if key not in solvers:
            solvers[key] = MGCFDSolver(meshes[order], SolverConfig(
                dtype=NAMES[dtype], plan_cache_dir=cache,
                accumulate="window" if order == "rcm" else "pallas"))
        return solvers[key]
    return types.SimpleNamespace(meshes=meshes, solver=solver)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["window", "span"])
def test_stage_epilogues_on_the_card(card, m6, kind, dtype):
    """Both fused stages at every M6 level, from a state with invalid
    values planted: three stages with the epilogues against the kernel
    without them, then q - old and the int64 adds."""
    s = m6.solver("rcm" if kind == "window" else "ijk", dtype)
    for lev, lvl in enumerate(s.dmesh.levels):
        n = lvl.num_nodes
        if kind == "window":
            def run(q, old, fac, **epi):
                return fused_stage(lvl.csr, lvl.nc, q, old, fac, **epi)
        else:
            def run(q, old, fac, **epi):
                spill = (None if lvl.spill_csr is None
                         else edge_csr.flux(lvl.spill_csr, q))
                return shift.fused_stage(lvl.shift, lvl.nc, q, old, fac,
                                         spill, **epi)
        q0 = state(n, dtype, card, seed=lev, plant=True)
        fac = 1e-3 * (1 + noise((n,), dtype, card, seed=lev).abs())
        (q, res, total), (p, got_res, count) = visit_both_ways(run, q0, fac)
        torch.cuda.synchronize()
        assert same(p, q), lev
        assert same(got_res, res), lev
        assert int(count) == int(total) >= 4 * RK, lev


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("what", ["restrict", "prolong"])
def test_wsum_epilogues_at_every_shape(card, m6, what, dtype):
    """The restriction (the M6 plans, and one whose coarse rows include
    nodes no fine node maps to) and the prolongation at every M6 level, in
    every shape (a thread a row or a (row, channel); plain, chunked and
    batched loads) and in the shape the entry point chooses: with the
    epilogue against the same shape without it, then the eager ops."""
    s = m6.solver("rcm", dtype)
    levels = s.dmesh.levels
    csrs = [(lvl.restrict_csr if what == "restrict" else lvl.prolong_csr)
            for lvl in levels[:-1]]
    if what == "restrict":
        plan, _ = restriction_with_orphans(levels[0].num_nodes,
                                           levels[1].num_nodes,
                                           np.arange(0, 165_984, 97))
        csrs.append(DeviceCSR.from_plan(plan, card, dtype))
    kern = edge_csr.restrict if what == "restrict" else edge_csr.prolong
    shapes = [edge_csr.WsumShape(split, loads) for split in (False, True)
              for loads in edge_csr.WSUM_LOADS] + [None]
    for k, csr in enumerate(csrs):
        x = noise((5, csr.num_cols), dtype, card, seed=k)
        rows = (5, csr.num_rows)
        a = state(csr.num_rows, dtype, card, seed=10 + k)
        b = 1e-2 * noise(rows, dtype, card, seed=20 + k)
        empty = (csr.row_ptr[1:] == csr.row_ptr[:-1])[None]
        for shape in shapes:
            def call(**epi):
                if shape is None:
                    return kern(csr, x, **epi)
                return kern.at(csr, x, shape, **epi)
            if what == "restrict":
                got = call(keep=a)
                want = torch.where(empty, a, call())
            else:
                got = call(correct=(a, b))
                want = a + (b - call())
            torch.cuda.synchronize()
            assert same(got, want), (k, shape)
        if what == "restrict" and k == len(csrs) - 1:
            assert bool(empty.any())


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_cycles_equal_the_eager_composition_on_the_card(card, m6,
                                                               dtype):
    """Three cycles of the window path on the M6 RCM hierarchy, with a
    negative energy planted: as test_cycles_equal_the_eager_composition,
    the kernels' epilogues against the eager ops."""
    s = m6.solver("rcm", dtype)
    saved = {key: [t.clone() for t in v] for key, v in s.state.items()}
    perturb(s, plant=True)
    (got, got_state), (want, want_state) = cycles_both_ways(
        s, m6.meshes["rcm"], 3)
    s.state = {key: list(v) for key, v in saved.items()}
    for (rms, inv), (rms_w, inv_w) in zip(got, want):
        assert same(rms, rms_w) and int(inv) == int(inv_w) > 0
    for key in ("variables", "residuals"):
        for lev, (a, b) in enumerate(zip(got_state[key], want_state[key])):
            assert same(a, b), (key, lev)


@pytest.mark.card
def test_window_cycle_counts_and_plain_kernels(card, m6):
    """run_batched(10, 10) on the M6 window path: the launches a cycle
    unchanged, the counters epilogue.* 6 / 3 / 3 / 18 a cycle; and in one
    captured cycle, replayed under torch.profiler, at most 6 device
    kernels that are not the port's own (namespace mgcfd)."""
    from mgcfd_tpu_torch.bench.profile_cycle import profile_cycles
    s = m6.solver("rcm", torch.float32)
    saved = {key: [t.clone() for t in v] for key, v in s.state.items()}
    kernels.reset_launch_counts()
    s.run_batched(10, 10)
    launched = kernels.launch_counts()
    assert {k: launched[k] for k in WINDOW_CYCLE} == {
        k: 10 * v for k, v in WINDOW_CYCLE.items()}
    assert spans.counters("epilogue.") == {
        k: 10 * v for k, v in EPILOGUE_CYCLE.items()}
    s._graph = None
    s.state = {key: list(v) for key, v in saved.items()}
    stream = torch.cuda.current_stream(card)
    side = torch.cuda.Stream(card)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        s.cycle()
    stream.wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s.cycle()
    graph.replay()
    replays = 3
    _, _, device, _ = profile_cycles(
        lambda: [graph.replay() for _ in range(replays)], replays)
    ours = sum(e.count for e in device if "mgcfd" in e.key)
    others = {e.key: e.count for e in device if "mgcfd" not in e.key}
    assert ours == replays * sum(WINDOW_CYCLE.values())
    assert sum(others.values()) <= 6 * replays, others
    s.state = {key: list(v) for key, v in saved.items()}
