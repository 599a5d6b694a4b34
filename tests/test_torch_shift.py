"""The port's shift path against the JAX package at fp64 on the CPU: the
span plan, the plain versions of the shift kernels against the Pallas
kernels of mgcfd_tpu/pallas/flux_shift.py in interpret mode, the
variable-major ops of the transposed shift path, and the solver's
'pallas' path with spill edges.

Plain versions are reached through the kernel wrappers, which take them
for CPU tensors. Tolerances: plans exact (the same numpy operations);
kernels and ops within 1e-12 of each output channel's largest magnitude
(fp64 on both sides, summed in different orders); solvers within
identify_differences (relative 1e-8, absolute floor 1e-15 for FVCORR and
3e-19 otherwise)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mgcfd_tpu.prep.shift as jax_shift_mod
from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.core.constants import far_field_state
from mgcfd_tpu.mesh import generate_box_mesh as jax_box
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.ops import internal_edge_flux as jax_internal_edge_flux
from mgcfd_tpu.ops import tops as JT
from mgcfd_tpu.pallas.flux_shift import PallasFusedStage, PallasShiftFlux
from mgcfd_tpu.prep import apply_node_order
from mgcfd_tpu.solver import MGCFDSolver as JaxSolver
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch import kernels
from mgcfd_tpu_torch.kernels import (DeviceShift, boundary_rows, build,
                                     edge_csr, shift)
from mgcfd_tpu_torch.ops import internal_edge_flux, tops
from mgcfd_tpu_torch.prep.shift import build_shift_plan, shift_flux
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.solver import solver as solver_mod
from mgcfd_tpu_torch.validate import identify_differences

torch.set_num_threads(1)
REL = 1e-12


def rel_err(got, want):
    """Max over channels of max|got - want| / max|want|, (C, N) arrays."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.maximum(np.abs(want).max(axis=1), 1e-300)
    return float((np.abs(got - want).max(axis=1) / scale).max())


def state(n, seed, pad_to=None):
    """(5, n) far-field gas with 5% seeded noise; pad columns hold
    far-field gas (the JAX kernels' lane padding)."""
    ffq = far_field_state(np.float64)[0]
    q = np.tile(ffq[:, None], (1, pad_to or n))
    q[:, :n] += 0.05 * np.random.default_rng(seed).standard_normal((5, n))
    return q


def tt(x):
    return torch.as_tensor(np.ascontiguousarray(x))


# --- the plan ---------------------------------------------------------------

def _duplicated_box():
    """A box level whose first 40 edges appear twice (and 10 of them
    reversed): duplicate (a, span) pairs, and spans to normalise."""
    lvl = jax_box(6, 5, 4)
    a, b, w = lvl.edge_a, lvl.edge_b, lvl.edge_w
    da, db, dw = a[:40].copy(), b[:40].copy(), w[:40] * 0.5
    da[:10], db[:10], dw[:10] = b[:10], a[:10], -dw[:10]
    lvl.edge_a = np.concatenate([a, da])
    lvl.edge_b = np.concatenate([b, db])
    lvl.edge_w = np.concatenate([w, dw])
    return lvl


PLAN_CASES = {
    "box": (lambda: jax_box(6, 5, 4), {}),
    "box-one-span": (lambda: jax_box(6, 5, 4), {"max_deltas": 1}),
    "scrambled": (lambda: apply_node_order(
        jax_box(6, 6, 6),
        np.random.default_rng(0).permutation(216)), {"min_density": 0.05}),
    "duplicates": (_duplicated_box, {}),
    "tet": (lambda: jax_tet(12, 12, 12, 2, seed=1, h=0.1).levels[0], {}),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_equals_jax(case):
    make, kw = PLAN_CASES[case]
    lvl = make()
    want = jax_shift_mod.build_shift_plan(lvl, **kw)
    got = build_shift_plan(lvl, **kw)
    assert got.deltas == want.deltas
    assert len(got.weights) == len(want.weights)
    for g, w in zip(got.weights, want.weights):
        np.testing.assert_array_equal(g, w)
    for k in ("spill_a", "spill_b", "spill_w"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert getattr(got, k).dtype == getattr(want, k).dtype
    assert (got.num_covered, got.num_edges) == (want.num_covered,
                                                want.num_edges)
    if case in ("box-one-span", "scrambled", "duplicates", "tet"):
        assert got.spill_a.size > 0


# --- the kernels' plain versions against the Pallas kernels ------------------

@pytest.fixture(scope="module")
def box_level():
    """11 x 8 x 8 = 704 nodes: spans 1, 8 and 64; N is no multiple of
    the 128-lane blocks of the multi-block case."""
    return jax_box(11, 8, 8, volume_jitter=0.2, seed=3)


def _device_shift(plan, n):
    return DeviceShift.from_plan(plan, n, "cpu", torch.float64)


@pytest.mark.parametrize("block_lanes", [None, 128])
@pytest.mark.parametrize("mode", ["flux", "rw"])
def test_shift_flux_matches_pallas(box_level, mode, block_lanes):
    plan = build_shift_plan(box_level)
    n = box_level.num_nodes
    q = state(n, 1)
    kern = PallasShiftFlux(plan.deltas, plan.weights, n, dtype=jnp.float64,
                           block_lanes=block_lanes, interpret=True,
                           rw=mode == "rw")
    want = np.asarray(kern(jnp.asarray(q)))
    wrapper = shift.flux if mode == "flux" else shift.rw
    got = wrapper(_device_shift(plan, n), tt(q))
    assert rel_err(got, want) <= REL


def test_shift_flux_matches_the_segment_flux(box_level):
    """The span flux is the internal-edge flux: against the JAX package's
    edge stream summed per node."""
    plan = build_shift_plan(box_level)
    n = box_level.num_nodes
    q = state(n, 2)
    a, b = box_level.edge_a, box_level.edge_b
    val = np.asarray(jax_internal_edge_flux(
        jnp.asarray(q.T[a]), jnp.asarray(q.T[b]),
        jnp.asarray(box_level.edge_w)))
    want = np.zeros((n, 5))
    np.add.at(want, a, val)
    np.add.at(want, b, -val)
    got = shift.flux(_device_shift(plan, n), tt(q))
    assert rel_err(got, want.T) <= REL


@pytest.mark.parametrize("plant", [False, True])
@pytest.mark.parametrize("with_spill", [False, True])
def test_fused_stage_matches_pallas(box_level, with_spill, plant):
    """Next state and invalid count. With `plant`, a negative density at
    one node of q: its speed of sound is NaN, which spreads through every
    row it enters, zero-weight rows included, as in the TPU kernel."""
    plan = build_shift_plan(box_level)
    n = box_level.num_nodes
    base = PallasShiftFlux(plan.deltas, plan.weights, n, dtype=jnp.float64,
                           interpret=True)
    P = base.padded
    q, old = state(n, 5, P), state(n, 6, P)
    if plant:
        q[0, n // 2] = -5.0
    fac = np.full(P, 1e-3)
    fac[:n] = 1e-3 * (1 + np.random.default_rng(7).random(n))
    spill = None
    if with_spill:
        spill = np.zeros((5, P))
        spill[:, :n] = np.random.default_rng(8).standard_normal((5, n))
    bdn, wln, wlc = tops.build_dense_boundary_wall(
        n, box_level.bedge_b, box_level.bedge_w, box_level.wedge_b,
        box_level.wedge_w, far_field_state(np.float64)[1])
    stage = PallasFusedStage(base, bdn, wln, wlc, dtype=jnp.float64)
    want, want_inv = stage(jnp.asarray(q), jnp.asarray(old),
                           jnp.asarray(fac),
                           None if spill is None else jnp.asarray(spill))
    want = np.asarray(want)[:, :n]
    got, got_inv = shift.fused_stage(
        _device_shift(plan, n),
        boundary_rows(tt(np.concatenate([bdn, wln, wlc]))),
        tt(q[:, :n]), tt(old[:, :n]), tt(fac[:n]),
        None if spill is None else tt(spill[:, :n]))
    assert int(got_inv) == int(want_inv)
    assert (int(got_inv) > 5) == plant
    got = got.numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    assert rel_err(np.where(finite, got, 0), np.where(finite, want, 0)) \
        <= REL


def test_wrappers_never_take_the_plain_version_for_card_tensors(
        monkeypatch, box_level):
    """A tensor on the card goes to the kernel or raises; a failed launch
    counts nothing."""
    calls = []

    class FailingLib:
        def __getattr__(self, name):
            def launch(*args):
                calls.append(name)
                return 700
            return launch

    monkeypatch.setattr(edge_csr, "_on_card", lambda t: True)
    monkeypatch.setattr(build, "library", lambda: FailingLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))

    def no_plain(*a, **k):
        raise AssertionError("plain version called for a card tensor")
    monkeypatch.setattr(shift, "shift_plain", no_plain)
    monkeypatch.setattr(shift, "shift_fused_stage_plain", no_plain)
    n = box_level.num_nodes
    sh = _device_shift(build_shift_plan(box_level), n)
    q = tt(state(n, 1))
    for w in (shift.flux, shift.rw):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            w(sh, q)
        assert kernels.launch_counts()[w.name] == 0
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        shift.fused_stage(sh, boundary_rows(torch.zeros((11, n),
                                                        dtype=q.dtype)),
                          q, q.clone(), torch.ones(n, dtype=q.dtype),
                          q.clone())
    assert kernels.launch_counts()[shift.fused_stage.name] == 0
    assert calls == ["mgcfd_shift_flux"] * 2 + ["mgcfd_shift_fused_stage"]


def test_wrappers_check_operands(box_level):
    n = box_level.num_nodes
    sh = _device_shift(build_shift_plan(box_level), n)
    with pytest.raises(TypeError):
        shift.flux(sh, torch.ones((5, n), dtype=torch.float32))
    with pytest.raises(ValueError):
        shift.flux(sh, torch.ones((n, 5), dtype=torch.float64))
    q = torch.ones((5, n), dtype=torch.float64)
    with pytest.raises(ValueError, match="spill"):
        shift.fused_stage(sh, boundary_rows(torch.zeros((11, n),
                                                        dtype=q.dtype)),
                          q, q, torch.ones(n, dtype=q.dtype), q[:, :-1])
    meta = DeviceShift(n, sh.deltas, sh.w.to("meta"))
    with pytest.raises(ValueError, match="device"):
        shift.flux(meta, torch.empty((5, n), device="meta",
                                     dtype=torch.float64))
    wide = build_shift_plan(box_level)
    wide.deltas = list(range(1, 18))
    wide.weights = [np.zeros((n - d, 3)) for d in wide.deltas]
    with pytest.raises(ValueError, match="at most 16"):
        _device_shift(wide, n)


# --- the variable-major ops of the transposed shift path ---------------------

def _wpad(plan, n):
    w = np.zeros((len(plan.deltas), 4, n))
    for i, wd in enumerate(plan.weights):
        w[i, :3, :wd.shape[0]] = wd.T
        w[i, 3, :wd.shape[0]] = np.sqrt((wd ** 2).sum(axis=1))
    return w


def _op_cases(lvl):
    plan = build_shift_plan(lvl)
    n = lvl.num_nodes
    q = state(n, 9)
    rng = np.random.default_rng(10)
    ew = rng.standard_normal((3, 50))
    qa, qb = state(50, 11), state(50, 12)
    ff = far_field_state(np.float64)[1]
    dest = rng.integers(0, n, 50)
    wpad = _wpad(plan, n)
    wspan = wpad.transpose(1, 0, 2).reshape(4, -1)
    wd = [w.T for w in plan.weights]
    return {
        "internal_edge_flux": ((qa, qb, ew), {}),
        "boundary_edge_flux": ((qb, ew), {}),
        "wall_edge_flux": ((qb, ew, ff), {}),
        "shift_flux": ((plan.deltas, wd, q, n), {"lists": (1,)}),
        "shift_flux_rolled": ((plan.deltas, wspan, q), {}),
        "shift_flux_rolled_3d": ((plan.deltas, wpad, q), {}),
        "shift_rw_rolled": ((plan.deltas, wspan, q), {}),
        "segment_accumulate": ((qa, dest, n), {}),
    }


@pytest.mark.parametrize("op", ["internal_edge_flux", "boundary_edge_flux",
                                "wall_edge_flux", "shift_flux",
                                "shift_flux_rolled", "shift_flux_rolled_3d",
                                "shift_rw_rolled", "segment_accumulate"])
def test_tops_match_jax(box_level, op):
    args, how = _op_cases(box_level)[op]
    name = "t_" + op.replace("_3d", "")

    def conv(x, i, mod):
        if i in how.get("lists", ()):
            return [mod(np.ascontiguousarray(w)) for w in x]
        if isinstance(x, np.ndarray):
            return mod(np.ascontiguousarray(x))
        return x

    want = getattr(JT, name)(*(conv(a, i, jnp.asarray)
                               for i, a in enumerate(args)))
    got = getattr(tops, name)(*(conv(a, i, torch.as_tensor)
                                for i, a in enumerate(args)))
    assert rel_err(got, np.asarray(want)) <= REL


def test_node_major_shift_flux_matches_jax():
    """prep.shift.shift_flux with spill edges (a one-span plan)."""
    lvl = jax_box(6, 5, 4, volume_jitter=0.2, seed=1)
    plan = build_shift_plan(lvl, max_deltas=1)
    n = lvl.num_nodes
    q = state(n, 13).T.copy()
    jspill = (jnp.asarray(plan.spill_a), jnp.asarray(plan.spill_b),
              jnp.asarray(plan.spill_w))
    want = jax_shift_mod.shift_flux(
        plan.deltas, [jnp.asarray(w) for w in plan.weights], jspill,
        jnp.asarray(q), jax_internal_edge_flux, n)
    tspill = (torch.as_tensor(plan.spill_a.astype(np.int64)),
              torch.as_tensor(plan.spill_b.astype(np.int64)),
              torch.as_tensor(plan.spill_w))
    got = shift_flux(plan.deltas, [torch.as_tensor(w) for w in plan.weights],
                     tspill, torch.as_tensor(q), internal_edge_flux, n)
    assert rel_err(got.T, np.asarray(want).T) <= REL


# --- the solver ----------------------------------------------------------------

@pytest.fixture
def one_span_plans(monkeypatch):
    """Both packages build every plan with max_deltas=1, which leaves two
    of a box's three spans to the spill path (tests/test_shift.py:71 does
    the same for the JAX package)."""
    jax_orig, port_orig = jax_shift_mod.build_shift_plan, build_shift_plan
    monkeypatch.setattr(jax_shift_mod, "build_shift_plan",
                        lambda lvl, **kw: jax_orig(lvl, max_deltas=1))
    monkeypatch.setattr(solver_mod, "build_shift_plan",
                        lambda lvl, **kw: port_orig(lvl, max_deltas=1))


@pytest.mark.parametrize("fuse", [True, False])
def test_spill_forced_pallas_matches_jax_pallas(one_span_plans, fuse):
    """The port's 'pallas' path with most edges spilled (the spill flux
    from the edge_csr flux kernel) against the JAX package's 'pallas'
    path in interpret mode on the same plans."""
    jmesh = jax_mg_box(6, 6, 6, 2, h=(0.1, 0.1, 0.1), volume_jitter=0.2)
    ref = JaxSolver(jmesh, JaxConfig(dtype="float64", accumulate="pallas",
                                     fuse_stage=fuse))
    ref.run(2)
    s = MGCFDSolver(mesh_from_arrays(jmesh),
                    SolverConfig(dtype="float64", accumulate="pallas",
                                 fuse_stage=fuse), device="cpu")
    assert all(lv.spill_csr is not None for lv in s.dmesh.levels)
    assert all(len(lv.shift.deltas) == 1 for lv in s.dmesh.levels)
    s.run(2)
    identify_differences(np.array(s.rms_history),
                         np.array(ref.rms_history), jmesh.variant)
    for lev in range(2):
        identify_differences(s.variables(lev), ref.variables(lev),
                             jmesh.variant)


@pytest.mark.parametrize("kw", [{"accumulate": "pallas"},
                                {"accumulate": "pallas",
                                 "fuse_stage": False},
                                {"accumulate": "shift", "transposed": True}],
                         ids=["pallas", "pallas-unfused",
                              "shift-transposed"])
def test_rw_twin_leaves_the_state_unchanged(one_span_plans, kw):
    """The indirect_rw twin (span and spill parts) runs after every stage
    and changes nothing: the state is bitwise that of a run without it."""
    mesh = mesh_from_arrays(jax_mg_box(6, 6, 6, 2, h=(0.1, 0.1, 0.1)))
    runs = []
    for rw_on in (True, False):
        s = MGCFDSolver(mesh, SolverConfig(dtype="float64",
                                           include_indirect_rw=rw_on, **kw),
                        device="cpu")
        s.run(2)
        runs.append(s)
    for lev in range(2):
        np.testing.assert_array_equal(runs[0].variables(lev),
                                      runs[1].variables(lev))
    assert runs[0].rms_history == runs[1].rms_history
