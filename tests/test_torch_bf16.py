"""dtype='bfloat16' in the port against the JAX package on the CPU.

bfloat16 is a storage format in both packages: the Pallas kernels' bf16
branches (flux_shift.py:163-201 and :397-431, flux_window.py:254-296 and
:382-413) load bf16, compute in float32 and round once on store, with the
invalid count taken on the float32 values. The port's plain kernel
versions do the same and are held to the Pallas kernels in interpret mode
at bf16 on the small meshes of test_torch_shift.py and test_torch_csr.py:
every element within one bf16 spacing (validate/rounding.py, which also
allows 1e-5 of the channel's largest magnitude for float32 summation
order), invalid counts exact.

The casts from float64 to bf16 of the start state, the volumes and every
weight array are held bit for bit. The solver runs 2 cycles on an 8x8x8,
2-level FVCORR box (undamped: the fp64 state moves by up to 0.56) through
every path; each channel's error against JAX's fp64 run may be at most
twice the larger of JAX's own bf16 errors ('segment', and 'pallas' in
interpret mode) against the same fp64 run, and the final RMS within 1%
of fp64's."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.core.constants import far_field_state
from mgcfd_tpu.mesh import generate_box_mesh as jax_box
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.pallas.flux_shift import PallasFusedStage, PallasShiftFlux
from mgcfd_tpu.pallas.flux_window import (PallasWindowFlux,
                                          PallasWindowFusedStage, _rw_math)
from mgcfd_tpu.prep.window import (build_prolong_window,
                                   build_restrict_window, build_window_plan)
from mgcfd_tpu.solver import MGCFDSolver as JaxSolver
from mgcfd_tpu_torch.cli.main import main as cli_main
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch import kernels
from mgcfd_tpu_torch.kernels import (DeviceCSR, DeviceShift, boundary_rows,
                                     build, edge_csr, shift)
from mgcfd_tpu_torch.kernels import fused_stage as fused_mod
from mgcfd_tpu_torch.ops.tops import build_dense_boundary_wall
from mgcfd_tpu_torch.prep.csr import (build_flux_csr, build_prolong_csr,
                                      build_restrict_csr)
from mgcfd_tpu_torch.prep.shift import build_shift_plan
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.validate.rounding import bf16_agreement

torch.set_num_threads(1)
BF = torch.bfloat16
JBF = jnp.bfloat16


def state(n, seed, pad_to=None):
    """(5, n) far-field gas with 5% seeded noise, float64; pad columns
    hold far-field gas (the JAX kernels' lane padding)."""
    ffq = far_field_state(np.float64)[0]
    q = np.tile(ffq[:, None], (1, pad_to or n))
    q[:, :n] += 0.05 * np.random.default_rng(seed).standard_normal((5, n))
    return q


def bf(x):
    """float64 numpy -> port bf16 tensor."""
    return torch.as_tensor(np.ascontiguousarray(x)).to(BF)


def jbf(x):
    """float64 numpy -> JAX bf16 array."""
    return jnp.asarray(np.ascontiguousarray(x), JBF)


def from_jax(a):
    """JAX bf16 array -> port bf16 tensor, bit for bit."""
    return torch.as_tensor(np.asarray(a).astype(np.float32)).to(BF)


def assert_agree(got, want):
    ratio, _ = bf16_agreement(got, want)
    assert ratio <= 1.0, f"{ratio:.3f} bf16 spacings apart"


# --- the casts ----------------------------------------------------------------

def test_bf16_casts_equal_jax_bit_for_bit():
    """Start state, volumes, span weights (with |w|), boundary/wall
    constants and the CSR weights: torch rounds float64 -> bf16 as
    jnp.asarray and numpy's ml_dtypes cast do."""
    jmesh = jax_mg_box(8, 8, 8, 2, h=(0.1, 0.1, 0.1), volume_jitter=0.2)
    ref = JaxSolver(jmesh, JaxConfig(dtype="bfloat16", accumulate="pallas"))
    s = MGCFDSolver(mesh_from_arrays(jmesh),
                    SolverConfig(dtype="bfloat16", accumulate="pallas"),
                    device="cpu")
    for lev, (jl, pl) in enumerate(zip(ref.dmesh.levels, s.dmesh.levels)):
        n = pl.num_nodes
        assert s.state["variables"][lev].dtype == BF
        assert torch.equal(s.state["variables"][lev],
                           from_jax(ref.state["variables"][lev][:, :n]))
        assert torch.equal(pl.volumes, from_jax(jl.volumes[:n]))
        bn = jl.pallas_fused.bn
        jw = from_jax(jl.pallas_fused.w_pad[:, :, bn:bn + n])
        assert torch.equal(pl.shift.w[:, [3, 0, 1, 2]], jw)
        assert torch.equal(pl.boundary.dense(),
                           from_jax(jl.pallas_fused.nc[:, :n]))
    lv0, lv1 = s.mesh.levels
    for csr, plan in ((s.dmesh.levels[0].restrict_csr, build_restrict_csr(
            lv0.mg_mapping, lv0.num_nodes, lv1.num_nodes)[0]),
            (s.dmesh.levels[0].prolong_csr, build_prolong_csr(lv0, lv1))):
        assert torch.equal(csr.w, from_jax(jbf(plan.w)))


# --- the span kernels' plain versions against flux_shift.py at bf16 ------------

@pytest.fixture(scope="module")
def box_level():
    """11 x 8 x 8 = 704 nodes: spans 1, 8 and 64."""
    return jax_box(11, 8, 8, volume_jitter=0.2, seed=3)


@pytest.mark.parametrize("block_lanes", [None, 128], ids=["one-block",
                                                          "blocks"])
@pytest.mark.parametrize("mode", ["flux", "rw"])
def test_shift_flux_bf16_matches_pallas(box_level, mode, block_lanes):
    plan = build_shift_plan(box_level)
    n = box_level.num_nodes
    q = state(n, 1)
    kern = PallasShiftFlux(plan.deltas, plan.weights, n, dtype=JBF,
                           block_lanes=block_lanes, interpret=True,
                           rw=mode == "rw")
    want = from_jax(kern(jbf(q)))
    wrapper = shift.flux if mode == "flux" else shift.rw
    got = wrapper(DeviceShift.from_plan(plan, n, "cpu", BF), bf(q))
    assert got.dtype == BF
    assert_agree(got, want)


@pytest.mark.parametrize("plant", [False, True])
@pytest.mark.parametrize("with_spill", [False, True])
def test_shift_fused_stage_bf16_matches_pallas(box_level, with_spill,
                                               plant):
    """With `plant`, a negative density at one node: invalid counts are
    taken on the float32 values in both and must be equal."""
    plan = build_shift_plan(box_level)
    n = box_level.num_nodes
    base = PallasShiftFlux(plan.deltas, plan.weights, n, dtype=JBF,
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
    bdn, wln, wlc = build_dense_boundary_wall(
        n, box_level.bedge_b, box_level.bedge_w, box_level.wedge_b,
        box_level.wedge_w, far_field_state(np.float64)[1])
    stage = PallasFusedStage(base, bdn, wln, wlc, dtype=JBF)
    want, want_inv = stage(jbf(q), jbf(old), jbf(fac),
                           None if spill is None else jbf(spill))
    got, got_inv = shift.fused_stage(
        DeviceShift.from_plan(plan, n, "cpu", BF),
        boundary_rows(bf(np.concatenate([bdn, wln, wlc]))), bf(q[:, :n]),
        bf(old[:, :n]),
        bf(fac[:n]), None if spill is None else bf(spill[:, :n]))
    assert got_inv.dtype == torch.int64
    assert int(got_inv) == int(want_inv)
    assert (int(got_inv) > 5) == plant
    assert_agree(got, from_jax(want[:, :n]))


# --- the CSR kernels' plain versions against flux_window.py at bf16 ------------

@pytest.fixture(scope="module")
def jtet():
    mesh = jax_tet(8, 8, 8, 2, seed=5)
    # no spill edges on this mesh: the window kernels carry every edge,
    # so each side rounds its whole sum once
    assert build_window_plan(mesh.levels[0]).spill_a.shape[0] == 0
    return mesh


def csr_bf16(plan):
    return DeviceCSR.from_plan(plan, "cpu", BF)


def test_window_flux_bf16_matches_pallas(jtet):
    lvl = mesh_from_arrays(jtet).levels[0]
    n = lvl.num_nodes
    plan = build_window_plan(jtet.levels[0])
    q = state(n, 1, plan.padded_nodes)
    want = PallasWindowFlux(plan, n, dtype=JBF, interpret=True)(jbf(q))
    got = edge_csr.flux(csr_bf16(build_flux_csr(lvl)), bf(q[:, :n]))
    assert_agree(got, from_jax(want[:, :n]))


def test_window_rw_bf16_matches_the_twin(jtet):
    """Against _rw_math in float32 on the bf16 state and weights, summed
    per owner and rounded once (the window kernel also adds q_o + q_n on
    the empty slots of its packed layers, test_torch_csr.py says why)."""
    lvl = mesh_from_arrays(jtet).levels[0]
    n = lvl.num_nodes
    q = state(n, 2)
    a, b = lvl.edge_a.astype(np.int64), lvl.edge_b.astype(np.int64)
    owner, nbr = np.concatenate([a, b]), np.concatenate([b, a])
    w = jbf(np.concatenate([lvl.edge_w, -lvl.edge_w]).T).astype(
        jnp.float32)
    q32 = jbf(q).astype(jnp.float32)
    vals = _rw_math([q32[c, owner] for c in range(5)],
                    [q32[c, nbr] for c in range(5)],
                    [w[k] for k in range(3)])
    want = jnp.stack([jax.ops.segment_sum(v, owner, num_segments=n)
                      for v in vals]).astype(JBF)
    got = edge_csr.rw(csr_bf16(build_flux_csr(lvl)), bf(q))
    assert_agree(got, from_jax(want))


@pytest.mark.parametrize("transfer", ["restrict", "prolong"])
def test_window_wsum_bf16_matches_pallas(jtet, transfer):
    fine, coarse = mesh_from_arrays(jtet).levels
    nf, nc = fine.num_nodes, coarse.num_nodes
    if transfer == "restrict":
        rwin = build_restrict_window(fine.mg_mapping, nf, nc)
        assert rwin["spill_fine"].shape[0] == 0
        kern = PallasWindowFlux(rwin["plan"], nc, dtype=JBF, interpret=True,
                                mode="wsum")
        x = state(nf, 3, kern.padded_in)
        plan, n_in, n_out = build_restrict_csr(fine.mg_mapping, nf,
                                               nc)[0], nf, nc
    else:
        pwin = build_prolong_window(jtet.levels[0], jtet.levels[1],
                                    num_coarse_pad=nc)
        assert pwin["cspill_fine"].shape[0] == 0
        kern = PallasWindowFlux(pwin["cplan"], nf, dtype=JBF,
                                interpret=True, mode="wsum")
        x = np.zeros((5, kern.padded_in))
        x[:, :nc] = np.random.default_rng(4).standard_normal((5, nc))
        plan, n_in, n_out = build_prolong_csr(fine, coarse), nc, nf
    want = kern(jbf(x))
    wrapper = edge_csr.restrict if transfer == "restrict" \
        else edge_csr.prolong
    got = wrapper(csr_bf16(plan), bf(x[:, :n_in]))
    assert_agree(got, from_jax(want[:, :n_out]))


@pytest.mark.parametrize("plant", [False, True])
def test_window_fused_stage_bf16_matches_pallas(jtet, plant):
    """With `plant`, a negative density and a NaN energy in `old`
    (test_torch_csr.py says why there): counts equal, 2."""
    lvl = mesh_from_arrays(jtet).levels[0]
    n = lvl.num_nodes
    plan = build_window_plan(jtet.levels[0])
    P = plan.padded_nodes
    q, old = state(n, 5, P), state(n, 6, P)
    if plant:
        old[0, n // 2] = -5.0
        old[4, n // 3] = np.nan
    fac = np.full(P, 1e-3)
    fac[:n] = 1e-3 * (1 + np.random.default_rng(7).random(n))
    bdn, wln, wlc = build_dense_boundary_wall(
        n, lvl.bedge_b, lvl.bedge_w, lvl.wedge_b, lvl.wedge_w,
        far_field_state(np.float64)[1])
    base = PallasWindowFlux(plan, n, dtype=JBF, interpret=True)
    stage = PallasWindowFusedStage(base, bdn, wln, wlc, dtype=JBF)
    want, want_inv = stage(jbf(q), jbf(old), jbf(fac), None)
    got, got_inv = fused_mod.fused_stage(
        csr_bf16(build_flux_csr(lvl)),
        boundary_rows(bf(np.concatenate([bdn, wln, wlc]))),
        bf(q[:, :n]), bf(old[:, :n]), bf(fac[:n]))
    assert int(got_inv) == int(want_inv) == (2 if plant else 0)
    assert_agree(got, from_jax(want[:, :n]))


# --- the solver -------------------------------------------------------------------

@pytest.fixture(scope="module")
def fvcorr_runs():
    """JAX on the undamped box, 2 cycles from the far field: fp64, and
    bf16 through 'segment' and 'pallas' (interpret mode). Returns (mesh,
    fp64 solver, per-channel bound: twice the larger bf16 error)."""
    mesh = jax_mg_box(8, 8, 8, 2, h=(0.1, 0.1, 0.1), volume_jitter=0.2,
                      variant=JaxVariant.FVCORR)
    ref = JaxSolver(mesh, JaxConfig(dtype="float64"))
    ref.run(2)
    errs = []
    for mode in ("segment", "pallas"):
        j = JaxSolver(mesh, JaxConfig(dtype="bfloat16", accumulate=mode))
        j.run(2)
        errs.append(np.abs(j.variables(0).astype(np.float64)
                           - ref.variables(0)).max(axis=0))
    return mesh, ref, 2 * np.maximum(*errs)


@pytest.mark.parametrize("kw", [
    {"accumulate": "segment"}, {"accumulate": "shift"},
    {"accumulate": "shift", "transposed": True}, {"accumulate": "pallas"},
    {"accumulate": "pallas", "fuse_stage": False},
    {"accumulate": "window"}],
    ids=["segment", "shift", "shift-transposed", "pallas", "pallas-unfused",
         "window"])
def test_bf16_solver_tracks_fp64(fvcorr_runs, kw):
    mesh, ref, bound = fvcorr_runs
    s = MGCFDSolver(mesh_from_arrays(mesh),
                    SolverConfig(dtype="bfloat16", **kw), device="cpu")
    s.run(2)
    v = s.variables(0)
    assert s.state["variables"][0].dtype == BF
    assert np.isfinite(v).all() and (v[:, 0] > 0).all()
    err = np.abs(v - ref.variables(0)).max(axis=0)
    assert (err <= bound).all(), f"per-channel error {err} > {bound}"
    assert abs(s.rms_history[-1] / ref.rms_history[-1] - 1) <= 0.01


@pytest.mark.parametrize("kw", [{"accumulate": "pallas"},
                                {"accumulate": "pallas",
                                 "fuse_stage": False},
                                {"accumulate": "window"}],
                         ids=["pallas", "pallas-unfused", "window"])
def test_bf16_rw_twin_leaves_the_state_unchanged(kw):
    mesh = mesh_from_arrays(jax_mg_box(6, 6, 6, 2, h=(0.1, 0.1, 0.1)))
    runs = []
    for rw_on in (True, False):
        s = MGCFDSolver(mesh, SolverConfig(dtype="bfloat16",
                                           include_indirect_rw=rw_on, **kw),
                        device="cpu")
        s.run(2)
        runs.append(s)
    for lev in range(2):
        np.testing.assert_array_equal(runs[0].variables(lev),
                                      runs[1].variables(lev))
    assert runs[0].rms_history == runs[1].rms_history


def test_cli_takes_bfloat16(capsys):
    assert cli_main(["--synthetic", "5,5,5,2", "-g", "2", "--dtype",
                     "bfloat16", "--platform", "cpu"]) == 0
    assert "dtype=bfloat16" in capsys.readouterr().out


# --- the wrappers ---------------------------------------------------------------

def test_wrappers_refuse_mismatched_dtypes(box_level):
    n = box_level.num_nodes
    plan = build_shift_plan(box_level)
    sh = DeviceShift.from_plan(plan, n, "cpu", BF)
    with pytest.raises(TypeError):
        shift.flux(sh, torch.ones((5, n), dtype=torch.float32))
    with pytest.raises(TypeError):
        shift.flux(DeviceShift.from_plan(plan, n, "cpu", torch.float16),
                   torch.ones((5, n), dtype=torch.float16))
    q = torch.ones((5, n), dtype=BF)
    with pytest.raises(ValueError, match="fac"):
        shift.fused_stage(sh, boundary_rows(torch.zeros((11, n), dtype=BF)),
                          q, q, torch.ones(n, dtype=torch.float32))
    lvl = mesh_from_arrays(jax_tet(6, 6, 6, 2, seed=1)).levels[0]
    csr = csr_bf16(build_flux_csr(lvl))
    m = lvl.num_nodes
    with pytest.raises(TypeError):
        edge_csr.flux(csr, torch.ones((5, m), dtype=torch.float64))
    with pytest.raises(ValueError, match="old"):
        fused_mod.fused_stage(csr, boundary_rows(torch.zeros((11, m),
                                                             dtype=BF)),
                              torch.ones((5, m), dtype=BF),
                              torch.ones((5, m), dtype=torch.float32),
                              torch.ones(m, dtype=BF))


def test_wrappers_launch_the_bf16_kernels_for_card_tensors(monkeypatch,
                                                          box_level):
    """A bf16 tensor on the card goes to the kernel with dtype code 2 or
    raises; it never takes the plain version, and a failed launch counts
    nothing."""
    calls = []

    class FailingLib:
        def __getattr__(self, name):
            def launch(*args):
                calls.append((name, args[0]))
                return 700
            return launch

    monkeypatch.setattr(edge_csr, "_on_card", lambda t: True)
    monkeypatch.setattr(build, "library", lambda: FailingLib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))

    def no_plain(*a, **k):
        raise AssertionError("plain version called for a card tensor")
    for mod, fn in ((shift, "shift_plain"),
                    (shift, "shift_fused_stage_plain"),
                    (edge_csr, "edge_csr_plain"),
                    (fused_mod, "fused_stage_plain")):
        monkeypatch.setattr(mod, fn, no_plain)
    n = box_level.num_nodes
    sh = DeviceShift.from_plan(build_shift_plan(box_level), n, "cpu", BF)
    q = bf(state(n, 1))
    nc = boundary_rows(torch.zeros((11, n), dtype=BF))
    fac = torch.ones(n, dtype=BF)
    lvl = mesh_from_arrays(jax_tet(6, 6, 6, 2, seed=1)).levels[0]
    csr = csr_bf16(build_flux_csr(lvl))
    qt = bf(state(lvl.num_nodes, 2))
    nct = boundary_rows(torch.zeros((11, lvl.num_nodes), dtype=BF))
    launches = [
        (shift.flux, lambda: shift.flux(sh, q)),
        (shift.rw, lambda: shift.rw(sh, q)),
        (shift.fused_stage,
         lambda: shift.fused_stage(sh, nc, q, q.clone(), fac, q.clone())),
        (edge_csr.flux, lambda: edge_csr.flux(csr, qt)),
        (edge_csr.rw, lambda: edge_csr.rw(csr, qt)),
        (fused_mod.fused_stage,
         lambda: fused_mod.fused_stage(csr, nct, qt, qt.clone(),
                                       torch.ones(lvl.num_nodes, dtype=BF))),
    ]
    for wrapper, call in launches:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            call()
        assert kernels.launch_counts()[wrapper.name] == 0
    assert calls == [("mgcfd_shift_flux", 2), ("mgcfd_shift_flux", 2),
                     ("mgcfd_shift_fused_stage", 2), ("mgcfd_edge_csr", 2),
                     ("mgcfd_edge_csr", 2), ("mgcfd_fused_stage", 2)]
