"""The port's CSR plans and the plain versions of its kernels against the
JAX package's window plans and Pallas kernels (interpret mode, fp64).

Plain versions are reached through the kernel wrappers, which take them
for CPU tensors. Tolerance: relative error <= 1e-12 of each output
channel's largest magnitude — fp64 on both sides, summed in different
orders."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mgcfd_tpu.core.constants import far_field_state
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.ops import tops as JT
from mgcfd_tpu.pallas.flux_window import (PallasWindowFlux,
                                          PallasWindowFusedStage, _rw_math)
from mgcfd_tpu.prep.window import (build_prolong_window,
                                   build_restrict_window, build_window_plan,
                                   composed_prolong_halves)
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.kernels import DeviceCSR, boundary_rows, edge_csr
from mgcfd_tpu_torch.kernels.fused_stage import fused_stage
from mgcfd_tpu_torch.ops.tops import build_dense_boundary_wall
from mgcfd_tpu_torch.prep.csr import (build_flux_csr, build_prolong_csr,
                                      build_restrict_csr)

torch.set_num_threads(1)
REL = 1e-12


@pytest.fixture(scope="module")
def jmesh():
    return jax_tet(8, 8, 8, 2, seed=5)


@pytest.fixture(scope="module")
def pmesh(jmesh):
    return mesh_from_arrays(jmesh)


def dev(plan):
    return DeviceCSR.from_plan(plan, "cpu", torch.float64)


def tt(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.maximum(np.abs(want).max(axis=1), 1e-300)
    return float((np.abs(got - want).max(axis=1) / scale).max())


def state(n, seed, pad_to=None):
    """(5, n) far-field gas with 5% seeded noise; pad columns hold
    far-field gas (the JAX kernels' lane padding)."""
    ffq = far_field_state(np.float64)[0]
    q = np.tile(ffq[:, None], (1, pad_to or n))
    rng = np.random.default_rng(seed)
    q[:, :n] += 0.05 * rng.standard_normal((5, n))
    return q


def test_flux_plan_is_the_half_edge_multiset(pmesh):
    """Every internal edge appears exactly twice, (a, b, +w) and
    (b, a, -w), with |w| beside it; rows are owner-sorted."""
    lvl = pmesh.levels[0]
    p = build_flux_csr(lvl)
    assert p.num_entries == 2 * lvl.num_internal_edges
    np.testing.assert_array_equal(np.repeat(np.arange(p.num_rows),
                                            np.diff(p.row_ptr)), p.owner)
    got = sorted(zip(p.owner.tolist(), p.col.tolist(),
                     *(p.w[k].tolist() for k in range(4))))
    ewt = np.sqrt((lvl.edge_w ** 2).sum(1))
    want = sorted(
        [(a, b, *w, n) for a, b, w, n in zip(
            lvl.edge_a.tolist(), lvl.edge_b.tolist(), lvl.edge_w.tolist(),
            ewt.tolist())]
        + [(b, a, *(-np.asarray(w)).tolist(), n) for a, b, w, n in zip(
            lvl.edge_a.tolist(), lvl.edge_b.tolist(), lvl.edge_w.tolist(),
            ewt.tolist())])
    assert got == want


def test_transfer_plans_match_the_window_plans(jmesh, pmesh):
    fine, coarse = pmesh.levels
    rp, mapped = build_restrict_csr(fine.mg_mapping, fine.num_nodes,
                                    coarse.num_nodes)
    counts = np.bincount(fine.mg_mapping, minlength=coarse.num_nodes)
    np.testing.assert_array_equal(mapped, counts > 0)
    assert sorted(zip(rp.owner.tolist(), rp.col.tolist(),
                      rp.w[0].tolist())) == sorted(
        (int(m), i, 1.0 / counts[m]) for i, m in
        enumerate(fine.mg_mapping))
    pp = build_prolong_csr(fine, coarse)
    o, n, w = composed_prolong_halves(jmesh.levels[0], jmesh.levels[1],
                                      coarse.num_nodes)
    np.testing.assert_array_equal(pp.owner, o)
    np.testing.assert_array_equal(pp.col, n)
    np.testing.assert_allclose(pp.w[0], w, rtol=1e-15, atol=0)


def _spill_flux(jlvl, plan, qj, P):
    """The caller-side segment sum of the window plan's spilled edges."""
    if not plan.spill_a.shape[0]:
        return 0.0
    sa, sb = jnp.asarray(plan.spill_a), jnp.asarray(plan.spill_b)
    val = JT.t_internal_edge_flux(qj[:, sa], qj[:, sb],
                                  jnp.asarray(plan.spill_w).T)
    return np.asarray(JT.t_segment_accumulate(
        jnp.concatenate([val, -val], axis=1), jnp.concatenate([sa, sb]), P))


def test_flux_mode_matches_pallas_window(jmesh, pmesh):
    jl, pl = jmesh.levels[0], pmesh.levels[0]
    n = pl.num_nodes
    plan = build_window_plan(jl)
    P = plan.padded_nodes
    q = state(n, 1, P)
    qj = jnp.asarray(q)
    want = np.asarray(PallasWindowFlux(plan, n, dtype=jnp.float64,
                                       interpret=True)(qj))
    want = (want + _spill_flux(jl, plan, qj, P))[:, :n]
    got = edge_csr.flux(dev(build_flux_csr(pl)), tt(q[:, :n]))
    assert rel_err(got, want) <= REL


def test_rw_mode_matches_per_edge_twin(pmesh):
    """Held against JAX's per-half-edge twin values (_rw_math summed into
    the owners), not against PallasWindowFlux(rw=True): the window kernel
    also adds q_o + q_n on the empty slots of its packed (8, 128) layers,
    an artefact of the packing that no CSR has."""
    pl = pmesh.levels[0]
    n = pl.num_nodes
    q = state(n, 2)
    a, b = pl.edge_a.astype(np.int64), pl.edge_b.astype(np.int64)
    owner, nbr = np.concatenate([a, b]), np.concatenate([b, a])
    w = np.concatenate([pl.edge_w, -pl.edge_w]).T
    vals = _rw_math([jnp.asarray(q[c, owner]) for c in range(5)],
                    [jnp.asarray(q[c, nbr]) for c in range(5)],
                    [jnp.asarray(w[k]) for k in range(3)])
    want = np.stack([np.asarray(jax.ops.segment_sum(v, owner,
                                                    num_segments=n))
                     for v in vals])
    got = edge_csr.rw(dev(build_flux_csr(pl)), torch.as_tensor(q))
    assert rel_err(got, want) <= REL


def test_wsum_restrict_matches_pallas_window(pmesh):
    fine, coarse = pmesh.levels
    nf, nc = fine.num_nodes, coarse.num_nodes
    rw = build_restrict_window(fine.mg_mapping, nf, nc)
    kern = PallasWindowFlux(rw["plan"], nc, dtype=jnp.float64,
                            interpret=True, mode="wsum")
    x = state(nf, 3, kern.padded_in)
    want = np.asarray(kern(jnp.asarray(x)))
    if rw["spill_fine"].shape[0]:
        np.add.at(want.T, rw["spill_coarse"],
                  (rw["spill_w"] * x[:, rw["spill_fine"]]).T)
    plan, _ = build_restrict_csr(fine.mg_mapping, nf, nc)
    got = edge_csr.restrict(dev(plan), tt(x[:, :nf]))
    assert rel_err(got, want[:, :nc]) <= REL


def test_wsum_prolong_matches_pallas_window(jmesh, pmesh):
    fine, coarse = pmesh.levels
    nf, nc = fine.num_nodes, coarse.num_nodes
    pw = build_prolong_window(jmesh.levels[0], jmesh.levels[1],
                              num_coarse_pad=nc)
    kern = PallasWindowFlux(pw["cplan"], nf, dtype=jnp.float64,
                            interpret=True, mode="wsum")
    rng = np.random.default_rng(4)
    rc = np.zeros((5, kern.padded_in))
    rc[:, :nc] = rng.standard_normal((5, nc))
    want = np.asarray(kern(jnp.asarray(rc)))
    if pw["cspill_fine"].shape[0]:
        np.add.at(want.T, pw["cspill_fine"],
                  (pw["cspill_w"] * rc[:, pw["cspill_coarse"]]).T)
    got = edge_csr.prolong(dev(build_prolong_csr(fine, coarse)),
                           tt(rc[:, :nc]))
    assert rel_err(got, want[:, :nf]) <= REL


@pytest.mark.parametrize("plant", [False, True])
def test_fused_stage_matches_pallas_window(jmesh, pmesh, plant):
    """Next state and invalid count. With `plant`, a negative density (as
    tests/test_window.py:351 plants) and a NaN energy go into `old`: they
    reach the output at their own nodes only. Planted in `q` they would
    also spread through the window kernel's zero-weight packing slots
    (0 * NaN), an artefact of the TPU layout."""
    jl, pl = jmesh.levels[0], pmesh.levels[0]
    n = pl.num_nodes
    plan = build_window_plan(jl)
    P = plan.padded_nodes
    q, old = state(n, 5, P), state(n, 6, P)
    if plant:
        old[0, n // 2] = -5.0
        old[4, n // 3] = np.nan
    fac = np.full(P, 1e-3)
    fac[:n] = 1e-3 * (1 + np.random.default_rng(7).random(n))
    bdn, wln, wlc = build_dense_boundary_wall(
        n, pl.bedge_b, pl.bedge_w, pl.wedge_b, pl.wedge_w,
        far_field_state(np.float64)[1])
    base = PallasWindowFlux(plan, n, dtype=jnp.float64, interpret=True)
    stage = PallasWindowFusedStage(base, bdn, wln, wlc, dtype=jnp.float64)
    qj = jnp.asarray(q)
    spill = _spill_flux(jl, plan, qj, P)
    want, want_inv = stage(qj, jnp.asarray(old), jnp.asarray(fac),
                           None if np.isscalar(spill)
                           else jnp.asarray(spill))
    want = np.asarray(want)[:, :n]
    nc = boundary_rows(torch.as_tensor(np.concatenate([bdn, wln, wlc])))
    got, got_inv = fused_stage(dev(build_flux_csr(pl)), nc,
                               tt(q[:, :n]),
                               tt(old[:, :n]),
                               tt(fac[:n]))
    assert int(got_inv) == int(want_inv) == (2 if plant else 0)
    if plant:
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
        got, want = np.where(finite, got.numpy(), 0), np.where(finite,
                                                                want, 0)
    assert rel_err(got, want) <= REL
