"""mgcfd_tpu_torch.ops against mgcfd_tpu.ops at fp64: the same numpy
inputs through both, relative error <= 1e-12 of each array's largest
magnitude (both are the same formulas in double precision; the rest is
summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgcfd_tpu.ops as J
from mgcfd_tpu.core.constants import far_field_state as jax_far_field
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.ops import tops as JT
from mgcfd_tpu_torch import ops as T
from mgcfd_tpu_torch.core.constants import (GAMMA, RK,
                                            SMOOTHING_COEFFICIENT,
                                            far_field_state)
from mgcfd_tpu_torch.ops import tops as TT

torch.set_num_threads(1)
REL = 1e-12


def close(got, want, rel=REL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def t(x):
    return torch.as_tensor(np.asarray(x))


def random_state(n, seed=0):
    """Physically sane random conserved states (positive rho and p)."""
    rng = np.random.default_rng(seed)
    q = np.empty((n, 5))
    q[:, 0] = 1.0 + rng.random(n)
    q[:, 1:4] = rng.standard_normal((n, 3))
    q[:, 4] = 0.5 * (q[:, 1:4] ** 2).sum(1) / q[:, 0] + 1.0 + rng.random(n)
    return q


@pytest.fixture(scope="module")
def box():
    return jax_mg_box(6, 5, 4, 2, h=(0.1, 0.1, 0.1), volume_jitter=0.3)


@pytest.fixture(scope="module")
def tet():
    return jax_tet(6, 6, 6, 2, seed=4)


def test_constants():
    assert GAMMA == 1.4 and RK == 3
    assert SMOOTHING_COEFFICIENT == float(np.float64(np.float32(0.2)))
    for a, b in zip(far_field_state(), jax_far_field()):
        np.testing.assert_array_equal(a, b)


def test_primitives_and_flux_tensor():
    q = random_state(50, 1)
    pj, pt = J.primitive_quantities(jnp.asarray(q)), \
        T.primitive_quantities(t(q))
    for k in ("rho", "vel", "speed_sqd", "speed", "pressure", "sos"):
        close(pt[k], pj[k])
    close(T.flux_tensor(t(q)), J.flux_tensor(jnp.asarray(q)))


def test_edge_fluxes(tet):
    lvl = tet.levels[0]
    q = random_state(lvl.num_nodes, 2)
    qa, qb = q[lvl.edge_a], q[lvl.edge_b]
    close(T.internal_edge_flux(t(qa), t(qb), t(lvl.edge_w)),
          J.internal_edge_flux(jnp.asarray(qa), jnp.asarray(qb),
                               jnp.asarray(lvl.edge_w)))
    qbd = q[lvl.bedge_b]
    close(T.boundary_edge_flux(t(qbd), t(lvl.bedge_w)),
          J.boundary_edge_flux(jnp.asarray(qbd), jnp.asarray(lvl.bedge_w)))
    ff = far_field_state()[1]
    qw = q[lvl.wedge_b]
    close(T.wall_edge_flux(t(qw), t(lvl.wedge_w), t(ff)),
          J.wall_edge_flux(jnp.asarray(qw), jnp.asarray(lvl.wedge_w),
                           jnp.asarray(ff)))
    for a, b in zip(T.indirect_rw_edge_values(t(qa), t(qb), t(lvl.edge_w)),
                    J.indirect_rw_edge_values(jnp.asarray(qa),
                                              jnp.asarray(qb),
                                              jnp.asarray(lvl.edge_w))):
        close(a, b)


def test_accumulate_segment(tet):
    lvl = tet.levels[0]
    rng = np.random.default_rng(3)
    vi = rng.standard_normal((lvl.num_internal_edges, 5))
    vb = rng.standard_normal((lvl.bedge_b.shape[0], 5))
    vw = rng.standard_normal((lvl.wedge_b.shape[0], 5))
    ia, ib, bb, wb = (t(x.astype(np.int64)) for x in
                      (lvl.edge_a, lvl.edge_b, lvl.bedge_b, lvl.wedge_b))
    close(T.accumulate_flux(lvl.num_nodes, ia, ib, t(vi), bb, t(vb), wb,
                            t(vw)),
          J.accumulate_flux(lvl.num_nodes, lvl.edge_a, lvl.edge_b,
                            jnp.asarray(vi), lvl.bedge_b, jnp.asarray(vb),
                            lvl.wedge_b, jnp.asarray(vw), mode="segment"))


def test_step_factors_and_time_step(box):
    lvl = box.levels[0]
    q = random_state(lvl.num_nodes, 4)
    vol = lvl.volumes
    close(T.compute_step_factor(t(q), t(vol)),
          J.compute_step_factor(jnp.asarray(q), jnp.asarray(vol)))
    # the legacy factor keeps the reference's sqrt (PARITY.md:48)
    legacy = T.compute_step_factor_legacy(t(q), t(vol))
    close(legacy, J.compute_step_factor_legacy(jnp.asarray(q),
                                               jnp.asarray(vol)))
    p = T.primitive_quantities(t(q))
    close(legacy, 0.5 / (np.sqrt(vol) * (p["speed"] + p["sos"]).numpy()))
    rng = np.random.default_rng(5)
    flux = rng.standard_normal(q.shape)
    sf = rng.random(lvl.num_nodes)
    for j in range(RK):
        close(T.time_step(j, t(sf), t(flux), t(q)),
              J.time_step(j, jnp.asarray(sf), jnp.asarray(flux),
                          jnp.asarray(q)))


def test_rms_residual_invalid():
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((40, 5)), rng.standard_normal((40, 5))
    close(T.residual(t(a), t(b)), J.residual(jnp.asarray(a),
                                             jnp.asarray(b)))
    close(T.calc_rms(t(a)), J.calc_rms(jnp.asarray(a)))
    # the reference divides by the NODE count
    close(T.calc_rms(t(a)), np.sqrt((a * a).sum() / 40))
    close(T.calc_rms(t(a.T.copy()), 40), J.calc_rms(jnp.asarray(a.T), 40))
    q = random_state(30, 7)
    q[3, 2] = np.nan
    q[5, 0] = -1.0
    q[6, 4] = -2.0
    q[8, 1] = np.inf
    assert int(T.invalid_variables_count(t(q))) == \
        int(J.invalid_variables_count(jnp.asarray(q))) == 4


@pytest.mark.parametrize("partial", [False, True])
def test_mg_restrict(tet, partial):
    fine, coarse = tet.levels
    mapping = fine.mg_mapping[:fine.num_nodes - 40] if partial \
        else fine.mg_mapping
    vf = random_state(fine.num_nodes, 8)
    vc = random_state(coarse.num_nodes, 9)
    close(T.mg_restrict(t(vf), t(vc), t(mapping), coarse.num_nodes),
          J.mg_restrict(jnp.asarray(vf), jnp.asarray(vc),
                        jnp.asarray(mapping), coarse.num_nodes))


@pytest.mark.parametrize("mesh", ["box", "tet"])
def test_prolong(mesh, box, tet):
    """Includes coincident parents (box) and the a1 -> b2 quirk."""
    fine, coarse = (box if mesh == "box" else tet).levels
    rng = np.random.default_rng(10)
    rc = rng.standard_normal((coarse.num_nodes, 5))
    rf = rng.standard_normal((fine.num_nodes, 5))
    vf = random_state(fine.num_nodes, 11)
    ia, ib = (t(x.astype(np.int64)) for x in (fine.edge_a, fine.edge_b))
    close(T.prolong_residuals_interpolate(
        t(rc), t(rf), t(vf), t(fine.mg_mapping), t(coarse.coords),
        t(fine.coords), ia, ib),
        J.prolong_residuals_interpolate(
            jnp.asarray(rc), jnp.asarray(rf), jnp.asarray(vf),
            jnp.asarray(fine.mg_mapping), jnp.asarray(coarse.coords),
            jnp.asarray(fine.coords), jnp.asarray(fine.edge_a),
            jnp.asarray(fine.edge_b)))


def test_variable_major_ops(tet):
    lvl = tet.levels[0]
    q = random_state(lvl.num_nodes, 12).T.copy()
    pj, pt = JT.t_primitives(jnp.asarray(q)), TT.t_primitives(t(q))
    for k in ("vel", "speed", "pressure", "sos"):
        close(pt[k], pj[k])
    ff = far_field_state()[1]
    bw_t = TT.build_dense_boundary_wall(lvl.num_nodes, lvl.bedge_b,
                                        lvl.bedge_w, lvl.wedge_b,
                                        lvl.wedge_w, ff)
    bw_j = JT.build_dense_boundary_wall(lvl.num_nodes, lvl.bedge_b,
                                        lvl.bedge_w, lvl.wedge_b,
                                        lvl.wedge_w, ff)
    for a, b in zip(bw_t, bw_j):
        close(a, b)
    close(TT.t_dense_boundary_wall_flux(t(q), *(t(a) for a in bw_t)),
          JT.t_dense_boundary_wall_flux(jnp.asarray(q),
                                        *(jnp.asarray(a) for a in bw_j)))
    rng = np.random.default_rng(13)
    flux, sf = rng.standard_normal(q.shape), rng.random(lvl.num_nodes)
    close(TT.t_time_step(1, t(sf), t(flux), t(q)),
          JT.t_time_step(1, jnp.asarray(sf), jnp.asarray(flux),
                         jnp.asarray(q)))
