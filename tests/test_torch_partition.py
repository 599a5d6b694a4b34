"""The port's partitioner (mgcfd_tpu_torch/parallel/partition.py) against
mgcfd_tpu.parallel.partition element for element (node blocks,
separators, edge ownership and combined indices, boundary and wall edges,
the span decomposition, the MG maps, 1-D and 2-D, box and tet, P = 2, 4,
8, shard_levels 1, 2 and 0), and each rank's CSRs against the single
device's plans; edge_csr over a neighbour space wider than its owners."""
import dataclasses

import numpy as np
import pytest
import torch

from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.parallel import partition as jax_part
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.kernels import DeviceCSR, boundary_rows, edge_csr
from mgcfd_tpu_torch.kernels.fused_stage import fused_stage
from mgcfd_tpu_torch.mesh import generate_multigrid_box
from mgcfd_tpu_torch.parallel import partition as part
from mgcfd_tpu_torch.utils import spans
from mgcfd_tpu_torch.prep.csr import (build_flux_csr, build_prolong_csr,
                                      build_restrict_csr)

torch.set_num_threads(1)
H = (0.1, 0.1, 0.1)


def jax_mesh(kind):
    if kind == "box":
        return jax_mg_box(10, 8, 8, 3, h=H, volume_jitter=0.2)
    return jax_tet(11, 10, 10, 3, seed=3)


@pytest.fixture(scope="module", params=["box", "tet"])
def meshes(request):
    jm = jax_mesh(request.param)
    return request.param, jm, mesh_from_arrays(jm)


def assert_levels_equal(mine, ref):
    for f in dataclasses.fields(part.ShardedLevelData):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("shard_levels", [1, 2, 0])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_partition_equals_jax(meshes, P, shard_levels, two_d):
    """Every array of every sharded level equal, dtypes included (the span
    decomposition on the box), after the same 2-D reordering."""
    kind, jm, mine = meshes
    if two_d:
        jm, jorders = jax_part.partition2d_hierarchy(jm, P)
        mine, orders = part.partition2d_hierarchy(mine, P)
        for a, b in zip(orders, jorders):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(mine.levels, jm.levels):
            np.testing.assert_array_equal(a.mg_mapping is None,
                                          b.mg_mapping is None)
            for f in ("edge_a", "edge_b", "volumes", "coords"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    shift = kind == "box"
    ref = jax_part.partition_mesh(jm, P, use_shift=shift,
                                  shard_levels=shard_levels)
    got = part.partition_mesh(mine, P, use_shift=shift,
                              shard_levels=shard_levels)
    assert len(got.levels) == len(ref.levels)
    assert len(got.coarse_levels) == len(ref.coarse_levels)
    for a, b in zip(got.levels, ref.levels):
        assert_levels_equal(a, b)
    if shift:
        assert got.level0.shift_deltas


def test_auto_rule_and_clamp():
    """shard_levels=0 shards while a level keeps AUTO_NODES_PER_SHARD (4096,
    mgcfd_tpu's proxy, not measured on the card) nodes a shard; a request
    beyond L - 1 is clamped."""
    mesh = generate_multigrid_box(24, 22, 22, 3, h=H)
    assert part.AUTO_NODES_PER_SHARD == 4096
    assert len(part.partition_mesh(mesh, 2, shard_levels=0).levels) == 1
    assert len(part.partition_mesh(mesh, 2, shard_levels=5).levels) == 2
    tall = generate_multigrid_box(34, 34, 34, 3, h=H)   # level 1: 17^3
    assert [part.num_sharded_levels(tall, P, 0) for P in (1, 2)] == [2, 1]


def test_partition_order_2d_equals_jax():
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(1000, 3))
    for P, shape in ((8, (4, 2)), (6, None), (4, None)):
        np.testing.assert_array_equal(
            part.partition_order_2d(coords, P, shape),
            jax_part.partition_order_2d(coords, P, shape))
    with pytest.raises(ValueError, match="shards"):
        part.partition_order_2d(coords, 4, (3, 2))


def _global_halves(csr, sl, p):
    """A shard CSR's entries as global (owner, neighbour, weights)."""
    B, smax = sl.part_width, sl.smax
    owner = csr.owner + p * B
    col = csr.col.astype(np.int64)
    pool = col >= B
    sec, rank = (col - B) // smax, (col - B) % smax
    nbr = np.where(pool, sec * B + sl.sep_idx[np.clip(sec, 0, sl.P - 1),
                                              rank], col + p * B)
    return owner, nbr, csr.w


def test_shard_csrs_against_the_single_device_plans(meshes):
    """At P = 1 each shard CSR is the single device's plan; at P = 4 the
    shards' flux halves are the flux CSR's, their restriction partial sums
    add up to the mean, and their prolongation rows are the plan's."""
    _, _, mesh = meshes
    lvl, nxt = mesh.levels[0], mesh.levels[1]
    one = part.partition_mesh(mesh, 1).levels[0]
    ref = build_flux_csr(lvl)
    got = part.shard_flux_csr(lvl, one, 0)
    assert got.num_cols == lvl.num_nodes + 1     # one (unused) pool slot
    for f in ("row_ptr", "owner", "col", "w"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    full_p = build_prolong_csr(lvl, nxt)
    sm = part.partition_mesh(mesh, 4)
    sl = sm.level0
    halves, rows, wsum = [], [], 0
    x = np.random.default_rng(0).standard_normal(lvl.num_nodes)
    for p in range(4):
        c = part.shard_flux_csr(lvl, sl, p)
        assert (c.num_rows, c.num_cols) == (sl.block,
                                            sl.block + 4 * sl.smax)
        o, n, w = _global_halves(c, sl, p)
        halves.append(np.concatenate([o[None], n[None], w]))
        r = part.shard_restrict_csr(lvl, sl, None, p)
        lo, hi = sl.bounds(p)
        xs = np.zeros(sl.block)
        xs[:hi - lo] = x[lo:hi]
        wsum = wsum + np.bincount(r.owner, weights=r.w[0] * xs[r.col],
                                  minlength=r.num_rows)
        pr = part.shard_prolong_csr(full_p, sl, p)
        rows.append(np.concatenate([pr.owner[None] + lo, pr.col[None],
                                    pr.w]))
    mine = np.concatenate(halves, axis=1)
    want = np.concatenate([ref.owner[None], ref.col[None], ref.w])
    key = np.lexsort(mine[::-1])
    np.testing.assert_array_equal(mine[:, key],
                                  want[:, np.lexsort(want[::-1])])
    rplan, _ = build_restrict_csr(lvl.mg_mapping, lvl.num_nodes,
                                  nxt.num_nodes)
    mean = np.bincount(rplan.owner, weights=rplan.w[0] * x[rplan.col],
                       minlength=rplan.num_rows)
    np.testing.assert_allclose(wsum, mean, rtol=1e-14, atol=1e-15)
    np.testing.assert_array_equal(
        np.concatenate(rows, axis=1),
        np.concatenate([full_p.owner[None], full_p.col[None], full_p.w]))


def test_edge_csr_takes_a_wider_neighbour_space():
    """flux and rw modes over [block | pool]: the owners' values from
    `own`, the plain versions equal to a single-device evaluation on the
    gathered state; what the kernels do not take is refused."""
    mesh = generate_multigrid_box(8, 6, 6, 1, h=H)
    lvl = mesh.levels[0]
    sl = part.partition_mesh(mesh, 2).level0
    rng = np.random.default_rng(1)
    q = torch.as_tensor(np.array([1.4, 0.5, 0.1, 0.0, 3.0])[:, None]
                        * (1 + 0.05 * rng.standard_normal(
                            (5, lvl.num_nodes))))
    ref = {m: getattr(edge_csr, m)(DeviceCSR.from_plan(
        build_flux_csr(lvl), "cpu", torch.float64), q) for m in ("flux",
                                                               "rw")}
    for p in range(2):
        lo, hi = sl.bounds(p)
        csr = DeviceCSR.from_plan(part.shard_flux_csr(lvl, sl, p), "cpu",
                                  torch.float64)
        blk = q[:, lo:lo + sl.block].contiguous()
        pool = torch.stack([q[:, s * sl.block + torch.as_tensor(
            sl.sep_idx[s], dtype=torch.int64)] for s in range(2)], dim=1)
        comb = torch.cat([blk, pool.reshape(5, -1)], dim=1)
        for m in ("flux", "rw"):
            got = getattr(edge_csr, m)(csr, comb, blk)
            torch.testing.assert_close(got[:, :hi - lo], ref[m][:, lo:hi],
                                       rtol=1e-13, atol=1e-15)
        with pytest.raises(ValueError, match="own"):
            edge_csr.flux(csr, comb)
        with pytest.raises(ValueError, match="own"):
            edge_csr.flux(csr, comb, comb[:, :-1].contiguous())
        with pytest.raises(ValueError, match="own"):
            edge_csr.restrict(csr, comb, blk)
        narrow = DeviceCSR(csr.num_cols, csr.num_rows, csr.row_ptr, csr.col,
                           csr.owner, csr.w)
        with pytest.raises(ValueError, match="first columns"):
            edge_csr.flux(narrow, blk)
        with pytest.raises(ValueError, match="coincide"):
            fused_stage(csr, boundary_rows(torch.zeros((11, sl.block),
                                                       dtype=q.dtype)),
                        comb, blk, torch.ones(sl.block, dtype=q.dtype))


def test_partitions_through_the_plan_cache(tmp_path):
    """partition_mesh stores each sharded level in the plan cache and
    loads it back equal, None fields and span lists included."""
    mesh = generate_multigrid_box(10, 8, 8, 3, h=H)
    spans.reset()
    a = part.partition_mesh(mesh, 4, use_shift=True, shard_levels=2,
                            plan_cache_dir=str(tmp_path))
    assert spans.counters("plans.built.")["torch-partition-P4"] == 2
    b = part.partition_mesh(mesh, 4, use_shift=True, shard_levels=2,
                            plan_cache_dir=str(tmp_path))
    assert spans.counters("plans.loaded.")["torch-partition-P4"] == 2
    for x, y in zip(a.levels, b.levels):
        assert_levels_equal(x, y)
