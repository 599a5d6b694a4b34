"""The sharded solver (mgcfd_tpu_torch/parallel/) over gloo ranks on the
CPU against the single-device port: the cases of mgcfd_tpu's
tests/test_parallel.py at its tolerances (rtol 1e-11 / atol 1e-15 on one
level, rtol 1e-10 / atol 1e-14 with multigrid, the RMS histories at 1e-9
/ 1e-8), every level compared, plus the bf16 path within one bf16 spacing
and run_batched under gloo. Each case starts its ranks from one
forkserver (tests/sharded_ranks.py) and reads rank 0's npz."""
import numpy as np
import pytest
import torch

import sharded_ranks as ranks
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.core.types import MultigridMesh
from mgcfd_tpu_torch.mesh import (generate_box_mesh, generate_multigrid_box,
                                  generate_unstructured_hierarchy)
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.validate.rounding import bf16_agreement

torch.set_num_threads(1)
H = (0.1, 0.1, 0.1)


def single_device(mesh, cycles, **cfg):
    s = MGCFDSolver(mesh, SolverConfig(**cfg), device="cpu")
    s.run(cycles)
    return s


def sharded(tmp_path, mesh, cycles, P, **cfg):
    out = tmp_path / f"P{P}.npz"
    ranks.launch(ranks.solve, P, mesh,
                 dict(cfg, num_partitions=P), cycles, str(out))
    return ranks.load(out)


def assert_levels(got, ref, levels, rtol, atol):
    for lev in range(levels):
        np.testing.assert_allclose(got[f"arr_{lev}"], ref.variables(lev),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"level {lev}")


def fvcorr_level():
    lvl = generate_box_mesh(8, 6, 6, h=H, volume_jitter=0.2)
    return MultigridMesh(levels=[lvl], variant=MeshVariant.FVCORR)


@pytest.mark.parametrize("P", [2, 8])
def test_single_level_matches_single_device(tmp_path, P):
    mesh = fvcorr_level()
    ref = single_device(mesh, 4, dtype="float64")
    got = sharded(tmp_path, mesh, 4, P, dtype="float64")
    assert str(got["accumulate"]) == "segment"
    assert_levels(got, ref, 1, 1e-11, 1e-15)
    np.testing.assert_allclose(got["rms"], ref.rms_history, rtol=1e-9)


def test_corrected_step_factor_min(tmp_path):
    """M6's corrected step factor: the global min is an all_reduce MIN."""
    lvl = generate_box_mesh(8, 6, 6, h=H, volume_jitter=0.4)
    mesh = MultigridMesh(levels=[lvl], variant=MeshVariant.M6_WING)
    ref = single_device(mesh, 3, dtype="float64")
    got = sharded(tmp_path, mesh, 3, 4, dtype="float64")
    assert_levels(got, ref, 1, 1e-11, 1e-15)


def test_multigrid_matches_single_device(tmp_path):
    mesh = generate_multigrid_box(8, 8, 8, 3, h=H, volume_jitter=0.2,
                                  variant=MeshVariant.FVCORR)
    ref = single_device(mesh, 3, dtype="float64")
    got = sharded(tmp_path, mesh, 3, 8, dtype="float64")
    assert_levels(got, ref, 3, 1e-10, 1e-14)
    np.testing.assert_allclose(got["rms"], ref.rms_history, rtol=1e-8)


@pytest.mark.parametrize("kind", ["box", "tet"])
def test_window_path_cross_shard(tmp_path, kind):
    """'window': the edge_csr kernels' plain versions over each rank's
    owner CSR of [block | pool], live separators, the rw twin included;
    the replicated level through fused_stage. On the CPU the single
    device's window path computes the same sums in the same order."""
    if kind == "box":
        mesh = generate_multigrid_box(16, 12, 12, 2, h=H, volume_jitter=0.2,
                                      variant=MeshVariant.FVCORR)
        cycles = 3
    else:
        mesh = generate_unstructured_hierarchy(11, 10, 10, 2, seed=3)
        cycles = 2
    ref = single_device(mesh, cycles, dtype="float64", accumulate="window")
    got = sharded(tmp_path, mesh, cycles, 2, dtype="float64",
                  accumulate="window")
    assert got["sep"] > 0
    assert_levels(got, ref, 2, 1e-10, 1e-14)
    np.testing.assert_allclose(got["rms"], ref.rms_history, rtol=1e-8)


@pytest.mark.parametrize("acc", ["segment", "shift", "pallas"])
def test_stream_and_span_modes(tmp_path, acc):
    """'segment' (the reduce-scatter return leg), 'shift' (span diagonals
    of the shard-local edges plus the stream) and 'pallas' (the CSR
    kernels on the sharded level, the span kernels' plain versions on the
    replicated ones) at P = 4."""
    mesh = generate_multigrid_box(8, 6, 6, 3, h=H, volume_jitter=0.2,
                                  variant=MeshVariant.FVCORR)
    ref = single_device(mesh, 3, dtype="float64")
    got = sharded(tmp_path, mesh, 3, 4, dtype="float64", accumulate=acc)
    assert str(got["accumulate"]) == acc
    assert_levels(got, ref, 3, 1e-10, 1e-14)


@pytest.mark.parametrize("acc", ["segment", "window"])
def test_two_sharded_levels(tmp_path, acc):
    """shard_levels=2: level 1 sharded too; the restriction lands on its
    owners by one reduce-scatter, the prolongation gathers its blocks."""
    mesh = generate_multigrid_box(16, 12, 12, 3, h=H, volume_jitter=0.2,
                                  variant=MeshVariant.FVCORR)
    ref = single_device(mesh, 3, dtype="float64")
    got = sharded(tmp_path, mesh, 3, 4, dtype="float64", accumulate=acc,
                  shard_levels=2)
    assert int(got["sharded_levels"]) == 2
    assert_levels(got, ref, 3, 1e-10, 1e-14)
    np.testing.assert_allclose(got["rms"], ref.rms_history, rtol=1e-8)


@pytest.mark.parametrize("acc", ["segment", "window"])
def test_partition_2d(tmp_path, acc):
    """partition_2d='2x2': a node order under which the blocks are tiles;
    the state comes back in the caller's order."""
    mesh = generate_multigrid_box(12, 12, 10, 3, h=H, volume_jitter=0.2,
                                  variant=MeshVariant.FVCORR)
    ref = single_device(mesh, 3, dtype="float64")
    got = sharded(tmp_path, mesh, 3, 4, dtype="float64", accumulate=acc,
                  partition_2d="2x2")
    assert bool(got["partitioned_2d"])
    assert_levels(got, ref, 3, 1e-10, 1e-14)
    np.testing.assert_allclose(got["rms"], ref.rms_history, rtol=1e-8)


def test_flux_cripple(tmp_path):
    """The crippled twin runs before each stage's flux and is discarded."""
    mesh = generate_multigrid_box(16, 8, 8, 2, h=H,
                                  variant=MeshVariant.FVCORR)
    ref = single_device(mesh, 2, dtype="float64")
    got = sharded(tmp_path, mesh, 2, 2, dtype="float64",
                  accumulate="window", flux_cripple=True)
    assert_levels(got, ref, 2, 1e-10, 1e-14)


def test_bf16_within_one_spacing(tmp_path):
    """bf16 at P = 2 on 'window' with the stages unfused (the sharded
    level's ops on every level) against the single device's, every level
    within one bf16 spacing (on the CPU they are bit-equal)."""
    mesh = generate_multigrid_box(8, 8, 8, 3, h=H, volume_jitter=0.2,
                                  variant=MeshVariant.FVCORR)
    ref = single_device(mesh, 2, dtype="bfloat16", accumulate="window",
                        fuse_window_stage=False)
    out = tmp_path / "bf16.npz"
    ranks.launch(ranks.bf16_pair, 2, mesh,
                 dict(dtype="bfloat16", accumulate="window",
                      fuse_window_stage=False, num_partitions=2), 2,
                 str(out))
    got = ranks.load(out)
    for lev in range(3):
        want = ref._node_major(ref.state["variables"][lev])
        ratio, _ = bf16_agreement(torch.as_tensor(got[f"arr_{lev}"]).T,
                                  want.float().T)
        assert ratio <= 1.0, f"level {lev}: {ratio:.3f} spacings apart"


def test_run_batched_under_gloo_is_run(tmp_path):
    """Under gloo run_batched loops cycle(): bit-equal to run."""
    mesh = generate_multigrid_box(8, 8, 8, 2, h=H,
                                  variant=MeshVariant.FVCORR)
    cfg = dict(dtype="float64", accumulate="window", num_partitions=2)
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    ranks.launch(ranks.solve, 2, mesh, cfg, 5, str(a))
    ranks.launch(ranks.solve, 2, mesh, cfg, 5, str(b), 2)
    a, b = ranks.load(a), ranks.load(b)
    for lev in range(2):
        np.testing.assert_array_equal(a[f"arr_{lev}"], b[f"arr_{lev}"])
    np.testing.assert_array_equal(a["rms"], b["rms"])


def test_ranks_share_a_cold_plan_cache(tmp_path):
    """Four ranks build the same plans at once into one empty plan cache
    (the replicated levels' plans, each rank's own shard CSRs): every
    writer renames its own temporary file, so none fails and the cache
    ends with whole files only; the run matches the single device."""
    mesh = generate_multigrid_box(12, 12, 10, 3, h=H, volume_jitter=0.2,
                                  variant=MeshVariant.FVCORR)
    plans = tmp_path / "plans"
    ref = single_device(mesh, 2, dtype="float64", accumulate="window")
    got = sharded(tmp_path, mesh, 2, 4, dtype="float64",
                  accumulate="window", plan_cache_dir=str(plans))
    assert_levels(got, ref, 3, 1e-10, 1e-14)
    names = [f.name for f in plans.iterdir()]
    assert any(n.startswith("torch-flux-") for n in names)
    assert not [n for n in names if ".tmp" in n]


def test_refuses_a_group_of_another_size(tmp_path):
    mesh = fvcorr_level()
    with pytest.raises(RuntimeError, match="failed"):
        ranks.launch(ranks.solve, 2, mesh,
                     dict(dtype="float64", num_partitions=3), 1,
                     str(tmp_path / "x.npz"))


def test_needs_a_process_group():
    from mgcfd_tpu_torch.parallel import ShardedSolver
    with pytest.raises(RuntimeError, match="process group"):
        ShardedSolver(fvcorr_level(), SolverConfig(num_partitions=2),
                      device="cpu")
