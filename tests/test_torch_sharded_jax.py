"""The port's sharded solver against mgcfd_tpu's ShardedSolver on its 8
virtual CPU devices, every level within identify_differences (relative
1e-8; mgcfd_tpu's own tolerance against the reference binary): multigrid
at P = 8, 'window' on an unstructured tet at P = 2, and shard_levels=2 at
P = 4. Each mgcfd_tpu configuration compiles once for this module."""
import jax
import numpy as np
import pytest
import torch

import sharded_ranks as ranks
from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.parallel import ShardedSolver as JaxSharded
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.validate import identify_differences

torch.set_num_threads(1)
H = (0.1, 0.1, 0.1)
CASES = {
    # name: (mesh builder, P, config, cycles)
    "multigrid_P8": (lambda: jax_mg_box(8, 8, 8, 3, h=H, volume_jitter=0.2,
                                        variant=JaxVariant.FVCORR),
                     8, {}, 3),
    "tet_window_P2": (lambda: jax_tet(11, 10, 10, 2, seed=3), 2,
                      {"accumulate": "window"}, 2),
    "shard_levels2_P4": (lambda: jax_mg_box(16, 12, 12, 3, h=H,
                                            volume_jitter=0.2,
                                            variant=JaxVariant.FVCORR),
                         4, {"accumulate": "segment", "shard_levels": 2}, 3),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_run(request):
    if len(jax.devices()) < 8:
        pytest.skip("needs mgcfd_tpu's 8 virtual devices")
    build, P, cfg, cycles = CASES[request.param]
    jm = build()
    s = JaxSharded(jm, JaxConfig(dtype="float64", num_partitions=P, **cfg))
    s.run(cycles)
    return jm, P, cfg, cycles, s


def test_sharded_matches_jax_sharded(jax_run, tmp_path):
    jm, P, cfg, cycles, ref = jax_run
    mesh = mesh_from_arrays(jm)
    out = tmp_path / "got.npz"
    ranks.launch(ranks.solve, P, mesh,
                 dict(cfg, dtype="float64", num_partitions=P), cycles,
                 str(out))
    got = ranks.load(out)
    assert int(got["sharded_levels"]) == len(ref.smesh.levels)
    for lev in range(mesh.num_levels):
        assert identify_differences(got[f"arr_{lev}"],
                                    np.asarray(ref.variables(lev)),
                                    mesh.variant, raise_on_fail=False) == 0
    assert identify_differences(got["rms"], np.asarray(ref.rms_history),
                                mesh.variant, raise_on_fail=False) == 0
