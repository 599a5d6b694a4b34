"""The fp64 reference V-cycle agrees with the port's CPU path (the plain
edge-stream ops) on a small box in (i, j, k) and in RCM order, and on a
small tetrahedral hierarchy in RCM order (nearest-node maps that leave
coarse nodes without a child), read from the same files by each side's
own reader."""
import numpy as np
import pytest

from cfdbench.inputs.datfiles import read_hierarchy
from cfdbench.inputs.make import ensure
from cfdbench.reference import ReferenceSolver
from cfdbench.state import initial_state
from cfdbench.tests.conftest import tiny_config, tiny_tet_config

from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.mesh.io_dat import load_multigrid_mesh
from mgcfd_tpu_torch.solver import MGCFDSolver


@pytest.mark.parametrize("kind", ["box", "rcm", "tet"])
def test_reference_agrees_with_the_port(kind, tmp_path):
    cfg = tiny_tet_config() if kind == "tet" else tiny_config(kind)
    path = ensure(cfg["mesh"], str(tmp_path / "mesh"))
    mesh = load_multigrid_mesh(path)
    s0 = initial_state([lv.num_nodes for lv in mesh.levels], 5,
                       cfg["state"])
    port = MGCFDSolver(mesh, SolverConfig(dtype="float64"), device="cpu")
    port.load_state(s0)
    port.run(4)
    ref = ReferenceSolver(read_hierarchy(path)).run(s0, 4)
    np.testing.assert_allclose(port.rms_history, ref["rms"], rtol=1e-12)
    for lev in range(len(mesh.levels)):
        change = np.abs(ref["variables"][lev] - s0["variables"][lev]).max()
        assert change > 0
        np.testing.assert_allclose(port.variables(lev),
                                   ref["variables"][lev], rtol=0,
                                   atol=1e-12 * change)
