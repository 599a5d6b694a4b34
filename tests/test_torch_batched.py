"""MGCFDSolver.run_batched of the port on the CPU, where a batch is the
eager loop (on CUDA it is one replay of a captured CUDA graph, held to run
on the card by chip_smoke.py).

run_batched(7, 3) (two batches of 3 and a tail of 1 through run) equals
run(7) bit for bit on the kernel paths and the plain path, at fp64, fp32
and bf16, on a 5x5x5 2-level box (FVCORR) and a 6^3 2-level tet (M6 wing),
each from a perturbed state. Against mgcfd_tpu's run_batched at fp64: the
per-cycle RMS and every level's variables within identify_differences
(relative 1e-8). The NaN guard raises once per batch and names it, as
mgcfd_tpu's does."""
import numpy as np
import pytest
import torch

from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.core.types import MultigridMesh as JaxMultigridMesh
from mgcfd_tpu.mesh import generate_box_mesh as jax_box_level
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.solver import MGCFDSolver as JaxSolver
from mgcfd_tpu_torch.convert import mesh_from_arrays, state_from_arrays
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import MeshVariant, far_field_state
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.validate import identify_differences

torch.set_num_threads(1)
PATHS = ("segment", "window", "pallas")
DTYPES = ("float64", "float32", "bfloat16")
_JAX_MESHES: dict = {}


def jax_mesh(kind):
    if kind not in _JAX_MESHES:
        _JAX_MESHES[kind] = (
            jax_mg_box(5, 5, 5, 2, h=(0.1, 0.1, 0.1),
                       variant=JaxVariant.FVCORR)
            if kind == "box" else jax_tet(6, 6, 6, 2, seed=1, h=0.1))
    return _JAX_MESHES[kind]


def start_state(mesh, seed=3):
    """The far field with 1% seeded relative noise, node-major."""
    rng = np.random.default_rng(seed)
    ff = far_field_state()[0]
    return state_from_arrays(
        [ff * (1.0 + 0.01 * rng.standard_normal((lv.num_nodes, 5)))
         for lv in mesh.levels],
        [np.zeros((lv.num_nodes, 5)) for lv in mesh.levels])


def port(kind, path, dtype, start=True):
    mesh = mesh_from_arrays(jax_mesh(kind))
    s = MGCFDSolver(mesh, SolverConfig(dtype=dtype, accumulate=path),
                    device="cpu")
    if start:
        s.load_state(start_state(mesh))
    return s


def assert_same_run(a, b):
    for key in ("variables", "residuals"):
        for x, y in zip(a.state[key], b.state[key]):
            assert torch.equal(x, y)
    assert a.rms_history == b.rms_history
    assert a.completed_cycles == b.completed_cycles


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_batched_equals_run(kind, path, dtype):
    a, b = port(kind, path, dtype), port(kind, path, dtype)
    a.run(7)
    b.run_batched(7, 3)
    assert b.completed_cycles == 7 and len(b.rms_history) == 7
    assert_same_run(a, b)
    assert max(b.rms_history) > 0


@pytest.mark.parametrize("cycles,k", [(2, 10), (5, 1), (6, 3), (0, 4),
                                      (3, 0)])
def test_batch_sizes(cycles, k):
    """K = max(1, min(cycles_per_dispatch, cycles)): one batch when K
    reaches the cycles, single cycles at K = 1, no tail when K divides,
    nothing for 0 cycles, K = 1 for cycles_per_dispatch 0."""
    a, b = port("box", "window", "float64"), port("box", "window", "float64")
    a.run(cycles)
    b.run_batched(cycles, k)
    assert_same_run(a, b)
    assert len(b.rms_history) == cycles


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_batched_matches_jax(kind, path):
    """The port's run_batched against mgcfd_tpu's (K cycles in one
    lax.scan) from the same state at fp64."""
    jm = jax_mesh(kind)
    ref = JaxSolver(jm, JaxConfig(dtype="float64"))
    st = start_state(jm)
    ref.state = {k: [np.asarray(a) for a in v] for k, v in st.items()}
    ref.run_batched(7, 3)
    s = port(kind, path, "float64")
    s.run_batched(7, 3)
    assert s.completed_cycles == ref.completed_cycles == 7
    variant = MeshVariant[jm.variant.name]
    identify_differences(np.array(s.rms_history),
                         np.array(ref.rms_history), variant)
    for lev in range(jm.num_levels):
        identify_differences(s.variables(lev), ref.variables(lev), variant)


def poisoned_mesh():
    """tests/test_solver.py's poisoned mesh: an enormous edge weight drives
    the state invalid."""
    lvl = jax_box_level(3, 3, 3)
    lvl.edge_w = lvl.edge_w * 1e30
    return JaxMultigridMesh(levels=[lvl], variant=JaxVariant.FVCORR)


@pytest.mark.parametrize("path", PATHS)
def test_nan_guard_names_the_batch(path):
    """One check per batch: the first batch of 3 raises, naming cycles
    1..3, as mgcfd_tpu's run_batched does on the same mesh."""
    jm = poisoned_mesh()
    s = MGCFDSolver(mesh_from_arrays(jm),
                    SolverConfig(dtype="float64", accumulate=path),
                    device="cpu")
    with pytest.raises(FloatingPointError,
                       match=r"within cycles 1\.\.3: \d+ bad entries"):
        s.run_batched(6, 3)
    assert s.completed_cycles == 3 and s.rms_history == []
    if path == "segment":
        ref = JaxSolver(jm, JaxConfig(dtype="float64"))
        with pytest.raises(FloatingPointError,
                           match=r"within cycles 1\.\.3: \d+ bad entries"):
            ref.run_batched(6, 3)


def test_cpu_run_batched_never_touches_cuda(monkeypatch):
    """On device='cpu' a batch is the eager loop: no graph, stream or
    capture is asked for."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda used on the CPU path")
    for name in ("CUDAGraph", "graph", "Stream", "stream",
                 "current_stream", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    s = port("tet", "window", "float32")
    s.run_batched(5, 2)
    assert s.completed_cycles == 5 and s._graph is None
