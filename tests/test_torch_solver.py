"""The port's solver against mgcfd_tpu.MGCFDSolver at fp64 on the CPU.

Both start from identical arrays (convert.mesh_from_arrays). The JAX leg
is SolverConfig(dtype="float64"), which `auto` sends to its segment path
on the CPU. The port runs its plain edge-stream path ('segment'), its
kernel paths ('window' and 'pallas', fused and unfused), whose wrappers
take the plain versions for CPU tensors, and its plain span paths
('shift', node-major and transposed). On the tet almost every edge of
the span paths is a spill edge. Per-cycle RMS and final level-0
variables are
held to identify_differences (validate/golden.py:93-112): relative 1e-8,
absolute floor 1e-15 for FVCORR and 3e-19 otherwise."""
import numpy as np
import pytest
import torch

from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.solver import MGCFDSolver as JaxSolver
from mgcfd_tpu_torch.convert import mesh_from_arrays, state_from_arrays
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.validate import identify_differences

torch.set_num_threads(1)
CYCLES = 3
PATHS = {"segment": {"accumulate": "segment"},
         "window": {"accumulate": "window"},
         "window-unfused": {"accumulate": "window",
                            "fuse_window_stage": False},
         "pallas": {"accumulate": "pallas"},
         "pallas-unfused": {"accumulate": "pallas", "fuse_stage": False},
         "shift": {"accumulate": "shift"},
         "shift-transposed": {"accumulate": "shift", "transposed": True}}
NODE_MAJOR = ("segment", "shift")
_JAX_RUNS: dict = {}


def jax_mesh(kind, variant):
    v = JaxVariant[variant.name]
    if kind == "box":
        return jax_mg_box(12, 12, 12, 3, h=(0.1, 0.1, 0.1), variant=v)
    return jax_tet(12, 12, 12, 3, seed=1, h=0.1, variant=v)


def jax_run(kind, variant):
    """(mesh, solver after CYCLES cycles), computed once per module."""
    key = (kind, variant)
    if key not in _JAX_RUNS:
        mesh = jax_mesh(kind, variant)
        s = JaxSolver(mesh, JaxConfig(dtype="float64"))
        s.run(CYCLES)
        _JAX_RUNS[key] = (mesh, s)
    return _JAX_RUNS[key]


def port(mesh, path, **kw):
    return MGCFDSolver(mesh_from_arrays(mesh),
                       SolverConfig(dtype="float64", **PATHS[path], **kw),
                       device="cpu")


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("variant", list(MeshVariant))
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_cycles_match_jax(kind, variant, path):
    mesh, ref = jax_run(kind, variant)
    s = port(mesh, path)
    s.run(CYCLES)
    assert len(s.rms_history) == CYCLES
    identify_differences(np.array(s.rms_history),
                         np.array(ref.rms_history), variant)
    identify_differences(s.variables(0), ref.variables(0), variant)


@pytest.mark.parametrize("path", ["segment", "window", "pallas"])
def test_start_from_a_shared_state(path):
    """state_from_arrays carries a mid-run JAX state into the port; both
    then run on to the same variables, levels and step factors."""
    mesh = jax_mesh("tet", MeshVariant.FVCORR)
    ref = JaxSolver(mesh, JaxConfig(dtype="float64"))
    ref.run(1)
    st = ref._state_node_major()
    s = port(mesh, path)
    s.load_state(state_from_arrays(
        [np.asarray(v) for v in st["variables"]],
        [np.asarray(r) for r in st["residuals"]]))
    ref.run(2)
    s.run(2)
    identify_differences(np.array(s.rms_history),
                         np.array(ref.rms_history[1:]), MeshVariant.FVCORR)
    for lev in range(3):
        identify_differences(s.variables(lev), ref.variables(lev),
                             MeshVariant.FVCORR)
    np.testing.assert_allclose(s.step_factors(0), ref.step_factors(0),
                               rtol=1e-10)


@pytest.mark.parametrize("path", list(PATHS))
def test_nan_guard_raises(path):
    """validation.cpp:107-138: a negative density stops the run."""
    mesh = jax_mg_box(8, 6, 6, 2, h=(0.1, 0.1, 0.1))
    s = port(mesh, path)
    v = s.state["variables"][0]
    if path in NODE_MAJOR:
        v[3, 0] = -5.0
    else:
        v[0, 3] = -5.0
    with pytest.raises(FloatingPointError):
        s.run(1)


def test_accumulate_resolution_and_unported_options():
    """auto on the CPU is the plain path, and with flux_fission it is
    'segment' on CUDA too; 'ell' and 'scatter' run; the sharding fields,
    the TPU-only fields and an unknown dtype are refused; fission on the
    CSR kernels is refused as mgcfd_tpu refuses it."""
    from mgcfd_tpu_torch.solver.solver import resolve_accumulate
    mesh = mesh_from_arrays(jax_mg_box(4, 4, 4, 2))
    cfg = SolverConfig(dtype="float64")
    MGCFDSolver(mesh, cfg, device="cpu")
    assert cfg.accumulate == "segment"      # auto on the CPU
    fission = SolverConfig(flux_fission=True)
    assert resolve_accumulate(mesh, fission, torch.device("cuda")) is None
    assert fission.accumulate == "segment"
    for mode in ("ell", "scatter"):
        s = MGCFDSolver(mesh, SolverConfig(accumulate=mode), device="cpu")
        assert s.config.accumulate == mode
    for kw in ({"num_partitions": 2}, {"window_tile_order": False},
               {"dtype": "float16"}):
        with pytest.raises(NotImplementedError):
            MGCFDSolver(mesh, SolverConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="flux_fission"):
        SolverConfig(flux_fission=True, accumulate="window").validate()


# every field the port once refused, at a value other than its default:
# the sharding fields (item 9) and the TPU-only ones are still refused;
# those of items 4 and 6 (the monitor's: tests/test_torch_monitor.py)
# are ported and taken at any value
UNPORTED = {
    "validate_result": True, "output_variables": True,
    "output_fluxes": True, "output_step_factors": True,
    "output_volumes": True, "output_edge_fluxes": True,
    "flux_fission": True, "flux_cripple": True,
    "flux_precompute_edge_weights": True,
    "checkpoint_dir": "c", "checkpoint_every": 1, "resume": True,
    "window_tile_order": False, "mg_gather": False, "plan_cache_dir": "p",
    "compile_cache_dir": "c", "num_partitions": 2, "partition_2d": "2x2",
    "shard_levels": 2,
}
STILL_REFUSED = ("window_tile_order", "compile_cache_dir", "num_partitions",
                 "partition_2d", "shard_levels")


@pytest.mark.parametrize("field", list(UNPORTED))
def test_unported_field_raises(field):
    """A field whose feature the port lacks is refused by name at any
    value but its default, never silently ignored; a field ported since
    is taken."""
    SolverConfig(**{field: JaxConfig.__dataclass_fields__[field].default}
                 ).validate()
    if field in STILL_REFUSED:
        with pytest.raises(NotImplementedError, match=field):
            SolverConfig(**{field: UNPORTED[field]}).validate()
    else:
        SolverConfig(**{field: UNPORTED[field]}).validate()


@pytest.mark.parametrize("field,value", [
    ("input_file", "mesh.dat"), ("input_file_directory", "d"),
    ("mesh_duplicate_count", 2)])
def test_mesh_file_fields_accepted(field, value):
    """The mesh-file fields (mesh/io_dat.py, mesh/duplicate.py; the CLI's
    -i, -d and -m) are ported and taken at any value."""
    SolverConfig(**{field: value}).validate()


@pytest.mark.parametrize("kind", ["box", "tet"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_resolution(device, kind):
    """auto on CUDA is the span kernels ('pallas') where every level's
    shift plan covers the edges (the box) and the CSR kernels ('window')
    elsewhere (the tet, covered 3-18%), at fp32, fp64 and bf16 alike; on
    the CPU it is the plain path. The plans it builds come back for reuse."""
    from mgcfd_tpu_torch.solver.solver import resolve_accumulate
    mesh = mesh_from_arrays(jax_mesh(kind, MeshVariant.M6_WING))
    for dtype in ("float32", "float64", "bfloat16"):
        cfg = SolverConfig(dtype=dtype)
        plans = resolve_accumulate(mesh, cfg, torch.device(device))
        if device == "cpu":
            assert cfg.accumulate == "segment" and plans is None
        else:
            assert cfg.accumulate == ("pallas" if kind == "box"
                                      else "window")
            assert len(plans) == mesh.num_levels
        explicit = SolverConfig(dtype=dtype, accumulate="window")
        resolve_accumulate(mesh, explicit, torch.device(device))
        assert explicit.accumulate == "window"


def test_step_factors_match_jax_within_one_ulp_at_fp32():
    """The step factor's cube root, taken once per level on the host, is
    what mgcfd_tpu's jnp.cbrt gives: at fp32 on a 20^3 box of the flagship
    family, from one shared state, every step factor is within 1 ulp of
    the JAX package's."""
    jmesh = jax_mg_box(20, 20, 20, 2, h=(0.1, 0.1, 0.1), volume_jitter=0.2,
                       seed=0)
    ref = JaxSolver(jmesh, JaxConfig(dtype="float32", accumulate="segment"))
    ref.run(1)
    st = ref._state_node_major()
    s = MGCFDSolver(mesh_from_arrays(jmesh),
                    SolverConfig(dtype="float32", accumulate="segment"),
                    device="cpu")
    s.load_state(state_from_arrays(
        [np.asarray(v, np.float64) for v in st["variables"]],
        [np.asarray(r, np.float64) for r in st["residuals"]]))
    for lev in range(2):
        want = np.asarray(ref.step_factors(lev), np.float32)
        got = s.step_factors(lev)
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
