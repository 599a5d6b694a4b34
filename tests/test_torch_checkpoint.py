"""Checkpoints and resume (utils/checkpoint.py) across the two packages,
at fp64 on the CPU: a checkpoint written by either package resumes in the
other, and the continuation matches an uninterrupted run within
identify_differences (relative 1e-8, absolute floor 1e-15: FVCORR)."""
import numpy as np
import pytest
import torch

from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.solver import MGCFDSolver as JaxSolver
from mgcfd_tpu.utils.checkpoint import _fingerprint as jax_fingerprint
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.monitor import opstats
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.utils.checkpoint import (_fingerprint, latest_checkpoint,
                                              load_checkpoint)
from mgcfd_tpu_torch.validate import identify_differences

torch.set_num_threads(1)
VARIANT = MeshVariant.FVCORR
_MESHES: dict = {}
_STRAIGHT: dict = {}


def jax_mesh(kind):
    if kind not in _MESHES:
        v = JaxVariant.FVCORR
        _MESHES[kind] = (
            jax_mg_box(8, 8, 8, 2, h=(0.1, 0.1, 0.1), variant=v)
            if kind == "box" else jax_tet(8, 8, 8, 2, seed=1, h=0.1,
                                          variant=v))
    return _MESHES[kind]


def straight(kind):
    """JAX's uninterrupted run of 3 cycles."""
    if kind not in _STRAIGHT:
        s = JaxSolver(jax_mesh(kind), JaxConfig(dtype="float64"))
        s.run(3)
        _STRAIGHT[kind] = s
    return _STRAIGHT[kind]


def port(kind, dtype="float64", **kw):
    return MGCFDSolver(mesh_from_arrays(jax_mesh(kind)),
                       SolverConfig(dtype=dtype, **kw), device="cpu")


def same(s, ref, rms_from=0):
    identify_differences(np.array(s.rms_history),
                         np.array(ref.rms_history[rms_from:]), VARIANT)
    for lev in range(2):
        identify_differences(s.variables(lev), ref.variables(lev), VARIANT)


@pytest.mark.parametrize("path", ["segment", "window"])
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_jax_writes_the_port_resumes(tmp_path, kind, path):
    d = str(tmp_path)
    JaxSolver(jax_mesh(kind), JaxConfig(
        dtype="float64", checkpoint_dir=d, checkpoint_every=1)).run(2)
    s = port(kind, accumulate=path, checkpoint_dir=d, resume=True)
    ref = straight(kind)
    assert s.completed_cycles == 2
    identify_differences(np.array(s.rms_history),
                         np.array(ref.rms_history[:2]), VARIANT)
    s.run(1)
    same(s, ref)


@pytest.mark.parametrize("path", ["segment", "window"])
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_port_writes_jax_resumes(tmp_path, kind, path):
    d = str(tmp_path)
    port(kind, accumulate=path, checkpoint_dir=d, checkpoint_every=1).run(2)
    j = JaxSolver(jax_mesh(kind), JaxConfig(dtype="float64",
                                            checkpoint_dir=d, resume=True))
    assert j.completed_cycles == 2
    j.run(1)
    same(j, straight(kind))


@pytest.mark.parametrize("path", ["segment", "window", "pallas"])
def test_resume_is_bit_equal_within_the_port(tmp_path, path):
    """run(2) with a checkpoint a cycle, then a new solver resumed from
    the latest one runs one more: every level's state and the RMS history
    equal run(3) bit for bit (float32, the kernels' path's dtype)."""
    d = str(tmp_path)
    kw = dict(dtype="float32", accumulate=path)
    a = MGCFDSolver(mesh_from_arrays(jax_mesh("tet")), SolverConfig(
        checkpoint_dir=d, checkpoint_every=1, **kw), device="cpu")
    a.run(2)
    b = MGCFDSolver(mesh_from_arrays(jax_mesh("tet")), SolverConfig(
        checkpoint_dir=d, resume=True, **kw), device="cpu")
    a.run(1)
    b.run(1)
    assert a.completed_cycles == b.completed_cycles == 3
    assert a.rms_history == b.rms_history
    for key in ("variables", "residuals"):
        for x, y in zip(a.state[key], b.state[key]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["box", "tet"])
def test_fingerprints_are_equal_strings(kind):
    jm = jax_mesh(kind)
    assert _fingerprint(mesh_from_arrays(jm)) == jax_fingerprint(jm)


def test_mismatched_mesh_raises(tmp_path):
    d = str(tmp_path)
    port("box", checkpoint_dir=d, checkpoint_every=1).run(1)
    with pytest.raises(ValueError, match="different problem"):
        port("tet", checkpoint_dir=d, resume=True)
    with pytest.raises(ValueError, match="different problem"):
        load_checkpoint(latest_checkpoint(d),
                        mesh_from_arrays(jax_mesh("tet")), torch.float64)


def test_cadence_writes_the_expected_files(tmp_path):
    """checkpoint_every=2 over 5 cycles of run writes cycles 2 and 4 (the
    npz keys and names of mgcfd_tpu); run_batched writes none, as in
    mgcfd_tpu; a measurement's extra cycle writes none; resume without a
    checkpoint starts from cycle 0."""
    d = tmp_path / "run"
    s = port("box", checkpoint_dir=str(d), checkpoint_every=2)
    s.run(5)
    assert sorted(p.name for p in d.iterdir()) == ["ckpt-000002.npz",
                                                    "ckpt-000004.npz"]
    z = np.load(d / "ckpt-000004.npz")
    assert sorted(z.files) == sorted(
        ["cycle", "fingerprint", "num_levels", "rms_history"]
        + [f"{k}_{i}" for k in ("variables", "residuals") for i in range(2)])
    assert int(z["cycle"]) == 4 and z["rms_history"].shape == (4,)
    assert z["variables_0"].shape == (512, 5)
    opstats.measure_production(s, cycles=1)
    assert len(list(d.iterdir())) == 2
    b = tmp_path / "batched"
    port("box", checkpoint_dir=str(b), checkpoint_every=2).run_batched(4, 2)
    assert not b.exists() or not list(b.iterdir())
    fresh = port("box", checkpoint_dir=str(tmp_path / "none"), resume=True)
    assert fresh.completed_cycles == 0 and fresh.rms_history == []


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_checkpoints_across_packages(tmp_path, writer):
    """A bf16 state crosses in both directions: mgcfd_tpu stores its
    ml_dtypes bfloat16 as raw 2-byte records, the port widened to
    float32; either resumes to the writer's bits."""
    d = str(tmp_path)
    kw = dict(dtype="bfloat16", accumulate="segment")
    if writer == "jax":
        w = JaxSolver(jax_mesh("box"), JaxConfig(
            checkpoint_dir=d, checkpoint_every=1, **kw))
        w.run(1)
        want = [np.asarray(w.state["variables"][i], np.float32)
                for i in range(2)]
        r = port("box", checkpoint_dir=d, resume=True, **kw)
        got = [r.state["variables"][i].float().numpy() for i in range(2)]
    else:
        w = port("box", checkpoint_dir=d, checkpoint_every=1, **kw)
        w.run(1)
        want = [w.state["variables"][i].float().numpy() for i in range(2)]
        r = JaxSolver(jax_mesh("box"), JaxConfig(checkpoint_dir=d,
                                                 resume=True, **kw))
        got = [np.asarray(r.state["variables"][i], np.float32)
               for i in range(2)]
    assert r.completed_cycles == 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_bf16_checkpoint_is_float32(tmp_path):
    """numpy holds no bfloat16: a bf16 state is stored widened to
    float32, which is exact, and resumes to the same bits."""
    d = str(tmp_path)
    kw = dict(dtype="bfloat16", accumulate="window")
    a = MGCFDSolver(mesh_from_arrays(jax_mesh("box")), SolverConfig(
        checkpoint_dir=d, checkpoint_every=1, **kw), device="cpu")
    a.run(1)
    assert np.load(latest_checkpoint(d))["variables_0"].dtype == np.float32
    b = MGCFDSolver(mesh_from_arrays(jax_mesh("box")), SolverConfig(
        checkpoint_dir=d, resume=True, **kw), device="cpu")
    for x, y in zip(a.state["variables"], b.state["variables"]):
        assert torch.equal(x, y)
