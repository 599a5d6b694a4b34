"""mgcfd_tpu_torch stands alone: no jax, no mgcfd_tpu, the card unless
asked otherwise, and no silent fallback from the card to the plain
versions. Also chip_smoke.py's refusal to run without a card or without
the package beside it."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch import kernels
from mgcfd_tpu_torch.kernels import DeviceCSR, boundary_rows, build, edge_csr
from mgcfd_tpu_torch.kernels import fused_stage as fused_mod
from mgcfd_tpu_torch.mesh import generate_multigrid_box
from mgcfd_tpu_torch.prep.csr import build_flux_csr
from mgcfd_tpu_torch.solver import MGCFDSolver

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_package_imports_neither_jax_nor_mgcfd_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mgcfd_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'mgcfd_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'mgcfd_tpu' or k.startswith('mgcfd_tpu.')]\n"
        "assert len(mods) > 20 and not bad, (len(mods), bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_solver_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = generate_multigrid_box(4, 4, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        MGCFDSolver(mesh, SolverConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        MGCFDSolver(mesh, SolverConfig(), device="cuda")


class _FailingLib:
    """Stands in for the kernel library: records each launch and reports
    CUDA error 700 (an illegal address)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            return 700
        return launch


def test_card_tensors_never_take_the_plain_version(monkeypatch):
    """A tensor on the card goes to the kernel or raises: with the device
    test forced to 'card', every wrapper calls the library, raises its
    error and counts no launch; the plain versions are never called."""
    lib = _FailingLib()
    monkeypatch.setattr(edge_csr, "_on_card", lambda t: True)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))

    def no_plain(*a, **k):
        raise AssertionError("plain version called for a card tensor")
    monkeypatch.setattr(edge_csr, "edge_csr_plain", no_plain)
    monkeypatch.setattr(fused_mod, "fused_stage_plain", no_plain)
    lvl = generate_multigrid_box(4, 4, 4, 1).levels[0]
    csr = DeviceCSR.from_plan(build_flux_csr(lvl), "cpu", torch.float64)
    n = lvl.num_nodes
    q = torch.ones((5, n), dtype=torch.float64)
    for w in (edge_csr.flux, edge_csr.rw, edge_csr.restrict):
        before = kernels.launch_counts()[w.name]
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            w(csr, q)
        assert kernels.launch_counts()[w.name] == before
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fused_mod.fused_stage(csr, boundary_rows(torch.zeros(
            (11, n), dtype=q.dtype)), q, q.clone(),
            torch.ones(n, dtype=q.dtype))
    assert lib.calls == ["mgcfd_edge_csr"] * 3 + ["mgcfd_fused_stage"]


def test_other_devices_raise():
    lvl = generate_multigrid_box(3, 3, 3, 1).levels[0]
    csr = DeviceCSR.from_plan(build_flux_csr(lvl), "meta", torch.float32)
    q = torch.empty((5, lvl.num_nodes), device="meta")
    with pytest.raises(ValueError, match="device"):
        edge_csr.flux(csr, q)


def test_wrappers_check_operands():
    lvl = generate_multigrid_box(3, 3, 3, 1).levels[0]
    csr = DeviceCSR.from_plan(build_flux_csr(lvl), "cpu", torch.float64)
    n = lvl.num_nodes
    with pytest.raises(TypeError):
        edge_csr.flux(csr, torch.ones((5, n), dtype=torch.float32))
    with pytest.raises(ValueError):
        edge_csr.flux(csr, torch.ones((n, 5), dtype=torch.float64))
    with pytest.raises(ValueError):
        edge_csr.flux(csr, torch.ones((5, 2 * n), dtype=torch.float64)[:, ::2])


def test_build_reports_a_missing_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises a clear error (the CPU paths never
    build); the library name follows the sources' content."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(os.path, "isfile",
                        lambda p: False if str(p).endswith("nvcc") else
                        os.path.exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert build.library_path().name.startswith("libmgcfd_kernels_")
    assert not (tmp_path / "b").exists()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """No CUDA device (hidden with CUDA_VISIBLE_DEVICES), or the script
    alone in a directory: a non-zero exit and no result line."""
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd, env = tmp_path, {k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"}
    else:
        cwd, env = REPO, dict(_env(), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_calls_each_entry_point_with_its_arguments():
    """chip_smoke.py's dtype-refusal check calls every C entry point with
    as many arguments as build's signature for it, and asks each one."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_arity", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    called = []

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                assert len(args) == len(build._SIGNATURES[name]), name
                called.append(name)
                return 1
            return launch

    smoke.refuse_unknown_dtype(Lib())
    assert sorted(called) == sorted(build._SIGNATURES)
