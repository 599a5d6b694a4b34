"""The step_factor kernel's wrapper (mgcfd_tpu_torch/kernels/step_factor.py).

On the CPU the wrapper takes the plain version: each stage factor
fac[j] equals step_factor_plain / float(RK + 1 - j) bit for bit, at
float32, float64 and bfloat16, in both variants; a NaN planted in q makes
every factor of the corrected variant NaN (the global minimum propagates
it) and its own node's in the legacy one; the variable-major visits take
those factors, so a visit equals one written with step_factor_plain and
the per-stage divides; launches.step_factor stays 0; and the cost model
charges compute_step as step_factor where the visits call it.

The tests marked `card` hold the kernel to the plain version on a CUDA
card and skip without one. This file imports no JAX, so on the card they
run without the test directory's conftest:

    python -m pytest --noconftest -q -m card tests/test_torch_step_factor.py

There: bit-equal at float32, float64 and bfloat16 (the eager ops'
roundings at bf16), on a single node, an odd node count, and a level of
more first-pass blocks than one block's threads (the last block's loop);
20 replays of a CUDA graph of the call, each on a new state, equal to the
plain version's factors (the arrival counter resets); the launch counts;
no call without the level's scratch.
"""
import types

import numpy as np
import pytest
import torch

from mgcfd_tpu_torch import kernels
from mgcfd_tpu_torch.kernels import shift
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import RK, far_field_state
from mgcfd_tpu_torch.kernels.fused_stage import fused_stage
from mgcfd_tpu_torch.kernels.step_factor import (STEP_BLOCK_NODES,
                                                 StepScratch, step_factor,
                                                 stage_factors_plain,
                                                 step_factor_plain)
from mgcfd_tpu_torch.monitor.costs import (TIME_STEP_OPS_PER_NODE,
                                           function_cost, step_factor_cost)
from mgcfd_tpu_torch.mesh.generate import generate_multigrid_box
from mgcfd_tpu_torch.ops import cbrt_volumes, tops
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.solver.solver import (_visit_span, _visit_window,
                                           t_compute_fluxes)
from mgcfd_tpu_torch.utils import spans

DTYPES = (torch.float32, torch.float64, torch.bfloat16)
# a single node, an odd count, and more first-pass blocks (1024 nodes
# each) than the 256 threads of the block that reduces their minima
SIZES = (1, 4097, 300_001)


def level(n: int, dtype, device="cpu", seed: int = 0):
    """A level of n nodes: volumes over four decades, their cube roots,
    and the far field plus 5% seeded noise, (5, n)."""
    rng = np.random.default_rng(seed)
    volumes = torch.as_tensor(10.0 ** rng.uniform(-4, 0, n)).to(
        device=device, dtype=dtype)
    q = far_field_state()[0][:, None] + 0.05 * rng.standard_normal((5, n))
    lvl = types.SimpleNamespace(volumes=volumes,
                                cbrt_volumes=cbrt_volumes(volumes))
    return lvl, torch.as_tensor(q).to(device=device, dtype=dtype)


def oracle(lvl, q, legacy):
    """fac[j] as the solver took it before the kernel: the step factor,
    then the stage's divide."""
    sf = step_factor_plain(q, lvl.volumes, lvl.cbrt_volumes, legacy)
    return [sf / float(RK + 1 - j) for j in range(RK)]


def same_bits(a, b) -> bool:
    """Equal, NaN at the same places (NaN == NaN)."""
    return torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_stage_factors_equal_the_divided_step_factor(dtype, legacy):
    lvl, q = level(517, dtype)
    fac = step_factor(q, lvl.volumes, lvl.cbrt_volumes, legacy)
    assert fac.shape == (RK, 517) and fac.dtype == dtype
    for j, want in enumerate(oracle(lvl, q, legacy)):
        assert torch.equal(fac[j], want), j
    if not legacy:     # every node's factor is the same least dt over V
        sf = fac[RK - 1] * lvl.volumes.to(fac.dtype)
        assert float(sf.double().std() / sf.double().mean()) < 1e-2


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_planted_nan(dtype, legacy):
    """torch.min propagates NaN: one bad node spoils every factor of the
    corrected variant, and only its own in the legacy one."""
    lvl, q = level(300, dtype)
    q[3, 123] = float("nan")
    fac = step_factor(q, lvl.volumes, lvl.cbrt_volumes, legacy)
    for j, want in enumerate(oracle(lvl, q, legacy)):
        assert same_bits(fac[j], want)
    if legacy:
        assert fac[:, 123].isnan().all() and int(fac.isnan().sum()) == RK
    else:
        assert fac.isnan().all()


def test_step_factor_checks_its_operands():
    lvl, q = level(10, torch.float32)
    with pytest.raises(ValueError, match="volumes"):
        step_factor(q, lvl.volumes[:9], lvl.cbrt_volumes, False)
    with pytest.raises(ValueError, match="cbrt_volumes"):
        step_factor(q, lvl.volumes, lvl.cbrt_volumes.double(), False)
    with pytest.raises(ValueError, match="q"):
        step_factor(q.T.contiguous().T, lvl.volumes, lvl.cbrt_volumes,
                    False)


def box_solver(accumulate: str, **kw):
    mesh = generate_multigrid_box(6, 5, 7, 2)
    return MGCFDSolver(mesh, SolverConfig(dtype="float64",
                                          accumulate=accumulate, **kw),
                       device="cpu")


@pytest.mark.parametrize("accumulate,fused", [
    ("window", True), ("window", False), ("pallas", True),
    ("pallas", False)])
def test_visit_takes_the_plain_stage_factors(accumulate, fused):
    """A visit of a variable-major path equals the same visit written with
    the step factor and each stage's divide, bit for bit."""
    kw = ({"fuse_window_stage": fused} if accumulate == "window"
          else {"fuse_stage": fused})
    s = box_solver(accumulate, **kw)
    lvl = s.dmesh.levels[0]
    q0 = s.state["variables"][0] * (1.0 + 0.01 * torch.sin(
        torch.arange(lvl.num_nodes, dtype=torch.float64)))[None]
    visit = _visit_window if accumulate == "window" else _visit_span
    got, res, invalid = visit(lvl, q0, s.config, False, None, 0)
    sf = step_factor_plain(q0, lvl.volumes, lvl.cbrt_volumes, False)
    q = q0
    for j in range(RK):
        if fused and accumulate == "window":
            q, _ = fused_stage(lvl.csr, lvl.boundary, q, q0,
                               sf / float(RK + 1 - j))
        elif fused:
            q, _ = shift.fused_stage(lvl.shift, lvl.boundary, q, q0,
                                     sf / float(RK + 1 - j))
        else:
            q = tops.t_time_step(j, sf, t_compute_fluxes(lvl, q, s.config),
                                 q0)
    assert torch.equal(got, q) and torch.equal(res, q - q0)
    assert int(invalid) == 0


def test_launches_stay_zero_on_the_cpu():
    s = box_solver("window")
    assert s.dmesh.levels[0].step is None
    kernels.reset_launch_counts()
    s.run(1)
    assert kernels.launch_counts()["step_factor"] == 0
    assert spans.counters()["launches.step_factor"] == 0


@pytest.mark.parametrize("legacy", [False, True])
def test_compute_step_costs_as_step_factor(legacy):
    """Where the visits call step_factor, compute_step is charged as it
    and the time step without the stage's divide; elsewhere (node-major,
    the sharded solver's block levels) as the step factor alone."""
    levels = box_solver("window").dmesh.levels
    n = levels[0].num_nodes
    args = ("window", True, 8)
    assert function_cost("compute_step", levels, 0, *args,
                         stage_factors=True, legacy=legacy) == \
        step_factor_cost(n, 8, legacy)
    assert function_cost("time_step", levels, 0, *args,
                         stage_factors=True)[1] == \
        (TIME_STEP_OPS_PER_NODE - 1) * n
    alone = function_cost("compute_step", levels, 0, *args, legacy=legacy)
    assert alone[0] == 8 * n * 8 and alone != step_factor_cost(n, 8, legacy)
    assert function_cost("time_step", levels, 0, *args)[1] == \
        TIME_STEP_OPS_PER_NODE * n


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run there with python -m pytest "
                    "--noconftest -m card tests/test_torch_step_factor.py")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_equals_plain(card, dtype, legacy, n):
    lvl, q = level(n, dtype, card, seed=n)
    kernels.reset_launch_counts()
    fac = step_factor(q, lvl.volumes, lvl.cbrt_volumes, legacy,
                      StepScratch(n, dtype, card))
    launched = kernels.launch_counts()["step_factor"]
    want = stage_factors_plain(q, lvl.volumes, lvl.cbrt_volumes, legacy)
    torch.cuda.synchronize()
    assert same_bits(fac, want), int((fac != want).sum())
    assert launched == (1 if legacy else 2)
    q[0, n // 2] = float("nan")
    fac = step_factor(q, lvl.volumes, lvl.cbrt_volumes, legacy,
                      StepScratch(n, dtype, card))
    want = stage_factors_plain(q, lvl.volumes, lvl.cbrt_volumes, legacy)
    assert same_bits(fac, want)


@pytest.mark.card
def test_kernel_needs_its_scratch(card):
    lvl, q = level(100, torch.float32, card)
    with pytest.raises(ValueError, match="StepScratch"):
        step_factor(q, lvl.volumes, lvl.cbrt_volumes, False)
    with pytest.raises(ValueError, match="scratch for 99"):
        step_factor(q, lvl.volumes, lvl.cbrt_volumes, False,
                    StepScratch(99, torch.float32, card))


@pytest.mark.card
@pytest.mark.parametrize("n", [5000, 300_001])
@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_replays_reset_the_counter(card, dtype, n):
    """20 replays of a captured call, each on a new state: every replay's
    factors are the plain version's for its state, so the last block of
    each replay found the arrival counter at 0."""
    assert n > 4 * STEP_BLOCK_NODES
    lvl, q = level(n, dtype, card, seed=1)
    scratch = StepScratch(n, dtype, card)
    static = q.clone()
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        step_factor(static, lvl.volumes, lvl.cbrt_volumes, False, scratch)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fac = step_factor(static, lvl.volumes, lvl.cbrt_volumes, False,
                          scratch)
    least = set()
    for r in range(20):
        _, qr = level(n, dtype, card, seed=100 + r)
        static.copy_(qr)
        graph.replay()
        want = stage_factors_plain(qr, lvl.volumes, lvl.cbrt_volumes, False)
        torch.cuda.synchronize()
        assert same_bits(fac, want), r
        assert int(scratch.arrivals.item()) == 0
        least.add(float(scratch.partials[-1]))
    if dtype != torch.bfloat16:     # bf16's coarser minima may repeat
        assert len(least) == 20
    assert len(least) > 1
