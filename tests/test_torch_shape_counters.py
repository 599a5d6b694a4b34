"""The edge_csr wrappers' launch counters by shape,
launches.<wrapper>.<shape> (kernels/__init__.py, kernels/edge_csr.py):
the name each shape of rw_shape, wsum_shape and flux_shape is counted
under, at float32 and float64 on either side of FULL_LEVEL; a launch
counted under the shape the C entry point chose, asked once per CSR; the
capture's counts added on each replay as the wrappers' are.

The tests marked `card` drive run_batched through the window kernels on
a card and skip without one. This file imports no JAX; on the card:

    python -m pytest --noconftest -q -m card tests/test_torch_shape_counters.py
"""
import ctypes
import types

import pytest
import torch

from mgcfd_tpu_torch import kernels
from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.kernels import build, edge_csr
from mgcfd_tpu_torch.kernels.edge_csr import (CHUNK, FULL_LEVEL,
                                              RW_LONG_ROW, DeviceCSR,
                                              flux_shape, rw_shape,
                                              wsum_shape)
from mgcfd_tpu_torch.utils import spans

DTYPES = (torch.float32, torch.float64)
# rows of the M6 hierarchies' levels on either side of FULL_LEVEL
ROWS = (FULL_LEVEL - 1, FULL_LEVEL)
# (wrapper, entries a row, the Python mirror of the C choice) ->
# {(dtype, rows from FULL_LEVEL on): counter}
NAMES = {
    (edge_csr.rw, 3, rw_shape): {
        (torch.float32, False): "edge_csr.rw.row",
        (torch.float32, True): "edge_csr.rw.row",
        (torch.float64, False): "edge_csr.rw.row",
        (torch.float64, True): "edge_csr.rw.tile"},
    (edge_csr.rw, RW_LONG_ROW, rw_shape): {
        (torch.float32, False): "edge_csr.rw.row",
        (torch.float32, True): "edge_csr.rw.tile",
        (torch.float64, False): "edge_csr.rw.row",
        (torch.float64, True): "edge_csr.rw.tile"},
    (edge_csr.prolong, 2, wsum_shape): {
        (torch.float32, False): "edge_csr.wsum.prolong.batched",
        (torch.float32, True): "edge_csr.wsum.prolong.batched",
        (torch.float64, False): "edge_csr.wsum.prolong.batched",
        (torch.float64, True): "edge_csr.wsum.prolong.plain"},
    (edge_csr.restrict, CHUNK, wsum_shape): {
        (d, full): "edge_csr.wsum.restrict.chunked"
        for d in DTYPES for full in (False, True)},
    (edge_csr.flux, 3, flux_shape): {
        (d, full): "edge_csr.flux.row" for d in DTYPES
        for full in (False, True)},
    (edge_csr.flux, RW_LONG_ROW, flux_shape): {
        (d, full): "edge_csr.flux.tile" for d in DTYPES
        for full in (False, True)},
}


@pytest.fixture(autouse=True)
def clean():
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(NAMES), ids=lambda c: (
    f"{c[0].name}-{c[1]}" if isinstance(c, tuple) else None))
def test_each_shape_has_its_counter(case, dtype, rows):
    wrapper, per_row, mirror = case
    shape = mirror(rows, per_row * rows, dtype)
    assert wrapper.counter(shape) == NAMES[case][dtype, rows >= FULL_LEVEL]


def test_every_shape_name_is_a_counter_of_its_wrapper():
    for w, shapes in ((edge_csr.rw, edge_csr.RW_SHAPES),
                      (edge_csr.flux, edge_csr.FLUX_SHAPES)):
        assert {w.counter(s) for s in shapes} == {
            f"{w.name}.{n}" for n in shapes.values()}
    for w in (edge_csr.restrict, edge_csr.prolong):
        assert {w.counter(edge_csr.WsumShape(split, loads))
                for split in (False, True)
                for loads in edge_csr.WSUM_LOADS} == {
            f"{w.name}.{n}" for n in ("plain", "chunked", "batched")}


class FakeLibrary:
    """The C entry points a launch calls, on the host: the shape queries
    answer as the Python mirrors do and are counted; a launch does
    nothing."""

    MIRRORS = {"mgcfd_rw_shape": rw_shape, "mgcfd_flux_shape": flux_shape,
               "mgcfd_wsum_shape": wsum_shape}
    DTYPES = {code: dtype for dtype, code in build.DTYPE_CODES.items()}

    def __init__(self):
        self.queries = 0

    def __getattr__(self, name):
        mirror = self.MIRRORS.get(name)
        if mirror is None:
            return lambda *args: 0

        def query(code, n_rows, n_half, out):
            self.queries += 1
            shape = mirror(n_rows, n_half, self.DTYPES[code])
            got = (ctypes.c_int64 * 2).from_address(out)
            if isinstance(shape, edge_csr.WsumShape):
                got[0], got[1] = int(shape.split), shape.loads
            else:
                got[0] = shape
            return 0
        return query


@pytest.fixture
def host_launches(monkeypatch):
    """The wrappers' card path with the library faked on the host."""
    lib = FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(edge_csr, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


def csr(rows: int, per_row: int, dtype) -> DeviceCSR:
    n = rows * per_row
    return DeviceCSR(
        num_rows=rows, num_cols=rows,
        row_ptr=torch.arange(0, n + 1, per_row, dtype=torch.int32),
        col=torch.zeros(n, dtype=torch.int32),
        owner=torch.zeros(0, dtype=torch.int64),
        w=torch.zeros((4, n), dtype=dtype))


def test_a_launch_counts_under_the_shape_the_entry_point_chose(
        host_launches):
    big = csr(FULL_LEVEL, 3, torch.float64)
    small = csr(FULL_LEVEL - 1, 3, torch.float64)
    for c, times in ((big, 3), (small, 2)):
        x = torch.zeros((5, c.num_rows), dtype=torch.float64)
        for _ in range(times):
            edge_csr.rw(c, x)
        edge_csr.flux(c, x)
    # one query per CSR and wrapper, whatever the number of launches
    assert host_launches.queries == 4
    assert big.counters == {"edge_csr.rw": "edge_csr.rw.tile",
                            "edge_csr.flux": "edge_csr.flux.row"}
    assert small.counters["edge_csr.rw"] == "edge_csr.rw.row"
    got = kernels.launch_counts(shapes=True)
    assert got["edge_csr.rw"] == 5 and got["edge_csr.flux"] == 2
    assert got["edge_csr.rw.tile"] == 3 and got["edge_csr.rw.row"] == 2
    assert got["edge_csr.flux.row"] == 2
    assert spans.counters("launches.edge_csr.rw.") == {"row": 2, "tile": 3}
    # the wrappers' own counts keep their names alone
    assert set(kernels.launch_counts()) == {w.name for w in
                                            kernels.WRAPPERS}
    # a launch at a shape asked for is counted under that shape
    edge_csr.rw.at(big, torch.zeros((5, big.num_rows),
                                    dtype=torch.float64), edge_csr.RW_ROW)
    got = kernels.launch_counts(shapes=True)
    assert {k: n for k, n in got.items() if k.startswith("edge_csr.rw.")} \
        == {"edge_csr.rw.tile": 3, "edge_csr.rw.row": 3}


def test_a_replay_adds_the_shapes_as_the_wrappers():
    """What CycleGraph keeps of a capture and adds on each replay."""
    capture = {"edge_csr.rw": 6, "edge_csr.rw.tile": 4,
               "edge_csr.rw.row": 2, "edge_csr.wsum.prolong": 3,
               "edge_csr.wsum.prolong.plain": 2,
               "edge_csr.wsum.prolong.batched": 1, "fused_stage": 18,
               "step_factor": 12}
    kernels.add_launch_counts(capture)
    kernels.add_launch_counts(capture)
    got = kernels.launch_counts(shapes=True)
    assert {k: got[k] for k in capture} == {k: 2 * n for k, n in
                                           capture.items()}
    assert spans.counters("launches.edge_csr.wsum.prolong.") == {
        "plain": 4, "batched": 2}
    assert sum(n for k, n in got.items()
               if k.startswith("edge_csr.rw.")) == got["edge_csr.rw"]
    kernels.reset_launch_counts()
    assert kernels.launch_counts(shapes=True) == kernels.launch_counts()
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("case", [
    ("window", MeshVariant.M6_WING, 18, 18),
    ("window", MeshVariant.FVCORR, 12, 12),
    ("pallas", MeshVariant.M6_WING, 0, 0)],
    ids=lambda c: f"{c[0]}-{c[1].name}")
def test_a_cycle_stores_and_gathers_the_primitives(host_launches, case):
    """One cycle of 6 visits on a 4-level box through the wrappers' card
    path: on the window path the step factor's first pass and the first
    two RK stages store the primitives (epilogue.primitives), every fused
    stage gathers them (primitives.gathered); under the legacy step
    factor (FVCORR) the step factor stores none and the first stage
    gathers none; the span path neither."""
    from mgcfd_tpu_torch.core.config import SolverConfig
    from mgcfd_tpu_torch.kernels.step_factor import StepScratch
    from mgcfd_tpu_torch.mesh import generate_multigrid_box
    from mgcfd_tpu_torch.solver import MGCFDSolver
    accumulate, variant, stored, gathered = case
    mesh = generate_multigrid_box(16, 16, 16, 4, h=(0.1, 0.1, 0.1),
                                  variant=variant)
    s = MGCFDSolver(mesh, SolverConfig(dtype="float32",
                                       accumulate=accumulate), device="cpu")
    for lvl in s.dmesh.levels:
        lvl.step = StepScratch(lvl.num_nodes, torch.float32, "cpu")
    kernels.reset_launch_counts()
    s.cycle()
    launches = kernels.launch_counts(shapes=True)
    legacy = variant.uses_legacy_step_factor
    assert launches["step_factor"] == (6 if legacy else 12)
    stages = "fused_stage" if accumulate == "window" else \
        "shift.fused_stage"
    assert launches[stages] == 18
    assert spans.counters("epilogue.").get("primitives", 0) == stored
    assert spans.counters("primitives.").get("gathered", 0) == gathered
    assert launches.get("epilogue.primitives", 0) == stored
    assert launches.get("primitives.gathered", 0) == gathered


def test_a_replay_adds_the_primitives_counters():
    """What CycleGraph keeps of a capture and adds on each replay: the
    primitives' counters as the wrappers' launches."""
    capture = {"fused_stage": 18, "step_factor": 12,
               "epilogue.primitives": 18, "primitives.gathered": 18}
    kernels.add_launch_counts(capture)
    kernels.add_launch_counts(capture)
    got = kernels.launch_counts(shapes=True)
    assert {k: got[k] for k in capture} == {k: 2 * n for k, n in
                                           capture.items()}
    assert spans.counters("primitives.") == {"gathered": 36}
    assert spans.counters("epilogue.")["primitives"] == 36
    kernels.reset_launch_counts()
    assert not spans.counters("primitives.").get("gathered", 0)


# --- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run there with python -m pytest "
                    "--noconftest -m card tests/test_torch_shape_counters.py")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def full_box():
    """A box whose level 0 has FULL_LEVEL nodes or more (140,608)."""
    from mgcfd_tpu_torch.mesh import generate_multigrid_box
    return generate_multigrid_box(52, 52, 52, 2, h=(0.1, 0.1, 0.1))


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_batched_counts_the_shapes_it_ran(card, full_box, dtype):
    """Through the window path's CUDA graph: at float64 rw takes the tile
    on level 0 and the prolongation plain loads onto it, at float32 a
    thread a row and batched loads; a second call's replays add the
    same counts again."""
    from mgcfd_tpu_torch.core.config import SolverConfig
    from mgcfd_tpu_torch.solver import MGCFDSolver
    assert full_box.levels[0].num_nodes >= FULL_LEVEL
    s = MGCFDSolver(full_box, SolverConfig(dtype=dtype,
                                           accumulate="window"),
                    device=card)
    kernels.reset_launch_counts()
    s.run_batched(4, 2)
    first = kernels.launch_counts(shapes=True)
    for w in kernels.EDGE_CSR:
        assert sum(n for k, n in first.items() if k.rpartition(".")[0]
                   == w.name) == first[w.name], w.name
    tile = first.get("edge_csr.rw.tile", 0)
    plain = first.get("edge_csr.wsum.prolong.plain", 0)
    if dtype == "float64":
        assert tile > 0 and plain > 0
    else:
        assert tile == 0 and plain == 0
        assert first["edge_csr.rw.row"] == first["edge_csr.rw"] > 0
    s.run_batched(4, 2)
    torch.cuda.synchronize()
    assert kernels.launch_counts(shapes=True) == {
        k: 2 * n for k, n in first.items()}
    assert s._graph is not None
