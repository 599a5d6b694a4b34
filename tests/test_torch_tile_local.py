"""The window path's tile-local entries: the owner-CSR entries whose
neighbour lies in the owner row's tile of FLUX_TILE_ROWS rows, which the
fused stage reads from the nodes its block completed in shared memory.

On the CPU: fused_stage.tile_local_entries on hand-built CSRs whose
in-tile entries are known and on random ones against a loop over the
entries; prepare_device_mesh counting them over the levels as
window.entries.local of window.entries.all on the 'window' path, fused
or not, and on no other; the benchmark's reader tile_local_share reading
100 x local / all from a store that has them and 0 from one that lacks
them or a program without the store; the tetrahedral cells' roofline
readers (flux_roofline.tet, rw_roofline.tet) reading what the unsplit
readers read from the same record."""
import sys

import numpy as np
import pytest

from cfdbench import run
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.kernels.edge_csr import FLUX_TILE_ROWS
from mgcfd_tpu_torch.kernels.fused_stage import tile_local_entries
from mgcfd_tpu_torch.mesh.unstructured import generate_unstructured_hierarchy
from mgcfd_tpu_torch.prep.csr import _csr, build_edge_csr, build_flux_csr
from mgcfd_tpu_torch.prep.renumber import renumber_hierarchy
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.utils import spans

B = FLUX_TILE_ROWS
# (rows, [(owner, column)], entries in the owner's tile)
HAND = [
    (1, [(0, 0)], 1),
    (3 * B - 20, [(0, B - 1), (0, B), (B - 1, 0), (B, 2 * B - 1),
                  (2 * B - 50, 3 * B - 21), (3 * B - 21, 2 * B),
                  (3 * B - 21, 0)], 4),
    (2 * B, [(B - 1, B), (B, B - 1)], 0),
    (2 * B, [(r, r ^ 1) for r in range(2 * B)], 2 * B),
]


def loop_count(plan) -> int:
    return sum(1 for r, c in zip(plan.owner.tolist(), plan.col.tolist())
               if r // B == c // B)


@pytest.mark.parametrize("rows,entries,local", HAND)
def test_hand_built_csrs(rows, entries, local):
    owner, col = (np.asarray(x, np.int64) for x in zip(*entries))
    plan = _csr(rows, rows, owner, col, np.ones((1, len(entries))))
    assert B == 128
    assert tile_local_entries(plan) == local == loop_count(plan)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_csrs_against_a_loop(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5 * B))
    a = rng.integers(0, n, 3 * n)
    # neighbours near their owners, as an RCM order leaves them
    b = np.clip(a + rng.integers(-B, B, 3 * n), 0, n - 1)
    plan = build_edge_csr(n, a, b, rng.random((3 * n, 3)))
    assert tile_local_entries(plan) == loop_count(plan)


@pytest.fixture(scope="module")
def tet():
    return renumber_hierarchy(generate_unstructured_hierarchy(
        9, 8, 10, 2, h=0.1, seed=3))


@pytest.mark.parametrize("path", ["window", "window_unfused", "pallas",
                                  "segment"])
def test_upload_counts_the_entries_over_the_levels(tet, path):
    """The 'window' path's owner CSRs, fused stage or not, counted over
    the levels at upload; no other path uploads them or counts."""
    accumulate = path.split("_")[0]
    spans.reset()
    MGCFDSolver(tet, SolverConfig(
        dtype="float32", accumulate=accumulate,
        fuse_window_stage=False if path.endswith("unfused") else None),
        "cpu")
    counts = spans.counters("window.entries.")
    if accumulate != "window":
        assert counts == {}
        return
    plans = [build_flux_csr(lv) for lv in tet.levels]
    assert counts["all"] == sum(2 * lv.edge_a.shape[0]
                                for lv in tet.levels)
    assert counts["local"] == sum(loop_count(p) for p in plans)
    assert 0 < counts["local"] < counts["all"]


def test_the_reader_reads_the_store(tet, monkeypatch):
    read = run.load_reader("tile_local_share")
    spans.reset()
    assert read({}) == 0.0          # a store without the counters
    MGCFDSolver(tet, SolverConfig(dtype="float32", accumulate="window"),
                "cpu")
    counts = spans.counters("window.entries.")
    assert read({}) == pytest.approx(100.0 * counts["local"]
                                     / counts["all"])
    spans.count("window.entries.local", counts["all"] - counts["local"])
    assert read({}) == pytest.approx(100.0)
    spans.reset()
    assert read({}) == 0.0
    # a program without the store
    monkeypatch.setitem(sys.modules, "mgcfd_tpu_torch.utils.spans", None)
    assert read({}) == 0.0


RECORDS = [
    {"functions": {"flux": 250.0, "indirect_rw": 80.0},
     "least": {"flux": {"seconds": 7.0e-5}, "indirect_rw": {"seconds":
                                                            2.5e-5}}},
    {"functions": {"flux": 250.0}, "least": {"flux": {"seconds": 7.0e-5}}},
    {"functions": {}, "least": {}},
    {},
]


@pytest.mark.parametrize("record", RECORDS)
@pytest.mark.parametrize("name", ["flux_roofline", "rw_roofline"])
def test_the_tet_rooflines_read_as_the_unsplit_ones(name, record):
    got = run.load_reader(name + ".tet")(record)
    assert got == run.load_reader(name)(record)
    function = {"flux_roofline": "flux",
                "rw_roofline": "indirect_rw"}[name]
    if function in record.get("functions", {}):
        assert got == pytest.approx(
            100.0 * record["least"][function]["seconds"]
            / (record["functions"][function] * 1e-6))
    else:
        assert got is None
