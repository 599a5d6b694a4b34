"""The byte and operation counts equal hand counts on a tiny mesh."""
import numpy as np
import pytest

from cfdbench import counts
from cfdbench.inputs.level import Hierarchy, Level


def tiny():
    """Two levels: 4 nodes, 5 internal edges, 2 far-field and 1 wall
    face; then 2 nodes and 1 edge."""
    def lvl(n, ei, nb, nw):
        z = np.zeros
        return Level(volumes=np.ones(n), coords=z((n, 3)),
                     edge_a=z(ei, np.int32), edge_b=np.ones(ei, np.int32),
                     edge_w=z((ei, 3)), bedge_b=z(nb, np.int32),
                     bedge_w=z((nb, 3)), wedge_b=z(nw, np.int32),
                     wedge_w=z((nw, 3)))
    return Hierarchy(levels=[lvl(4, 5, 2, 1), lvl(2, 1, 0, 0)])


def test_sizes_and_visits():
    assert counts.level_sizes(tiny()) == [
        {"nodes": 4, "internal": 5, "boundary": 2, "wall": 1},
        {"nodes": 2, "internal": 1, "boundary": 0, "wall": 0}]
    assert counts.visits(1) == [1]
    assert counts.visits(2) == [1, 1]
    assert counts.visits(4) == [1, 2, 2, 1]


@pytest.mark.parametrize("dtype,s", [("float32", 4), ("float64", 8)])
def test_one_call(dtype, s):
    size = counts.level_sizes(tiny())[0]
    # variables in and fluxes out: 2 x 4 x 5 values; 5 edges of 2 ids and
    # 3 weights; 3 faces of an id and 3 weights
    assert counts.call("flux", size, dtype) == (
        2 * 4 * 5 * s + 5 * (2 * 4 + 3 * s) + 3 * (4 + 3 * s),
        5 * 107 + 2 * 18 + 1 * 133)
    assert counts.call("indirect_rw", size, dtype) == (
        2 * 4 * 5 * s + 5 * (2 * 4 + 3 * s), 5 * 13)


def test_least_time_per_cycle():
    sizes = counts.level_sizes(tiny())
    # float32, level 0: 308 bytes and 704 operations a flux call; level
    # 1: 80 + 20 bytes, 107 operations; 3 calls of each a cycle
    got = counts.least_time("flux", sizes, "float32", 100.0, 1000.0)
    assert got["bytes"] == 3 * 308 + 3 * 100
    assert got["operations"] == 3 * 704 + 3 * 107
    assert got["seconds"] == pytest.approx(3 * 3.08 + 3 * 1.0)
    assert got["bound"] == "bytes"
    got = counts.least_time("flux", sizes, "float32", 1e6, 100.0)
    assert got["seconds"] == pytest.approx(3 * 7.04 + 3 * 1.07)
    assert got["bound"] == "operations"


def test_the_m6_configurations_level_zero():
    size = {"nodes": 304640, "internal": 900328, "boundary": 22832,
            "wall": 4352}
    nbytes, _ = counts.call("flux", size, "float32")
    assert nbytes == 30627104
