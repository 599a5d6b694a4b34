"""The fused stages' compact boundary/wall operand (kernels/boundary.py):
the rows of the aggregated normals nc (11, N) that are not all +0.0, a
bit a node saying which, and the stored rows before each 32-node word.

On the CPU: the operand expands back to the dense nc bit for bit (the box
and RCM hierarchies at float32, float64 and bfloat16; N = 31, 32 and 33
with no row stored, every row stored, and a row of -0.0); both fused
stages' plain versions give the same bits and counts from it as from the
dense nc, with and without the residual; the solver builds it on the
fused paths, counted as boundary.rows.stored of boundary.rows.all, and
the dense nc on the unfused ones; the wrappers refuse a dense nc.

The tests marked `card` hold both fused kernels with the operand to the
same kernel reading every node's row from memory (an operand with every
row stored, as the dense nc was read), bit for bit with equal invalid
counts, and to their plain versions within chip_smoke.py's tolerances
with equal invalid counts, at every level of the M6 box and RCM
hierarchies, at three dtypes, with and without the epilogues, from
states with invalid values planted. They skip without a card; on the card (this
file imports no JAX):

    python -m pytest --noconftest -q -m card tests/test_torch_boundary.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import far_field_state
from mgcfd_tpu_torch.kernels import (BoundaryRows, DeviceCSR, DeviceShift,
                                     boundary_rows, shift)
from mgcfd_tpu_torch.kernels.boundary import WORD, stored_rows
from mgcfd_tpu_torch.kernels.fused_stage import (fused_stage,
                                                 fused_stage_plain)
from mgcfd_tpu_torch.mesh.generate import generate_multigrid_box
from mgcfd_tpu_torch.ops import tops
from mgcfd_tpu_torch.prep.csr import build_flux_csr
from mgcfd_tpu_torch.prep.renumber import renumber_hierarchy
from mgcfd_tpu_torch.prep.shift import build_shift_plan
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.utils import spans
from mgcfd_tpu_torch.validate.rounding import bf16_agreement
from test_torch_epilogue import m6_hierarchy, noise, same, state

DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def level_nc(lv) -> np.ndarray:
    """A host level's dense (11, N) nc in float64, as the solver builds
    it."""
    return np.concatenate(tops.build_dense_boundary_wall(
        lv.num_nodes, lv.bedge_b, lv.bedge_w, lv.wedge_b, lv.wedge_w,
        far_field_state(np.float64)[1]), axis=0)


def every_row_stored(nc: torch.Tensor) -> BoundaryRows:
    """The operand with every node's row stored: each node reads its 11
    values from memory, as the kernels read the dense nc."""
    n = int(nc.shape[1])
    words = -(-n // WORD)
    return BoundaryRows(
        num_nodes=n,
        mask=torch.full((words,), -1, dtype=torch.int32, device=nc.device),
        rank=torch.arange(0, WORD * words, WORD, dtype=torch.int32,
                          device=nc.device),
        vals=nc.contiguous())


def bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8))


@pytest.fixture(scope="module")
def hierarchies():
    """A 4-level box hierarchy in (i, j, k) order and RCM-renumbered."""
    box = generate_multigrid_box(14, 12, 15, 4, h=(0.1, 0.1, 0.1))
    return {"box": box, "rcm": renumber_hierarchy(box)}


# --- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", ["box", "rcm"])
def test_operand_round_trips_on_the_hierarchies(hierarchies, order, dtype):
    """Every level: dense() gives the cast nc bit for bit; the stored rows
    are the nodes with a boundary or wall face, in node order; mask and
    rank agree with them."""
    for lv in hierarchies[order].levels:
        nc = torch.as_tensor(level_nc(lv)).to(dtype)
        bnd = boundary_rows(nc)
        assert bits_equal(bnd.dense(), nc)
        faces = np.zeros(lv.num_nodes, bool)
        faces[lv.bedge_b] = faces[lv.wedge_b] = True
        stored = stored_rows(nc)
        assert np.array_equal(stored.numpy(), faces)
        assert bnd.stored == int(faces.sum()) <= lv.num_nodes
        assert bits_equal(bnd.vals, nc[:, stored])
        bits = [(int(bnd.mask[i // WORD]) >> (i % WORD)) & 1
                for i in range(lv.num_nodes)]
        assert np.array_equal(np.asarray(bits, bool), faces)
        per_word = np.add.reduceat(faces.astype(np.int64),
                                   np.arange(0, lv.num_nodes, WORD))
        assert np.array_equal(bnd.rank.numpy(),
                              np.cumsum(per_word) - per_word)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["none", "all", "negative_zero",
                                  "last_word"])
@pytest.mark.parametrize("n", [31, 32, 33])
def test_operand_round_trips_at_word_edges(n, case, dtype):
    """N about one word: no row stored, every row stored, a row holding a
    -0.0 (stored, and read back as -0.0), and the last node's row alone
    (bit 31 of a word when N = 32)."""
    rng = np.random.default_rng(n)
    nc = torch.zeros((11, n), dtype=dtype)
    if case == "all":
        nc = torch.as_tensor(rng.standard_normal((11, n))).to(dtype)
    elif case == "negative_zero":
        nc[4, n // 2] = -0.0
        nc[:, 3] = torch.as_tensor(rng.standard_normal(11)).to(dtype)
    elif case == "last_word":
        nc[7, n - 1] = 1.5
    bnd = boundary_rows(nc)
    want = {"none": 0, "all": n, "negative_zero": 2, "last_word": 1}[case]
    assert bnd.stored == want
    assert bnd.mask.shape == bnd.rank.shape == (-(-n // WORD),)
    assert bnd.mask.dtype == bnd.rank.dtype == torch.int32
    back = bnd.dense()
    assert bits_equal(back, nc)
    if case == "negative_zero":
        assert torch.signbit(back[4, n // 2]).item()
    if case == "last_word" and n == 32:
        assert int(bnd.mask[0]) == -2 ** 31


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["window", "span"])
def test_plain_versions_agree_on_both_operands(hierarchies, kind, dtype,
                                               residual):
    """fused_stage_plain and shift_fused_stage_plain: the same bits and
    invalid counts from the compact operand as from the dense nc, from a
    state with invalid values planted, at every level of the box
    hierarchy; the wrappers on the CPU give the compact operand's."""
    for lev, lv in enumerate(hierarchies["box"].levels):
        n = lv.num_nodes
        nc = torch.as_tensor(level_nc(lv)).to(dtype)
        bnd = boundary_rows(nc)
        q = state(n, dtype, seed=lev, plant=True)
        old = state(n, dtype, seed=10 + lev)
        fac = 1e-3 * (1 + noise((n,), dtype, seed=lev).abs())
        if kind == "window":
            csr = DeviceCSR.from_plan(build_flux_csr(lv), "cpu", dtype)
            plain = lambda op: fused_stage_plain(csr, op, q, old, fac,
                                                 residual=residual)
            wrapper = lambda: fused_stage(csr, bnd, q, old, fac,
                                          residual=residual)
        else:
            sh = DeviceShift.from_plan(build_shift_plan(lv), n, "cpu",
                                       dtype)
            spill = 1e-3 * noise((5, n), dtype, seed=5)
            plain = lambda op: shift.shift_fused_stage_plain(
                sh, op, q, old, fac, spill, residual=residual)
            wrapper = lambda: shift.fused_stage(sh, bnd, q, old, fac, spill,
                                                residual=residual)
        for got in (plain(bnd), wrapper()):
            want = plain(nc)
            assert len(got) == len(want) == (3 if residual else 2)
            assert same(got[0], want[0]), lev
            assert int(got[1]) == int(want[1]) >= 4, lev
            if residual:
                assert same(got[2], want[2]), lev


@pytest.mark.parametrize("path", ["window", "pallas", "window_unfused",
                                  "pallas_unfused", "segment"])
def test_upload_counts_the_stored_rows(hierarchies, path):
    """The fused paths upload the compact operand alone (of the weights
    conditioned for the mesh's variant, which zero no row) and count its
    rows over the levels as boundary.rows.stored of boundary.rows.all; the
    unfused variable-major paths upload the dense nc alone and count
    nothing; 'segment' uploads neither."""
    mesh = hierarchies["box"]
    accumulate = path.split("_")[0]
    unfused = path.endswith("unfused")
    spans.reset()
    s = MGCFDSolver(mesh, SolverConfig(
        dtype="float64", accumulate=accumulate, fuse_stage=not unfused,
        fuse_window_stage=False if unfused else None), "cpu")
    counts = spans.counters()
    if path in ("window", "pallas"):
        stored = sum(int(stored_rows(torch.as_tensor(level_nc(lv))).sum())
                     for lv in mesh.levels)
        assert counts["boundary.rows.stored"] == stored
        assert counts["boundary.rows.all"] == sum(
            lv.num_nodes for lv in mesh.levels)
        assert 0 < stored < counts["boundary.rows.all"]
        for lvl, lv in zip(s.dmesh.levels, mesh.levels):
            assert lvl.nc is None
            assert lvl.boundary.stored == int(stored_rows(
                torch.as_tensor(level_nc(lv))).sum())
            assert lvl.boundary.vals.dtype == torch.float64
    else:
        assert "boundary.rows.stored" not in counts
        assert "boundary.rows.all" not in counts
        for lvl in s.dmesh.levels:
            assert lvl.boundary is None
            assert (lvl.nc is None) == (path == "segment")


def test_the_m6_hierarchy_stores_a_tenth_of_its_rows():
    """The M6 configurations' levels (304,640 / 165,984 / 110,400 / 81,180
    nodes): the share of nodes with a stored row by level, and over the
    levels as the upload counters sum them."""
    mesh = m6_hierarchy()
    stored = [int(stored_rows(torch.as_tensor(level_nc(lv))).sum())
              for lv in mesh.levels]
    nodes = [lv.num_nodes for lv in mesh.levels]
    shares = [round(s / n, 4) for s, n in zip(stored, nodes)]
    assert shares == [0.0866, 0.1053, 0.12, 0.1324]
    assert 0.10 <= sum(stored) / sum(nodes) <= 0.11


def test_wrappers_refuse_a_dense_operand(hierarchies):
    lv = hierarchies["box"].levels[0]
    n = lv.num_nodes
    q = state(n, torch.float64)
    fac = torch.full((n,), 1e-3, dtype=torch.float64)
    nc = torch.as_tensor(level_nc(lv))
    csr = DeviceCSR.from_plan(build_flux_csr(lv), "cpu", torch.float64)
    sh = DeviceShift.from_plan(build_shift_plan(lv), n, "cpu", torch.float64)
    for call in (lambda op: fused_stage(csr, op, q, q, fac),
                 lambda op: shift.fused_stage(sh, op, q, q, fac)):
        with pytest.raises(ValueError, match="BoundaryRows"):
            call(nc)
        with pytest.raises(ValueError, match="boundary vals"):
            call(boundary_rows(nc.float()))
        short = boundary_rows(nc)
        with pytest.raises(ValueError, match="boundary mask"):
            call(dataclasses.replace(short, mask=short.mask[:-1]))


# --- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run there with python -m pytest "
                    "--noconftest -m card tests/test_torch_boundary.py")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def m6_levels():
    """The M6 hierarchy's levels in (i, j, k) order and RCM-renumbered."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ijk = m6_hierarchy()
    return {"ijk": ijk.levels, "rcm": renumber_hierarchy(ijk).levels}


# the plain versions compute in PyTorch's order of operations, not in the
# kernels' (nvcc contracts multiplies and adds into FMAs): the kernels'
# states are held to them within chip_smoke.py's tolerances of each
# channel's largest magnitude, at bfloat16 within one bf16 spacing
PLAIN_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def close_to_plain(got, want) -> bool:
    """NaN and Inf at the same places, the rest within PLAIN_TOL."""
    if got.dtype == torch.bfloat16:
        return bf16_agreement(got, want)[0] <= 1.0
    g, w = got.double().cpu(), want.double().cpu()
    fin = torch.isfinite(w)
    if not torch.equal(torch.isfinite(g), fin) or not torch.equal(
            g[~fin].nan_to_num(), w[~fin].nan_to_num()):
        return False
    g, w = torch.where(fin, g, 0.0), torch.where(fin, w, 0.0)
    scale = w.abs().amax(dim=1).clamp_min(1e-300)
    return float(((g - w).abs().amax(dim=1) / scale).max()) \
        <= PLAIN_TOL[got.dtype]


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["window.ijk", "window.rcm", "span.ijk"])
def test_fused_kernels_read_the_compact_operand(card, m6_levels, kind,
                                                dtype):
    """Both fused kernels at every M6 level, from a state with invalid
    values planted, with and without the epilogues: the compact operand
    against every row read from memory (the dense operand's reads), bit
    for bit, NaN equal to NaN, with equal invalid counts; and against the
    plain version (close_to_plain), with equal invalid counts."""
    stage, order = kind.split(".")
    for lev, lv in enumerate(m6_levels[order]):
        n = lv.num_nodes
        nc = torch.as_tensor(level_nc(lv)).to(dtype)
        bnd = boundary_rows(nc).to(card)
        full = every_row_stored(nc.to(card))
        assert 0 < bnd.stored < n
        q = state(n, dtype, card, seed=lev, plant=True)
        old = state(n, dtype, card, seed=10 + lev)
        fac = 1e-3 * (1 + noise((n,), dtype, card, seed=lev).abs())
        if stage == "window":
            csr = DeviceCSR.from_plan(build_flux_csr(lv), card, dtype)
            kern = lambda op, **e: fused_stage(csr, op, q, old, fac, **e)
            plain = lambda op: fused_stage_plain(csr, op, q, old, fac,
                                                 residual=True)
        else:
            sh = DeviceShift.from_plan(build_shift_plan(lv), n, card, dtype)
            kern = lambda op, **e: shift.fused_stage(sh, op, q, old, fac,
                                                     **e)
            plain = lambda op: shift.shift_fused_stage_plain(
                sh, op, q, old, fac, residual=True)
        got = {}
        for name, op in (("compact", bnd), ("every row", full)):
            out, inv = kern(op)
            count = torch.zeros(1, dtype=torch.int64, device=card)
            got[name] = (out, int(inv)) + kern(op, count=count,
                                               residual=True)
        want = plain(bnd)
        torch.cuda.synchronize()
        (out, inv, e_out, e_count, e_res), ref = got["compact"], \
            got["every row"]
        assert same(out, ref[0]) and same(e_out, ref[2]), lev
        assert same(e_res, ref[4]) and same(e_out, out), lev
        assert inv == int(e_count) == ref[1] == int(ref[3]) >= 4, lev
        assert close_to_plain(out, want[0]), lev
        assert inv == int(want[1]), lev
