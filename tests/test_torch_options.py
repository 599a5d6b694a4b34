"""The reference's kernel variants and the solver options of ROADMAP queue
1 item 4 (accumulate 'scatter' and 'ell', flux_fission,
flux_precompute_edge_weights, flux_cripple, mg_gather=False and the plan
cache), against mgcfd_tpu at fp64 on the CPU.

Each option runs in both packages from identical arrays on an 8^3 box and
an 8^3 tet, both 2 levels, FVCORR (undamped, so the state moves); the
per-cycle RMS and every level's variables are held to
identify_differences (relative 1e-8, absolute floor 1e-15). The crippled
twin must leave the port's state bit-equal to a run without it on every
path."""
import dataclasses

import numpy as np
import pytest
import torch

from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.ops import internal_edge_flux_crippled as jax_crippled
from mgcfd_tpu.prep.incidence import build_incidence as jax_incidence
from mgcfd_tpu.solver import MGCFDSolver as JaxSolver
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import MeshVariant, far_field_state
from mgcfd_tpu_torch.ops import accumulate_flux, internal_edge_flux_crippled
from mgcfd_tpu_torch.prep import plancache
from mgcfd_tpu_torch.prep.incidence import (DeviceIncidence, build_incidence,
                                            ell_accumulate)
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.validate import identify_differences

torch.set_num_threads(1)
CYCLES = 2
VARIANT = MeshVariant.FVCORR
_MESHES: dict = {}


def jax_mesh(kind):
    if kind not in _MESHES:
        v = JaxVariant.FVCORR
        _MESHES[kind] = (
            jax_mg_box(8, 8, 8, 2, h=(0.1, 0.1, 0.1), variant=v)
            if kind == "box" else jax_tet(8, 8, 8, 2, seed=1, h=0.1,
                                          variant=v))
    return _MESHES[kind]


def port(kind, **kw):
    return MGCFDSolver(mesh_from_arrays(jax_mesh(kind)),
                       SolverConfig(dtype="float64", **kw), device="cpu")


def same_as_jax(s, ref, levels=2):
    identify_differences(np.array(s.rms_history), np.array(ref.rms_history),
                         VARIANT)
    for lev in range(levels):
        identify_differences(s.variables(lev), ref.variables(lev), VARIANT)


# (accumulate, flag) pairs: each variant on the modes that take it
OPTIONS = [("scatter", None), ("ell", None), ("segment", "flux_fission"),
           ("ell", "flux_fission"), ("segment",
                                     "flux_precompute_edge_weights"),
           ("scatter", "flux_precompute_edge_weights"),
           ("segment", "flux_cripple"), ("auto", "flux_fission")]


@pytest.mark.parametrize("accumulate,flag", OPTIONS)
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_option_matches_jax(kind, accumulate, flag):
    kw = {"accumulate": accumulate, **({flag: True} if flag else {})}
    ref = JaxSolver(jax_mesh(kind), JaxConfig(dtype="float64", **kw))
    ref.run(CYCLES)
    s = port(kind, **kw)
    assert s.config.accumulate == ref.config.accumulate
    s.run(CYCLES)
    same_as_jax(s, ref)


CRIPPLE_PATHS = {
    "segment": {"accumulate": "segment"},
    "scatter": {"accumulate": "scatter"},
    "ell": {"accumulate": "ell"},
    "segment-fission": {"accumulate": "segment", "flux_fission": True},
    "window": {"accumulate": "window"},
    "window-unfused": {"accumulate": "window", "fuse_window_stage": False},
    "pallas": {"accumulate": "pallas"},
    "pallas-unfused": {"accumulate": "pallas", "fuse_stage": False},
    "shift": {"accumulate": "shift"},
    "shift-transposed": {"accumulate": "shift", "transposed": True}}


@pytest.mark.parametrize("path", list(CRIPPLE_PATHS))
def test_cripple_leaves_the_state_bit_equal(path, monkeypatch):
    """flux_cripple runs the crippled twin before every RK stage's flux
    (6 stages a cycle on 2 levels: 3 a visit, level 0 and level 1) and
    discards it: every level's variables and residuals and the RMS equal
    a run without the flag bit for bit."""
    import mgcfd_tpu_torch.solver.solver as solver_mod
    calls = []
    real = solver_mod.internal_edge_flux_crippled

    def counted(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(solver_mod, "internal_edge_flux_crippled", counted)
    plain = port("tet", **CRIPPLE_PATHS[path])
    crippled = port("tet", flux_cripple=True, **CRIPPLE_PATHS[path])
    plain.run(CYCLES)
    assert not calls
    crippled.run(CYCLES)
    assert len(calls) == 2 * 3 * CYCLES
    for key in ("variables", "residuals"):
        for a, b in zip(plain.state[key], crippled.state[key]):
            assert torch.equal(a, b)
    assert plain.rms_history == crippled.rms_history


def test_crippled_flux_matches_jax():
    """The gutted arithmetic, op for op: seeded states and normals through
    both packages' internal_edge_flux_crippled, within rel 1e-12."""
    rng = np.random.default_rng(5)
    ff = far_field_state()[0]
    q_a = ff * (1 + 0.1 * rng.standard_normal((500, 5)))
    q_b = ff * (1 + 0.1 * rng.standard_normal((500, 5)))
    ew = rng.standard_normal((500, 3))
    want = np.asarray(jax_crippled(q_a, q_b, ew))
    got = internal_edge_flux_crippled(*(torch.as_tensor(x)
                                        for x in (q_a, q_b, ew))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kind", ["box", "tet"])
def test_incidence_tables_equal_jax(kind):
    """build_incidence array for array, and ell_accumulate equal to the
    chained scatter within rounding."""
    jm = jax_mesh(kind)
    lv = mesh_from_arrays(jm).levels[0]
    t, ref = build_incidence(lv), jax_incidence(jm.levels[0])
    assert np.array_equal(t.slots, ref.slots)
    assert np.array_equal(t.signs, ref.signs)
    assert (t.width, t.stream_len) == (ref.width, ref.stream_len)
    rng = np.random.default_rng(2)
    vi, vb, vw = (torch.as_tensor(rng.standard_normal((n, 5))) for n in
                  (lv.num_internal_edges, lv.num_boundary_edges,
                   lv.num_wall_edges))
    ell = ell_accumulate(DeviceIncidence.from_tables(t, "cpu",
                                                     torch.float64),
                         vi, vb, vw)
    idx = [torch.as_tensor(a).long() for a in
           (lv.edge_a, lv.edge_b, lv.bedge_b, lv.wedge_b)]
    sc = accumulate_flux(lv.num_nodes, idx[0], idx[1], vi, idx[2], vb,
                         idx[3], vw, mode="scatter")
    torch.testing.assert_close(ell, sc, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("accumulate", ["segment", "window", "pallas"])
@pytest.mark.parametrize("kind", ["box", "tet"])
def test_mg_gather_off_matches_jax(kind, accumulate):
    """mg_gather=False: the kernel paths build no transfer plans and
    restrict and prolong through the plain scatter formulation, as
    mgcfd_tpu does with its gather tables off (its segment path here)."""
    ref = JaxSolver(jax_mesh(kind), JaxConfig(dtype="float64",
                                              accumulate="segment",
                                              mg_gather=False))
    ref.run(CYCLES)
    s = port(kind, accumulate=accumulate, mg_gather=False)
    assert all(lv.restrict_csr is None and lv.prolong_csr is None
               for lv in s.dmesh.levels)
    s.run(CYCLES)
    same_as_jax(s, ref)


@pytest.mark.parametrize("accumulate,transposed", [
    ("shift", False), ("shift", True), ("pallas", False),
    ("window", False), ("segment", True)])
def test_fission_refused_as_jax_refuses_it(accumulate, transposed):
    """flux_fission on the span and CSR formulations (or a transposed
    state): the same ValueError, word for word, as mgcfd_tpu's."""
    kw = dict(flux_fission=True, accumulate=accumulate,
              transposed=transposed)
    with pytest.raises(ValueError) as mine:
        SolverConfig(**kw).validate()
    with pytest.raises(ValueError) as ref:
        JaxConfig(**kw).validate()
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("field,value", [
    ("num_partitions", 2), ("partition_2d", "2x2"), ("shard_levels", 2)])
def test_sharding_fields_still_refused(field, value):
    with pytest.raises(NotImplementedError, match="item 9"):
        SolverConfig(**{field: value}).validate()


def _plans(s):
    """Every plan array a solver uploaded, by (level, name)."""
    out = {}
    for i, lv in enumerate(s.dmesh.levels):
        for name in ("csr", "spill_csr", "restrict_csr", "prolong_csr"):
            plan = getattr(lv, name)
            if plan is not None:
                for f in dataclasses.fields(plan):
                    v = getattr(plan, f.name)
                    out[(i, name, f.name)] = v
        if lv.shift is not None:
            out[(i, "shift", "w")] = lv.shift.w
            out[(i, "shift", "deltas")] = list(lv.shift.deltas)
        if lv.restrict_mapped is not None:
            out[(i, "restrict_mapped")] = lv.restrict_mapped
    return out


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("accumulate", ["window", "pallas"])
def test_plan_cache_round_trip(tmp_path, accumulate):
    """The first build with plan_cache_dir builds and stores every plan
    (under kinds of the port's own); the second loads every one, and the
    uploaded plans equal those of a build without the cache."""
    cache = str(tmp_path / "plans")
    plancache.reset_stats()
    first = port("box", accumulate=accumulate, plan_cache_dir=cache)
    built = dict(plancache.STATS["built"])
    assert sum(built.values()) > 0 and not plancache.STATS["loaded"]
    assert all(k.startswith("torch-") for k in built)
    plancache.reset_stats()
    second = port("box", accumulate=accumulate, plan_cache_dir=cache)
    assert plancache.STATS["loaded"] == built
    assert not plancache.STATS["built"]
    none = port("box", accumulate=accumulate)
    want = _plans(none)
    for s in (first, second):
        got = _plans(s)
        assert got.keys() == want.keys()
        assert all(_equal(got[k], want[k]) for k in want)


def test_plan_cache_rebuilds_a_bad_file(tmp_path):
    """A truncated or foreign file under a plan's name is rebuilt and
    replaced, never trusted."""
    cache = tmp_path / "plans"
    port("tet", accumulate="window", plan_cache_dir=str(cache))
    files = sorted(cache.glob("torch-flux-*.npz"))
    assert files
    files[0].write_bytes(b"not an npz")
    plancache.reset_stats()
    s = port("tet", accumulate="window", plan_cache_dir=str(cache))
    assert plancache.STATS["built"] == {"torch-flux": 1}
    assert not list(cache.glob("*.tmp.npz"))
    ref = port("tet", accumulate="window")
    assert torch.equal(s.dmesh.levels[0].csr.col, ref.dmesh.levels[0].csr.col)


@pytest.mark.parametrize("accumulate", ["segment", "ell"])
def test_fission_update_counted_as_jax(accumulate):
    """Under flux_fission the instrumented solver times the separate
    update call: the same (function, level) keys, iterations (internal +
    boundary + wall edges for update) and calls as mgcfd_tpu's
    instrumented solver, and the same state; with flux_cripple neither
    runs the twin there, and the state is the same too."""
    from mgcfd_tpu.monitor import InstrumentedSolver as JaxInstrumented
    from mgcfd_tpu_torch.monitor import InstrumentedSolver
    for kw in ({"flux_fission": True}, {"flux_cripple": True}):
        cfg = dict(dtype="float64", accumulate=accumulate, **kw)
        ref = JaxInstrumented(jax_mesh("tet"), JaxConfig(**cfg))
        ref.run(1)
        s = InstrumentedSolver(mesh_from_arrays(jax_mesh("tet")),
                               SolverConfig(**cfg), device="cpu")
        s.run(1)
        assert dict(s.stats.iters) == dict(ref.stats.iters)
        assert dict(s.stats.calls) == dict(ref.stats.calls)
        assert any(f == "update" for f, _ in s.stats.calls) == \
            ("flux_fission" in kw)
        identify_differences(s.variables(0), np.asarray(ref.variables(0)),
                             VARIANT)
