"""The port's prep/renumber.py against mgcfd_tpu.prep.renumber: rcm_order,
apply_node_order and renumber_hierarchy equal element for element on small
tets and boxes, locality_stats agrees, and the solver on a renumbered tet
equals mgcfd_tpu's on the same mesh at fp64 and, mapped back through the
order, the port's run on the mesh as generated (identify_differences:
relative 1e-8)."""
import numpy as np
import pytest
import torch

from mgcfd_tpu.core.config import SolverConfig as JaxConfig
from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu.prep import renumber as jax_renumber
from mgcfd_tpu.solver import MGCFDSolver as JaxSolver
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.config import SolverConfig
from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.core.types import LEVEL_ARRAYS
from mgcfd_tpu_torch.prep.renumber import (apply_node_order, locality_stats,
                                           rcm_order, renumber_hierarchy)
from mgcfd_tpu_torch.solver import MGCFDSolver
from mgcfd_tpu_torch.validate import identify_differences

torch.set_num_threads(1)
MESHES = {
    "tet6": lambda: jax_tet(6, 6, 6, 2, seed=1, h=0.1),
    "tet9": lambda: jax_tet(9, 7, 8, 3, seed=4, h=0.1),
    "box": lambda: jax_mg_box(6, 5, 4, 2, h=(0.1, 0.1, 0.1)),
    "box-fvcorr": lambda: jax_mg_box(7, 7, 5, 3, h=(0.1, 0.1, 0.1),
                                     variant=JaxVariant.FVCORR),
}


def assert_meshes_equal(got, want):
    assert got.num_levels == want.num_levels
    for g, w in zip(got.levels, want.levels):
        for f in LEVEL_ARRAYS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
                assert a.dtype == b.dtype, f


@pytest.mark.parametrize("kind", list(MESHES))
def test_rcm_order_equals_jax(kind):
    jm = MESHES[kind]()
    for lv, pl in zip(jm.levels, mesh_from_arrays(jm).levels):
        got = rcm_order(lv.num_nodes, lv.edge_a, lv.edge_b)
        want = jax_renumber.rcm_order(lv.num_nodes, lv.edge_a, lv.edge_b)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        assert locality_stats(apply_node_order(pl, got)) == \
            jax_renumber.locality_stats(
                jax_renumber.apply_node_order(lv, got))


def test_rcm_order_of_disconnected_nodes():
    """Isolated nodes and two components: each component is seeded by its
    lowest-degree node, as in mgcfd_tpu."""
    a = np.array([0, 1, 4, 5, 5], dtype=np.int32)
    b = np.array([1, 2, 5, 6, 7], dtype=np.int32)
    for n in (8, 10):
        np.testing.assert_array_equal(rcm_order(n, a, b),
                                      jax_renumber.rcm_order(n, a, b))


@pytest.mark.parametrize("align_coarse", [True, False])
@pytest.mark.parametrize("kind", list(MESHES))
def test_renumber_hierarchy_equals_jax(kind, align_coarse):
    jm = MESHES[kind]()
    got = renumber_hierarchy(mesh_from_arrays(jm), align_coarse=align_coarse)
    want = jax_renumber.renumber_hierarchy(jm, align_coarse=align_coarse)
    assert_meshes_equal(got, want)
    for g, w in zip(got.levels, want.levels):
        assert locality_stats(g) == jax_renumber.locality_stats(w)
    assert locality_stats(got.levels[0])["mean_span"] < \
        locality_stats(mesh_from_arrays(jm).levels[0])["mean_span"] \
        or kind.startswith("box")


def test_apply_node_order_refuses_a_partial_mapping():
    pm = mesh_from_arrays(MESHES["tet6"]())
    lv = pm.levels[0]
    lv.mg_mapping = lv.mg_mapping[:-1]
    with pytest.raises(ValueError, match="full fine->coarse"):
        apply_node_order(lv, np.arange(lv.num_nodes))


def node_map(renumbered, original):
    """perm with renumbered node i at original node perm[i], by coords."""
    key = {tuple(c): i for i, c in enumerate(original.coords)}
    return np.array([key[tuple(c)] for c in renumbered.coords])


@pytest.mark.parametrize("path", ["segment", "window", "pallas"])
def test_solver_on_renumbered_tet(path):
    """The port on the renumbered 6^3 tet equals mgcfd_tpu on the same
    renumbered mesh (fp64, 3 cycles), and mapped back through the order
    equals the port's run on the mesh as generated."""
    jm = MESHES["tet6"]()
    jr = jax_renumber.renumber_hierarchy(jm)
    ref = JaxSolver(jr, JaxConfig(dtype="float64"))
    ref.run(3)
    variant = MeshVariant[jm.variant.name]
    cfg = dict(dtype="float64", accumulate=path)
    s = MGCFDSolver(renumber_hierarchy(mesh_from_arrays(jm)),
                    SolverConfig(**cfg), device="cpu")
    s.run(3)
    plain = MGCFDSolver(mesh_from_arrays(jm), SolverConfig(**cfg),
                        device="cpu")
    plain.run(3)
    identify_differences(np.array(s.rms_history),
                         np.array(ref.rms_history), variant)
    identify_differences(np.array(s.rms_history),
                         np.array(plain.rms_history), variant)
    for lev in range(jm.num_levels):
        identify_differences(s.variables(lev), ref.variables(lev), variant)
        perm = node_map(jr.levels[lev], jm.levels[lev])
        back = np.empty_like(s.variables(lev))
        back[perm] = s.variables(lev)
        identify_differences(back, plain.variables(lev), variant)
