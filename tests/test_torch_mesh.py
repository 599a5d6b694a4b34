"""mgcfd_tpu_torch mesh generators and conditioning against mgcfd_tpu:
the same arguments and seeds give equal arrays."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from mgcfd_tpu.bench.flagship import FLAGSHIP_SPEC as JAX_SPEC
from mgcfd_tpu.bench.flagship import FlagshipSpec as JaxSpec
from mgcfd_tpu.bench.flagship import flagship_mesh as jax_flagship
from mgcfd_tpu.core.constants import MeshVariant as JaxVariant
from mgcfd_tpu.mesh import generate_box_mesh as jax_box
from mgcfd_tpu.mesh import generate_multigrid_box as jax_mg_box
from mgcfd_tpu.mesh.build import apply_ewt_conditioning as jax_ewt
from mgcfd_tpu.mesh.unstructured import \
    generate_unstructured_hierarchy as jax_tet
from mgcfd_tpu_torch.bench import FLAGSHIP_SPEC, FlagshipSpec, flagship_mesh
from mgcfd_tpu_torch.convert import mesh_from_arrays
from mgcfd_tpu_torch.core.constants import MeshVariant
from mgcfd_tpu_torch.mesh import (apply_ewt_conditioning, generate_box_mesh,
                                  generate_multigrid_box,
                                  generate_unstructured_hierarchy)

torch.set_num_threads(1)

FIELDS = ("volumes", "coords", "edge_a", "edge_b", "edge_w", "bedge_b",
          "bedge_w", "wedge_b", "wedge_w", "mg_mapping")


def assert_levels_equal(port_levels, jax_levels):
    assert len(port_levels) == len(jax_levels)
    for p, j in zip(port_levels, jax_levels):
        for f in FIELDS:
            a, b = getattr(p, f), getattr(j, f)
            if b is None:
                assert a is None, f
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert p.structured_dims == j.structured_dims


def test_box_level_equal():
    p = generate_box_mesh(5, 4, 3, h=(0.1, 0.2, 0.3), volume_jitter=0.3,
                          seed=7)
    j = jax_box(5, 4, 3, h=(0.1, 0.2, 0.3), volume_jitter=0.3, seed=7)
    assert_levels_equal([p], [j])


@pytest.mark.parametrize("dims", [(9, 8, 7, 3), (12, 12, 12, 3)])
def test_multigrid_box_equal(dims):
    p = generate_multigrid_box(*dims, h=(0.1, 0.1, 0.1))
    j = jax_mg_box(*dims, h=(0.1, 0.1, 0.1))
    assert_levels_equal(p.levels, j.levels)
    assert p.variant.name == j.variant.name


def test_tet_hierarchy_equal():
    p = generate_unstructured_hierarchy(8, 7, 6, 3, seed=2, h=0.1)
    j = jax_tet(8, 7, 6, 3, seed=2, h=0.1)
    assert_levels_equal(p.levels, j.levels)


@pytest.mark.parametrize("variant", list(MeshVariant))
def test_ewt_conditioning_equal(variant):
    j = jax_tet(6, 6, 6, 2, seed=1, variant=JaxVariant[variant.name])
    p = mesh_from_arrays(j)
    assert p.variant is variant
    jc = copy.deepcopy(j)
    jax_ewt(jc.levels, jc.variant)
    apply_ewt_conditioning(p.levels, p.variant)
    assert_levels_equal(p.levels, jc.levels)


def test_flagship_spec_and_mesh_equal():
    """The default spec is the 68x64x70, 4-level M6 box (304,640 nodes,
    900,328 internal edges); a reduced spec builds equal arrays."""
    port = dataclasses.asdict(FLAGSHIP_SPEC)
    ref = dataclasses.asdict(JAX_SPEC)
    assert port.pop("variant").name == ref.pop("variant").name
    assert port == ref
    nx, ny, nz = FLAGSHIP_SPEC.nx, FLAGSHIP_SPEC.ny, FLAGSHIP_SPEC.nz
    assert nx * ny * nz == 304_640
    assert ((nx - 1) * ny * nz + nx * (ny - 1) * nz
            + nx * ny * (nz - 1)) == 900_328
    p = flagship_mesh(FlagshipSpec(nx=10, ny=9, nz=8, num_levels=3))
    j = jax_flagship(JaxSpec(nx=10, ny=9, nz=8, num_levels=3))
    assert p.name == j.name
    assert_levels_equal(p.levels, j.levels)
