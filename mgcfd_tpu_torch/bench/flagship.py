"""The flagship problem: an M6-wing-scale box hierarchy, 68x64x70 =
304,640 nodes and 900,328 internal edges on the finest of 4 levels (the
reference's headline dataset is 300K nodes / 930K edges, README.md:71)."""
from __future__ import annotations

import dataclasses

from ..core.constants import MeshVariant
from ..core.types import MultigridMesh
from ..mesh.generate import generate_multigrid_box


@dataclasses.dataclass(frozen=True)
class FlagshipSpec:
    nx: int = 68
    ny: int = 64
    nz: int = 70
    num_levels: int = 4
    h: tuple = (0.1, 0.1, 0.1)
    variant: MeshVariant = MeshVariant.M6_WING
    cycles: int = 5


FLAGSHIP_SPEC = FlagshipSpec()


def flagship_mesh(spec: FlagshipSpec = FLAGSHIP_SPEC) -> MultigridMesh:
    return generate_multigrid_box(
        spec.nx, spec.ny, spec.nz, spec.num_levels, h=spec.h,
        variant=spec.variant, volume_jitter=0.2, seed=0,
        name="flagship-m6-scale")
