"""Structured box grids in the reference's unstructured node/edge/volume
format, with far-field and wall faces, seeded volume jitter and a
multigrid hierarchy by 2x coarsening per dimension. Arrays are bit-equal
to mgcfd_tpu.mesh.generate for the same arguments."""
from __future__ import annotations

import numpy as np

from ..core.constants import MeshVariant
from ..core.types import MeshLevel, MultigridMesh


def _box_level(nx: int, ny: int, nz: int, h, origin, volume_jitter: float,
               seed: int) -> MeshLevel:
    """One level: internal normals point a -> b, boundary and wall normals
    are stored pointing inward."""
    hx, hy, hz = h
    n = nx * ny * nz

    def nid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    ids = (ix * ny + iy) * nz + iz

    coords = np.stack([origin[0] + ix * hx,
                       origin[1] + iy * hy,
                       origin[2] + iz * hz], axis=1).astype(np.float64)

    rng = np.random.default_rng(seed)
    volumes = hx * hy * hz * (1.0 + volume_jitter
                              * (rng.random(n) - 0.5)).astype(np.float64)

    area = np.array([hy * hz, hx * hz, hx * hy])

    # internal edges, ordered by node b then by listing rank (-x, -y, -z)
    ea, eb, ew = [], [], []
    for d, (di, mask_src) in enumerate((
            (np.array([1, 0, 0]), ix > 0),
            (np.array([0, 1, 0]), iy > 0),
            (np.array([0, 0, 1]), iz > 0))):
        b = ids[mask_src]
        a = nid(ix[mask_src] - di[0], iy[mask_src] - di[1],
                iz[mask_src] - di[2])
        w = np.zeros((b.size, 3))
        w[:, d] = area[d]
        ea.append(a)
        eb.append(b)
        ew.append(w)
    edge_a = np.concatenate(ea)
    edge_b = np.concatenate(eb)
    edge_w = np.concatenate(ew)
    rank = np.concatenate([np.full(x.size, i) for i, x in enumerate(ea)])
    order = np.lexsort((rank, edge_b))
    edge_a = edge_a[order].astype(np.int32)
    edge_b = edge_b[order].astype(np.int32)
    edge_w = edge_w[order]

    # the -z face is a wall, the other five are far-field boundaries
    def face(mask, d, sign):
        b = ids[mask]
        w = np.zeros((b.size, 3))
        w[:, d] = -sign * area[d]
        return b, w

    faces = [face(ix == 0, 0, -1), face(ix == nx - 1, 0, +1),
             face(iy == 0, 1, -1), face(iy == ny - 1, 1, +1),
             face(iz == nz - 1, 2, +1)]
    bedge_b = np.concatenate([f[0] for f in faces])
    bedge_w = np.concatenate([f[1] for f in faces])
    border = np.argsort(bedge_b, kind="stable")
    bedge_b = bedge_b[border].astype(np.int32)
    bedge_w = bedge_w[border]

    wedge_b, wedge_w = face(iz == 0, 2, -1)
    wedge_b = wedge_b.astype(np.int32)

    lvl = MeshLevel(volumes=volumes, coords=coords,
                    edge_a=edge_a, edge_b=edge_b, edge_w=edge_w,
                    bedge_b=bedge_b, bedge_w=bedge_w,
                    wedge_b=wedge_b, wedge_w=wedge_w,
                    structured_dims=(nx, ny, nz))
    lvl.validate()
    return lvl


def generate_box_mesh(nx: int, ny: int, nz: int, *,
                      h=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
                      volume_jitter: float = 0.2,
                      seed: int = 0) -> MeshLevel:
    return _box_level(nx, ny, nz, h, origin, volume_jitter, seed)


def generate_multigrid_box(nx: int, ny: int, nz: int, num_levels: int, *,
                           h=(1.0, 1.0, 1.0),
                           variant: MeshVariant = MeshVariant.M6_WING,
                           volume_jitter: float = 0.2,
                           seed: int = 0,
                           name: str = "box") -> MultigridMesh:
    """Hierarchy by 2x coarsening per dimension. Coarse node (i, j, k)
    sits on fine node (2i, 2j, 2k), so a quarter of the fine nodes
    coincide with their parents (the direct-copy branch of the
    prolongation, mg_loops.cpp:745-752). Coarse volumes are the sums of
    their children's volumes."""
    levels: list[MeshLevel] = []
    dims = (nx, ny, nz)
    spacing = h
    for lev in range(num_levels):
        lvl = _box_level(*dims, spacing, (0.0, 0.0, 0.0), volume_jitter,
                         seed + lev)
        levels.append(lvl)
        if lev == num_levels - 1:
            break
        cnx, cny, cnz = (max(1, -(-d // 2)) for d in dims)
        fnx, fny, fnz = dims
        fi = np.arange(fnx * fny * fnz)
        fz = fi % fnz
        fy = (fi // fnz) % fny
        fx = fi // (fnz * fny)
        lvl.mg_mapping = (((fx // 2) * cny + (fy // 2)) * cnz
                          + (fz // 2)).astype(np.int64)
        dims = (cnx, cny, cnz)
        spacing = tuple(s * 2 for s in spacing)

    for lev in range(num_levels - 1):
        fine, coarse = levels[lev], levels[lev + 1]
        vols = np.zeros(coarse.num_nodes)
        np.add.at(vols, fine.mg_mapping, fine.volumes)
        coarse.volumes = vols
    return MultigridMesh(levels=levels, variant=variant, name=name)
