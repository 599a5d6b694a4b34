"""Structured box grids in the reference's node/edge/volume format, with
far-field and wall faces and seeded volume jitter (one level: a frozen
copy of mgcfd_tpu_torch.mesh.generate's, the same arrays for the same
arguments), and a hierarchy whose every level's size is given: each
level spans level 0's box, and a fine node maps to the nearest coarse
node along each axis."""
from __future__ import annotations

import numpy as np

from .level import Hierarchy, Level


def _box_level(nx: int, ny: int, nz: int, h, origin, volume_jitter: float,
               seed: int) -> Level:
    """One level: internal normals a -> b; boundary and wall normals
    stored inward."""
    hx, hy, hz = h
    n = nx * ny * nz

    def nid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    ids = (ix * ny + iy) * nz + iz
    coords = np.stack([origin[0] + ix * hx, origin[1] + iy * hy,
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
    wedge_b, wedge_w = face(iz == 0, 2, -1)
    lvl = Level(volumes=volumes, coords=coords, edge_a=edge_a,
                edge_b=edge_b, edge_w=edge_w,
                bedge_b=bedge_b[border].astype(np.int32),
                bedge_w=bedge_w[border],
                wedge_b=wedge_b.astype(np.int32), wedge_w=wedge_w)
    lvl.validate()
    return lvl


def generate_box_hierarchy(level_dims, *, h=(1.0, 1.0, 1.0),
                           variant: str = "m6wing",
                           volume_jitter: float = 0.2,
                           seed: int = 0) -> Hierarchy:
    """Levels of (nx, ny, nz) nodes each, level_dims[0] the finest at
    spacing h, each coarser one spread over the same box; coarse volumes
    are the sums of their children's. Every coarse node has a child
    while no level is finer than the one above it."""
    dims = [tuple(int(x) for x in d) for d in level_dims]
    extent = np.array([(n - 1) * s for n, s in zip(dims[0], h)])
    levels = []
    for lev, d in enumerate(dims):
        spacing = tuple(extent / np.maximum(np.array(d) - 1, 1)) \
            if lev else tuple(h)
        levels.append(_box_level(*d, spacing, (0.0, 0.0, 0.0),
                                 volume_jitter, seed + lev))
    for lev in range(len(dims) - 1):
        (fx, fy, fz), (cx, cy, cz) = dims[lev], dims[lev + 1]
        fi = np.arange(fx * fy * fz)

        def near(i, nf, nc):
            return np.rint(i * ((nc - 1) / max(nf - 1, 1))).astype(np.int64)
        fine, coarse = levels[lev], levels[lev + 1]
        fine.mg_mapping = ((near(fi // (fy * fz), fx, cx) * cy
                            + near((fi // fz) % fy, fy, cy)) * cz
                           + near(fi % fz, fz, cz))
        vols = np.zeros(coarse.num_nodes)
        np.add.at(vols, fine.mg_mapping, fine.volumes)
        if not (vols > 0).all():
            raise ValueError(f"level {lev + 1} is finer than level {lev}")
        coarse.volumes = vols
    return Hierarchy(levels=levels, variant=variant)
