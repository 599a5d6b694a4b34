"""Unstructured tetrahedral levels with median-dual finite-volume metrics
(one level: a frozen copy of mgcfd_tpu_torch.mesh.unstructured's, the
same arrays for the same arguments), and a hierarchy whose every level's
point grid is given: each level spans level 0's box, each is an
independent Delaunay mesh, and a fine node maps to the nearest coarse
node in 3D.

  - node volume = sum over incident tets of |T| / 4,
  - internal edge weight = the dual-face area vector, oriented a -> b,
  - hull faces give area/3 per vertex as boundary or wall edges, stored
    inward (the box generator's convention).
Node ids are shuffled by the seed, as an imported mesh arrives in
arbitrary order. The triangulation is scipy's (qhull): the same scipy
gives the same mesh.
"""
from __future__ import annotations

import numpy as np

from .level import Hierarchy, Level

# local vertex pairs of a tet's 6 edges, the 2 remaining vertices, and
# the parity of the permutation (p, q, r, s) of (0, 1, 2, 3)
_EDGE_SLOTS = [((0, 1), (2, 3), +1), ((0, 2), (1, 3), -1),
               ((0, 3), (1, 2), +1), ((1, 2), (0, 3), +1),
               ((1, 3), (0, 2), -1), ((2, 3), (0, 1), +1)]


def _jittered_points(nx: int, ny: int, nz: int, h, jitter: float,
                     rng) -> np.ndarray:
    """Grid of spacing h (a number, or one per axis) + uniform jitter in
    each point's free directions only, so the domain stays the exact
    convex box and no grid co-planarity survives (qhull would emit flat
    boundary tets otherwise)."""
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    pts = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3).astype(np.float64)
    hi = np.array([nx, ny, nz], dtype=np.float64) - 1
    free = (pts > 0) & (pts < hi)
    h = np.asarray(h, np.float64)
    pts = pts * h
    pts += free * (rng.random(pts.shape) - 0.5) * (2 * jitter * h)
    return pts


def tet_dual_level(points: np.ndarray, tets: np.ndarray,
                   hull: np.ndarray, wall_frac: float = 0.2) -> Level:
    """Median-dual Level from points (N, 3), tets (T, 4) and hull
    triangles (F, 3). Hull faces in the lowest `wall_frac` of the z-extent
    become wall edges, the rest far-field boundary edges."""
    n = points.shape[0]
    P = points[tets]
    centroid = P.mean(axis=1)
    d1, d2, d3 = (P[:, i] - P[:, 0] for i in (1, 2, 3))
    det6 = np.einsum("ti,ti->t", d1, np.cross(d2, d3))
    vol_t = np.abs(det6) / 6.0
    orient = np.sign(det6)
    orient[orient == 0] = 1.0

    volumes = np.zeros(n)
    np.add.at(volumes, tets.ravel(), np.repeat(vol_t / 4.0, 4))

    keys, vecs = [], []
    for (i, j), (k, l), parity in _EDGE_SLOTS:
        p, q = tets[:, i], tets[:, j]
        Pp, Pq, Pr, Ps = P[:, i], P[:, j], P[:, k], P[:, l]
        m = 0.5 * (Pp + Pq)
        f1 = (Pp + Pq + Ps) / 3.0
        f2 = (Pp + Pq + Pr) / 3.0
        S = 0.5 * (np.cross(f1 - m, centroid - m)
                   + np.cross(centroid - m, f2 - m))
        S = S * (-parity * orient)[:, None]
        a = np.minimum(p, q)
        b = np.maximum(p, q)
        S = np.where((p > q)[:, None], -S, S)
        keys.append(a.astype(np.int64) * n + b)
        vecs.append(S)
    keys = np.concatenate(keys)
    vecs = np.concatenate(vecs)
    uniq, inv = np.unique(keys, return_inverse=True)
    edge_w = np.zeros((uniq.shape[0], 3))
    np.add.at(edge_w, inv, vecs)
    edge_a = (uniq // n).astype(np.int32)
    edge_b = (uniq % n).astype(np.int32)
    order = np.lexsort((edge_a, edge_b))
    edge_a, edge_b, edge_w = edge_a[order], edge_b[order], edge_w[order]

    A, B, C = points[hull[:, 0]], points[hull[:, 1]], points[hull[:, 2]]
    fnorm = 0.5 * np.cross(B - A, C - A)
    fcent = (A + B + C) / 3.0
    outward = np.einsum("fi,fi->f", fnorm,
                        fcent - points.mean(axis=0)) >= 0
    fnorm = np.where(outward[:, None], fnorm, -fnorm)
    zmin, zmax = points[:, 2].min(), points[:, 2].max()
    is_wall = fcent[:, 2] <= zmin + wall_frac * (zmax - zmin)

    face_b = hull.ravel().astype(np.int32)
    face_w = np.repeat(-fnorm / 3.0, 3, axis=0)
    face_is_wall = np.repeat(is_wall, 3)

    bedge_b = face_b[~face_is_wall]
    bedge_w = face_w[~face_is_wall]
    wedge_b = face_b[face_is_wall]
    wedge_w = face_w[face_is_wall]
    bo = np.argsort(bedge_b, kind="stable")
    wo = np.argsort(wedge_b, kind="stable")

    lvl = Level(volumes=volumes, coords=points.copy(),
                edge_a=edge_a, edge_b=edge_b, edge_w=edge_w,
                bedge_b=bedge_b[bo], bedge_w=bedge_w[bo],
                wedge_b=wedge_b[wo].astype(np.int32),
                wedge_w=wedge_w[wo])
    lvl.validate()
    return lvl


def _delaunay_level(points: np.ndarray, rng, wall_frac: float) -> Level:
    from scipy.spatial import Delaunay

    perm = rng.permutation(points.shape[0])
    pts = points[perm]
    tri = Delaunay(pts)
    return tet_dual_level(pts, tri.simplices.astype(np.int64),
                          tri.convex_hull.astype(np.int64), wall_frac)


def generate_tet_hierarchy(level_dims, *, h=(1.0, 1.0, 1.0),
                           jitter: float = 0.35, wall_frac: float = 0.2,
                           seed: int = 0,
                           variant: str = "m6wing") -> Hierarchy:
    """Levels over jittered grids of (nx, ny, nz) points each,
    level_dims[0] the finest at spacing h, each coarser one spread over
    the same box (its own spacing per axis), all drawn from one generator
    seeded once. Each level keeps its own dual volumes; a coarse node
    nearest to no fine node has no child."""
    from scipy.spatial import cKDTree

    dims = [tuple(int(x) for x in d) for d in level_dims]
    extent = np.array([(n - 1) * s for n, s in zip(dims[0], h)])
    rng = np.random.default_rng(seed)
    levels = []
    for lev, d in enumerate(dims):
        spacing = extent / np.maximum(np.array(d) - 1, 1) if lev \
            else np.asarray(h, np.float64)
        levels.append(_delaunay_level(
            _jittered_points(*d, spacing, jitter, rng), rng, wall_frac))
    for fine, coarse in zip(levels, levels[1:]):
        _, nearest = cKDTree(coarse.coords).query(fine.coords)
        fine.mg_mapping = nearest.astype(np.int64)
    return Hierarchy(levels=levels, variant=variant)
