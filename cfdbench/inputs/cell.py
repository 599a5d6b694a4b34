"""A cell-centred tetrahedral level, as Rodinia's cfd and MG-CFD's fvcorr
mesh read it: every tetrahedron is one control volume, with one face
neighbour across each of its 4 faces.

The points are a jittered grid of (nx, ny, nz) points (tet.py's, so the
box stays exact), and every grid cube is cut into the 6 Kuhn
(Freudenthal) tetrahedra along its main diagonal: 6 (nx-1)(ny-1)(nz-1)
tetrahedra, conforming across the cubes, with no slivers and no qhull.

  - node volume = |T|, node coords = T's centroid,
  - an internal edge for each face shared by two tetrahedra, its weight
    the face's area vector oriented a -> b,
  - each hull face a wall or a far-field edge, its area vector stored
    inward (the box generator's convention).
A wall, as Rodinia labels its faces (-1), carries its node's pressure
alone; a far-field face (-2) the mean of its node's flux and the free
stream's. MG-CFD reads both labels alike, but names -1 'boundary' (the
Level's bedge) and -2 'wall' (wedge), so the box and tet generators'
walls are this generator's far field. Here the box's bottom face (z = 0)
is wall, a plate along the free stream, and the other five faces far
field: a box of slip walls that the Mach 1.2 stream runs into blows up
within a few thousand cycles, in the float64 reference too.
Node ids are shuffled by the seed, as an imported mesh arrives in
arbitrary order.
"""
from __future__ import annotations

import itertools

import numpy as np

from .level import Hierarchy, Level
from .tet import _jittered_points


def _kuhn_corners() -> np.ndarray:
    """(6, 4, 3) corners (0 or 1 along x, y, z) of the unit cube's 6 Kuhn
    tetrahedra: each the path (0,0,0) -> e_a -> e_a + e_b -> (1,1,1) of an
    axis permutation (a, b, c), its middle vertices swapped where the
    permutation is odd, so that every tetrahedron is positively
    oriented."""
    eye = np.eye(3, dtype=np.int64)
    out = []
    for a, b, c in itertools.permutations(range(3)):
        path = [0 * eye[0], eye[a], eye[a] + eye[b], eye.sum(axis=0)]
        if ((a > b) + (a > c) + (b > c)) % 2:
            path[1], path[2] = path[2], path[1]
        out.append(path)
    return np.array(out)


def kuhn_tets(nx: int, ny: int, nz: int) -> np.ndarray:
    """(6 (nx-1)(ny-1)(nz-1), 4) point ids of the grid's tetrahedra, the
    points numbered as tet._jittered_points numbers them."""
    ix, iy, iz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([ix, iy, iz], axis=-1).reshape(-1, 1, 1, 3)
    corner = base + _kuhn_corners()[None]      # (cubes, 6, 4, 3)
    ids = (corner[..., 0] * ny + corner[..., 1]) * nz + corner[..., 2]
    return ids.reshape(-1, 4)


def cell_level(points: np.ndarray, tets: np.ndarray) -> Level:
    """Cell-centred Level of the tetrahedra tets (T, 4) over points
    (N, 3), node i the tetrahedron tets[i]; hull faces on the bottom
    face walls (bedge), the rest far field (wedge), as the module
    docstring says. ValueError where a tetrahedron is not positively
    oriented or a face is shared by more than two."""
    P = points[tets]
    d1, d2, d3 = (P[:, i] - P[:, 0] for i in (1, 2, 3))
    det6 = np.einsum("ti,ti->t", d1, np.cross(d2, d3))
    if not (det6 > 0).all():
        raise ValueError(f"{int((det6 <= 0).sum())} tetrahedra are not "
                         f"positively oriented")
    n = tets.shape[0]

    # the 4 faces of every tetrahedron, as sorted point triples; face f of
    # tetrahedron t is the one opposite its local vertex f
    faces = np.sort(np.stack([np.delete(tets, f, axis=1) for f in range(4)],
                             axis=1).reshape(-1, 3), axis=1)
    owner = np.repeat(np.arange(n, dtype=np.int64), 4)
    opposite = tets.reshape(-1)
    A, B, C = (points[faces[:, i]] for i in range(3))
    # the area vector from the sorted triple, the same for both sides,
    # turned outward from its owner (away from the opposite vertex)
    area = 0.5 * np.cross(B - A, C - A)
    away = np.einsum("fi,fi->f", area, A - points[opposite]) > 0
    area = np.where(away[:, None], area, -area)

    m = np.int64(points.shape[0])
    keys = (faces[:, 0] * m + faces[:, 1]) * m + faces[:, 2]
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    first = np.ones(k.shape[0], bool)
    first[1:] = k[1:] != k[:-1]
    counts = np.diff(np.append(np.flatnonzero(first), k.shape[0]))
    if counts.max() > 2:
        raise ValueError("a face is shared by more than two tetrahedra")
    starts = order[first]
    shared = counts == 2
    i1 = starts[shared]
    i2 = order[np.flatnonzero(first)[shared] + 1]
    t1, t2 = owner[i1], owner[i2]
    edge_a = np.minimum(t1, t2)
    edge_b = np.maximum(t1, t2)
    edge_w = np.where((t1 == edge_a)[:, None], area[i1], area[i2])
    eo = np.lexsort((edge_a, edge_b))
    edge_a, edge_b, edge_w = edge_a[eo], edge_b[eo], edge_w[eo]

    hull = starts[~shared]
    is_wall = (points[faces[hull], 2] == 0.0).all(axis=1)
    face_b = owner[hull]
    face_w = -area[hull]
    bo = np.argsort(face_b[is_wall], kind="stable")
    wo = np.argsort(face_b[~is_wall], kind="stable")

    lvl = Level(volumes=det6 / 6.0, coords=P.mean(axis=1),
                edge_a=edge_a.astype(np.int32),
                edge_b=edge_b.astype(np.int32), edge_w=edge_w,
                bedge_b=face_b[is_wall][bo].astype(np.int32),
                bedge_w=face_w[is_wall][bo],
                wedge_b=face_b[~is_wall][wo].astype(np.int32),
                wedge_w=face_w[~is_wall][wo])
    lvl.validate()
    return lvl


def generate_cell_hierarchy(dims, *, h=(1.0, 1.0, 1.0),
                            jitter: float = 0.2, seed: int = 0,
                            variant: str = "fvcorr") -> Hierarchy:
    """One cell-centred level over a jittered grid of dims = (nx, ny, nz)
    points at spacing h, its tetrahedra in an order drawn from the
    seed."""
    nx, ny, nz = (int(x) for x in dims)
    rng = np.random.default_rng(seed)
    points = _jittered_points(nx, ny, nz, h, jitter, rng)
    tets = kuhn_tets(nx, ny, nz)
    tets = tets[rng.permutation(tets.shape[0])]
    return Hierarchy(levels=[cell_level(points, tets)],
                     variant=variant)
