"""The reference app's mesh files (warwick-hpsc/MG-CFD-app-plain):

  <mesh>.dat         header "nel number_of_edges", then per node: volume,
                     degree, then degree x (neighbour ex ey ez); neighbour
                     -1 is a far-field face, -2 a wall face.
  <mesh>.dat.coords  "x y z" per node.
  mg<i>.dat          count, then fine node i -> coarse node id.
  input.dat          size / num_levels / mesh_name, then [levels] and
                     [mg_mapping] sections of "idx = filename" lines.

The writer's text is mgcfd_tpu_torch.mesh.io_dat's, byte for byte (%.17e,
so a round trip is exact). The reader is the benchmark's own: it parses a
file's tokens with numpy and applies the reference's read rules, and
read_hierarchy keeps what it parsed in an npz beside the files, so that
only the first read of a checkout parses the text.
"""
from __future__ import annotations

import os

import numpy as np

from .level import Hierarchy, Level

BOUNDARY = -1
WALL = -2
_CHUNK = 16384
_NPZ = "reference_mesh.npz"


def _flip(variant: str) -> float:
    """FVCORR flips every normal at read time; the others only the
    internal ones."""
    return -1.0 if variant == "fvcorr" else 1.0


def _records(f, templates, values, starts) -> None:
    for r0 in range(0, len(templates), _CHUNK):
        r1 = min(r0 + _CHUNK, len(templates))
        f.write("".join(templates[r0:r1])
                % tuple(values[starts[r0]:starts[r1]].tolist()))


def write_grid_dat(path: str, lvl: Level, variant: str) -> None:
    """A node lists the internal edges it is the a end of (neighbour b,
    +w), then those it is the b end of (neighbour a, -w), then its
    boundary and wall faces; the .coords file beside it."""
    ne, nb, nw = (lvl.edge_a.shape[0], lvl.bedge_b.shape[0],
                  lvl.wedge_b.shape[0])
    flip = _flip(variant)
    node = np.concatenate([lvl.edge_a, lvl.edge_b, lvl.bedge_b,
                           lvl.wedge_b]).astype(np.int64)
    ids = np.concatenate([lvl.edge_b, lvl.edge_a, np.full(nb, BOUNDARY),
                          np.full(nw, WALL)]).astype(np.int64)
    wts = np.concatenate([lvl.edge_w, -lvl.edge_w, flip * lvl.bedge_w,
                          flip * lvl.wedge_w]).reshape(2 * ne + nb + nw, 3)
    order = np.argsort(node, kind="stable")
    degrees = np.bincount(node, minlength=lvl.num_nodes)
    ids, wts = ids[order], wts[order]
    n, e = lvl.num_nodes, ids.shape[0]
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(2 + 4 * degrees, out=starts[1:])
    values = np.empty(starts[-1])
    values[starts[:-1]] = lvl.volumes
    values[starts[:-1] + 1] = degrees
    owner = np.repeat(np.arange(n, dtype=np.int64), degrees)
    at = 2 * (owner + 1) + 4 * np.arange(e, dtype=np.int64)
    values[at] = ids
    for c in range(3):
        values[at + 1 + c] = wts[:, c]
    line = {d: "%.17e %d" + " %d %.17e %.17e %.17e" * d + "\n"
            for d in np.unique(degrees).tolist()}
    with open(path, "w") as f:
        f.write(f"{n} {lvl.num_edges}\n")
        _records(f, [line[d] for d in degrees.tolist()], values, starts)
    with open(path + ".coords", "w") as f:
        _records(f, ["%.17e %.17e %.17e\n"] * n,
                 np.asarray(lvl.coords, np.float64).ravel(),
                 np.arange(0, 3 * n + 1, 3))


def write_hierarchy(directory: str, mesh: Hierarchy) -> str:
    """level<i>.dat (+ .coords), mg<i>.dat and input.dat; returns
    input.dat's path."""
    os.makedirs(directory, exist_ok=True)
    levels = [f"level{i}.dat" for i in range(len(mesh.levels))]
    mgs = []
    for i, lvl in enumerate(mesh.levels):
        write_grid_dat(os.path.join(directory, levels[i]), lvl,
                       mesh.variant)
        if lvl.mg_mapping is not None and i < len(mesh.levels) - 1:
            mgs.append(f"mg{i}.dat")
            with open(os.path.join(directory, mgs[-1]), "w") as f:
                f.write(f"{lvl.mg_mapping.shape[0]}\n")
                f.write("\n".join(map(str, lvl.mg_mapping.tolist())))
                f.write("\n")
    path = os.path.join(directory, "input.dat")
    with open(path, "w") as f:
        f.write(f"size = {mesh.problem_size}\n")
        f.write(f"num_levels = {len(mesh.levels)}\n")
        f.write(f"mesh_name = {mesh.variant}\n")
        f.write("[levels]\n")
        for i, name in enumerate(levels):
            f.write(f"{i} = {name}\n")
        if mgs:
            f.write("[mg_mapping]\n")
            for i, name in enumerate(mgs):
                f.write(f"{i} = {name}\n")
    return path


def _numbers(path: str) -> np.ndarray:
    with open(path) as f:
        return np.fromstring(f.read(), sep=" ")


def read_grid_dat(path: str, variant: str) -> Level:
    """The reference's read rules: scanning nodes in order, an entry
    (j, w) of node i makes an edge only when j < i: j = -1 a far-field
    edge at i, j = -2 a wall edge at i, else the internal edge (a=j, b=i)
    with normal -w. FVCORR also flips the boundary and wall normals."""
    vals = _numbers(path)
    nel = int(vals[0])
    starts = np.empty(nel, np.int64)
    degrees = np.empty(nel, np.int64)
    pos = 2
    for i in range(nel):
        starts[i] = pos
        degrees[i] = int(vals[pos + 1])
        pos += 2 + 4 * degrees[i]
    if pos != vals.shape[0]:
        raise ValueError(f"{path}: {vals.shape[0] - pos} values past the "
                         f"last node's records")
    owner = np.repeat(np.arange(nel, dtype=np.int64), degrees)
    first = np.repeat(starts + 2, degrees)
    rank = np.arange(owner.shape[0]) - np.repeat(
        np.cumsum(degrees) - degrees, degrees)
    at = first + 4 * rank
    ids = vals[at].astype(np.int64)
    wts = np.stack([vals[at + 1], vals[at + 2], vals[at + 3]], axis=1)
    emit = ids < owner
    bnd = emit & (ids == BOUNDARY)
    wall = emit & (ids == WALL)
    internal = emit & ~bnd & ~wall
    coords = _numbers(path + ".coords").reshape(nel, 3) \
        if os.path.exists(path + ".coords") else None
    lvl = Level(volumes=vals[starts].copy(), coords=coords,
                edge_a=ids[internal].astype(np.int32),
                edge_b=owner[internal].astype(np.int32),
                edge_w=-wts[internal],
                bedge_b=owner[bnd].astype(np.int32),
                bedge_w=_flip(variant) * wts[bnd],
                wedge_b=owner[wall].astype(np.int32),
                wedge_w=_flip(variant) * wts[wall])
    lvl.validate()
    return lvl


def read_input_dat(path: str):
    """(problem_size, variant, level files, mg files)."""
    keys, sections = {}, {"[levels]": {}, "[mg_mapping]": {}}
    section = None
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("["):
                section = line
                continue
            if "=" not in line:
                continue
            key, value = (s.strip() for s in line.split("=", 1))
            if section in sections:
                sections[section][int(key)] = value
            else:
                keys[key] = value
    n = int(keys["num_levels"])
    levels = [sections["[levels]"][i] for i in range(n)]
    mgs = [sections["[mg_mapping]"][i] for i in range(n - 1)] \
        if sections["[mg_mapping]"] else []
    return int(keys["size"]), keys["mesh_name"], levels, mgs


_FIELDS = ("volumes", "coords", "edge_a", "edge_b", "edge_w", "bedge_b",
           "bedge_w", "wedge_b", "wedge_w", "mg_mapping")


def read_hierarchy(input_dat: str) -> Hierarchy:
    """Every level and map of input.dat's hierarchy, from the npz beside
    the files when a read has left one there."""
    base = os.path.dirname(os.path.abspath(input_dat))
    npz = os.path.join(base, _NPZ)
    size, variant, level_files, mg_files = read_input_dat(input_dat)
    if os.path.exists(npz):
        with np.load(npz, allow_pickle=False) as z:
            levels = []
            for i in range(len(level_files)):
                arrs = {k: z[f"{i}.{k}"] for k in _FIELDS}
                if not arrs["mg_mapping"].size:
                    arrs["mg_mapping"] = None
                levels.append(Level(**arrs))
        return Hierarchy(levels=levels, variant=variant, problem_size=size)
    levels = []
    for i, name in enumerate(level_files):
        lvl = read_grid_dat(os.path.join(base, name), variant)
        if i < len(mg_files):
            m = _numbers(os.path.join(base, mg_files[i])).astype(np.int64)
            lvl.mg_mapping = m[1:1 + int(m[0])]
        levels.append(lvl)
    tmp = npz + f".{os.getpid()}.tmp.npz"
    np.savez(tmp, **{f"{i}.{k}": (np.zeros(0) if getattr(lv, k) is None
                                  else getattr(lv, k))
                     for i, lv in enumerate(levels) for k in _FIELDS})
    os.replace(tmp, npz)
    return Hierarchy(levels=levels, variant=variant, problem_size=size)


def read_coords(input_dat: str) -> list:
    """Each level's node coordinates as read_hierarchy reads them, from
    its npz alone (not the rest of the levels) where a read has left one
    there."""
    npz = os.path.join(os.path.dirname(os.path.abspath(input_dat)), _NPZ)
    if not os.path.exists(npz):
        return [lv.coords for lv in read_hierarchy(input_dat).levels]
    num_levels = len(read_input_dat(input_dat)[2])
    with np.load(npz, allow_pickle=False) as z:
        return [z[f"{i}.coords"] for i in range(num_levels)]
