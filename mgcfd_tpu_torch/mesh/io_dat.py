"""Reference-format mesh files, as mgcfd_tpu.mesh.io_dat reads and writes
them (warwick-hpsc/MG-CFD-app-plain):

  <mesh>.dat         (io.cpp:56-137) header "nel number_of_edges"; then per
                     node: volume, degree, then degree x (neighbour ex ey
                     ez). Neighbour -1 = far-field boundary face, -2 = wall.
  <mesh>.dat.coords  (io.cpp:49-81) "x y z" per node; needed when the run
                     has more than one level.
  <mg file>          (io_enhanced.cpp:629-650) count, then `count` ids:
                     fine node i -> coarse node id.
  input.dat          (io_enhanced.cpp:407-579) keys size / num_levels /
                     mesh_name; sections [levels] and [mg_mapping] with
                     idx = filename lines.

Floats are written with %.17e, so a round trip is exact. The readers
parse through the native parser (native/, C++ built at first use) unless
asked not to (use_native=False) or g++ is missing; the Python reader
parses a file's whole token stream at once and walks only the node
offsets in Python. It is the specification: the native parser gives the
same arrays bit for bit, and a file it refuses goes to the Python reader,
which raises MeshFormatError where mgcfd_tpu's reader does and warns as it
does when the header's edge count disagrees with the edges read
(io.cpp:145-147). The counters mesh.reads.native and mesh.reads.python
(utils/spans.py) count the levels each reader parsed.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.constants import MeshVariant
from ..core.types import MeshLevel, MultigridMesh
from ..utils import spans
from .build import (BOUNDARY_NEIGHBOUR, WALL_NEIGHBOUR,
                    build_edges_from_adjacency)

# nodes (or rows) formatted per string-% call when writing
_WRITE_CHUNK = 16384


class MeshFormatError(ValueError):
    """Malformed mesh, connectivity or coords file (the reference exits on
    an unreadable file, io.cpp:43-47)."""


def _warn_edge_mismatch(path: str, claimed: int, actual: int) -> None:
    """The reference's non-fatal header/degree disagreement (io.cpp:
    145-147): parsing goes on with the edges actually read."""
    if claimed != actual:
        print(f"WARNING: {path}: header claims {claimed} edges but "
              f"{actual} were read; continuing with {actual}")


# ---------------------------------------------------------------------------
# .dat grid files
# ---------------------------------------------------------------------------

def _adjacency_listing(lvl: MeshLevel, variant: MeshVariant):
    """The per-node listing whose read-back by the reference's rules gives
    `lvl` again, as (degrees (N,), neighbour ids (E,), weights (E, 3)) in
    node order. A node lists the internal edges it is the a end of
    (neighbour b, +w), then those it is the b end of (neighbour a, -w),
    then its boundary and wall faces (their normals flipped back for
    FVCORR) — mgcfd_tpu's _adjacency_listing order."""
    ne, nb, nw = (lvl.num_internal_edges, lvl.num_boundary_edges,
                  lvl.num_wall_edges)
    flip = -1.0 if variant.flips_all_normals else 1.0
    node = np.concatenate([lvl.edge_a, lvl.edge_b, lvl.bedge_b,
                           lvl.wedge_b]).astype(np.int64)
    ids = np.concatenate([lvl.edge_b, lvl.edge_a,
                          np.full(nb, BOUNDARY_NEIGHBOUR),
                          np.full(nw, WALL_NEIGHBOUR)]).astype(np.int64)
    wts = np.concatenate([lvl.edge_w, -lvl.edge_w, flip * lvl.bedge_w,
                          flip * lvl.wedge_w]).reshape(2 * ne + nb + nw, 3)
    order = np.argsort(node, kind="stable")
    return (np.bincount(node, minlength=lvl.num_nodes), ids[order],
            wts[order])


def _write_records(f, templates, values: np.ndarray, starts: np.ndarray):
    """Write record r, templates[r] % values[starts[r]:starts[r + 1]], for
    every record, a chunk of records per formatting call."""
    for r0 in range(0, len(templates), _WRITE_CHUNK):
        r1 = min(r0 + _WRITE_CHUNK, len(templates))
        f.write("".join(templates[r0:r1])
                % tuple(values[starts[r0]:starts[r1]].tolist()))


def write_grid_dat(path: str, lvl: MeshLevel, variant: MeshVariant,
                   write_coords: bool = True) -> None:
    """Write `lvl` as a .dat file (and .dat.coords) that reads back to the
    same arrays: the text of mgcfd_tpu's write_grid_dat, built from whole
    arrays rather than per node."""
    degrees, ids, wts = _adjacency_listing(lvl, variant)
    n, e = lvl.num_nodes, ids.shape[0]
    # one flat value stream: per node volume, degree, then per entry
    # neighbour id and the three weights; "%d" prints the integral ones
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
    templates = [line[d] for d in degrees.tolist()]
    with open(path, "w") as f:
        f.write(f"{n} {lvl.num_edges}\n")
        _write_records(f, templates, values, starts)
    if write_coords and lvl.coords is not None:
        with open(path + ".coords", "w") as f:
            _write_records(f, ["%.17e %.17e %.17e\n"] * n,
                           np.asarray(lvl.coords, np.float64).ravel(),
                           np.arange(0, 3 * n + 1, 3))


def _floats(tokens: list[str]) -> tuple[np.ndarray, int]:
    """The tokens as float64, up to the first that is not a number.
    Returns (values, count of leading numeric tokens)."""
    try:
        return np.array(tokens, dtype=np.float64), len(tokens)
    except ValueError:
        pass
    good = 0
    for good, tok in enumerate(tokens):
        try:
            float(tok)
        except ValueError:
            break
    return np.array(tokens[:good], dtype=np.float64), good


def read_grid_dat(path: str, variant: MeshVariant,
                  need_coords: bool = True,
                  use_native: bool = True) -> MeshLevel:
    """Parse a .dat mesh with the reference's read_grid semantics
    (io.cpp:56-137): whitespace-separated tokens; an edge is emitted when
    the listed neighbour id is below the current node id (mesh.build).
    Through the native parser unless use_native is False or it is
    unavailable (module docstring)."""
    if use_native:
        from ..native.loader import NativeParseError, parse_dat_native
        try:
            lvl = parse_dat_native(path, variant.flips_all_normals,
                                   need_coords)
        except NativeParseError:
            lvl = None          # the Python reader says what is wrong
        if lvl is not None:
            spans.count("mesh.reads.native")
            return lvl
    spans.count("mesh.reads.python")
    with open(path) as f:
        toks = f.read().split()
    if len(toks) < 2:
        raise MeshFormatError(f"{path}: missing 'nel num_edges' header")
    try:
        nel = int(toks[0])
        num_edges_claimed = int(toks[1])
    except ValueError:
        raise MeshFormatError(
            f"{path}: malformed header {toks[0]!r} {toks[1]!r}") from None
    if nel <= 0:
        raise MeshFormatError(f"{path}: non-positive node count {nel}")
    body = toks[2:]
    vals, numeric = _floats(body)

    # walk the node offsets; everything else is sliced out of `vals`
    degrees = np.empty(nel, np.int64)
    starts = np.empty(nel, np.int64)
    pos = 0
    for i in range(nel):
        if pos + 2 > len(body):
            raise MeshFormatError(
                f"{path}: truncated at node {i} of {nel} "
                f"(volume/degree missing)")
        try:
            if pos >= numeric:
                raise ValueError
            deg = int(body[pos + 1])
        except ValueError:
            raise MeshFormatError(
                f"{path}: bad volume/degree at node {i}: "
                f"{body[pos]!r} {body[pos + 1]!r}") from None
        if deg < 0:
            raise MeshFormatError(
                f"{path}: negative degree {deg} at node {i}")
        starts[i] = pos
        degrees[i] = deg
        pos += 2 + 4 * deg
        if pos > len(body):
            raise MeshFormatError(
                f"{path}: truncated neighbour records at node {i} "
                f"(need {deg}, file ends early)")
        if pos > numeric:
            raise MeshFormatError(
                f"{path}: non-numeric neighbour record at node {i}")
    entry = np.ones(pos, bool)
    entry[starts] = False
    entry[starts + 1] = False
    records = vals[:pos][entry].reshape(-1, 4)

    coords = None
    coords_path = path + ".coords"
    if need_coords and os.path.exists(coords_path):
        try:
            coords = np.loadtxt(coords_path,
                                dtype=np.float64).reshape(nel, 3)
        except ValueError:
            raise MeshFormatError(
                f"{coords_path}: expected {nel} 'x y z' rows") from None

    lvl = build_edges_from_adjacency(vals[starts], coords, degrees,
                                     records[:, 0].astype(np.int64),
                                     records[:, 1:4], variant)
    _warn_edge_mismatch(path, num_edges_claimed, lvl.num_edges)
    return lvl


# ---------------------------------------------------------------------------
# multigrid connectivity
# ---------------------------------------------------------------------------

def write_mg_connectivity(path: str, mapping: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(f"{mapping.shape[0]}\n")
        f.write("\n".join(map(str, np.asarray(mapping).tolist())))
        f.write("\n")


def read_mg_connectivity(path: str, use_native: bool = True) -> np.ndarray:
    """Fine node -> coarse node ids, int64; through the native parser
    unless use_native is False or it is unavailable."""
    if use_native:
        from ..native.loader import NativeParseError, parse_mg_native
        try:
            ids = parse_mg_native(path)
        except NativeParseError:
            ids = None          # the Python reader says what is wrong
        if ids is not None:
            return ids
    with open(path) as f:
        toks = f.read().split()
    if not toks:
        raise MeshFormatError(f"{path}: empty mg connectivity file")
    try:
        count = int(toks[0])
    except ValueError:
        raise MeshFormatError(
            f"{path}: malformed count {toks[0]!r}") from None
    if count < 0:
        raise MeshFormatError(f"{path}: negative count {count}")
    if len(toks) - 1 < count:
        raise MeshFormatError(
            f"{path}: truncated (header claims {count} ids, "
            f"{len(toks) - 1} present)")
    try:
        return np.array(toks[1:1 + count], dtype=np.int64)
    except ValueError:
        raise MeshFormatError(f"{path}: non-integer mg id") from None


# ---------------------------------------------------------------------------
# input.dat descriptor
# ---------------------------------------------------------------------------

def write_input_dat(path: str, mesh: MultigridMesh,
                    level_files: list[str], mg_files: list[str]) -> None:
    with open(path, "w") as f:
        f.write(f"size = {mesh.problem_size}\n")
        f.write(f"num_levels = {mesh.num_levels}\n")
        f.write(f"mesh_name = {mesh.variant.value}\n")
        f.write("[levels]\n")
        for i, name in enumerate(level_files):
            f.write(f"{i} = {name}\n")
        if mg_files:
            f.write("[mg_mapping]\n")
            for i, name in enumerate(mg_files):
                f.write(f"{i} = {name}\n")


def read_input_dat(path: str):
    """Returns (problem_size, num_levels, variant, level_files, mg_files)."""
    problem_size = None
    num_levels = None
    variant = None
    level_files: dict[int, str] = {}
    mg_files: dict[int, str] = {}
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
            if section == "[levels]":
                level_files[int(key)] = value
            elif section == "[mg_mapping]":
                mg_files[int(key)] = value
            elif key == "size":
                problem_size = int(value)
            elif key == "num_levels":
                num_levels = int(value)
            elif key == "mesh_name":
                variant = MeshVariant(value)
    if problem_size is None or num_levels is None or variant is None:
        raise ValueError(f"{path}: missing size/num_levels/mesh_name")
    levels = [level_files[i] for i in range(num_levels)]
    mgs = [mg_files[i] for i in range(num_levels - 1)] if mg_files else []
    return problem_size, num_levels, variant, levels, mgs


def write_multigrid_mesh(directory: str, mesh: MultigridMesh,
                         stem: str = "level") -> str:
    """Write every level (<stem><i>.dat and .coords), the mg files
    (mg<i>.dat) and input.dat into `directory`; returns input.dat's
    path."""
    os.makedirs(directory, exist_ok=True)
    level_files = [f"{stem}{i}.dat" for i in range(mesh.num_levels)]
    mg_files = []
    for i, lvl in enumerate(mesh.levels):
        write_grid_dat(os.path.join(directory, level_files[i]), lvl,
                       mesh.variant)
        if lvl.mg_mapping is not None and i < mesh.num_levels - 1:
            mg_files.append(f"mg{i}.dat")
            write_mg_connectivity(os.path.join(directory, mg_files[-1]),
                                  lvl.mg_mapping)
    path = os.path.join(directory, "input.dat")
    write_input_dat(path, mesh, level_files, mg_files)
    return path


@spans.span("mgcfd.load")
def load_multigrid_mesh(input_dat_path: str, directory: str = "",
                        use_cache: bool = True,
                        use_native: bool = True) -> MultigridMesh:
    """Load a whole hierarchy as the reference's main program does
    (euler3d_cpu_double.cpp:104-254), each level and its MG connectivity
    through the npz sidecar cache of mesh.cache (the counterpart of the
    reference's binary cache, euler3d:176-230) unless use_cache is
    False, and parsed by the native parser unless use_native is
    False. The load is the span mgcfd.load (utils/spans.py)."""
    from ..utils.logging import log
    base = directory or os.path.dirname(input_dat_path)
    size, num_levels, variant, level_files, mg_files = read_input_dat(
        input_dat_path)
    log("read_input_dat: %d levels, variant=%s", num_levels,
        variant.value)
    levels = []
    for i, name in enumerate(level_files):
        mg_path = (os.path.join(base, mg_files[i])
                   if i < num_levels - 1 and mg_files else None)
        if use_cache:
            from .cache import load_mesh_cached
            lvl = load_mesh_cached(os.path.join(base, name), variant,
                                   need_coords=num_levels > 1,
                                   mg_path=mg_path, use_native=use_native)
        else:
            lvl = read_grid_dat(os.path.join(base, name), variant,
                                need_coords=num_levels > 1,
                                use_native=use_native)
            if mg_path:
                lvl.mg_mapping = read_mg_connectivity(mg_path, use_native)
        log("level %d: %d nodes, %d/%d/%d internal/boundary/wall edges",
            i, lvl.num_nodes, lvl.num_internal_edges,
            lvl.num_boundary_edges, lvl.num_wall_edges)
        levels.append(lvl)
    return MultigridMesh(levels=levels, variant=variant, problem_size=size,
                         name=os.path.basename(input_dat_path))
