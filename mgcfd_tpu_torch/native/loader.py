"""The native mesh parser (mesh_parser.cpp): its build and its ctypes
bindings, the counterpart of mgcfd_tpu/native/loader.py.

The library is compiled at first use with `g++ -O3 -shared -fPIC` into
build/mgcfd_tpu_torch/ at the repository root (beside the CUDA kernels'
library), and again whenever the source is newer than the library. The
build writes a temporary file and renames it into place, so processes
that build at once never load half a library. Without g++ the readers
(mesh/io_dat.py) parse in Python, and this module says so once on
stderr. The Python reader is the behavioural specification: the library
returns the same arrays bit for bit, and where it refuses a file the
Python reader parses it again, so that the exception and its text are the
Python reader's.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "mesh_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mgcfd_tpu_torch"
LIBRARY = BUILD_DIR / "libmgcfd_torch_native.so"
GXX_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None
_unavailable = ""     # why the library could not be built, once known


class _ParsedMesh(ctypes.Structure):
    _fields_ = [
        ("num_nodes", ctypes.c_int64),
        ("num_internal", ctypes.c_int64),
        ("num_boundary", ctypes.c_int64),
        ("num_wall", ctypes.c_int64),
        ("volumes", ctypes.POINTER(ctypes.c_double)),
        ("edge_a", ctypes.POINTER(ctypes.c_int32)),
        ("edge_b", ctypes.POINTER(ctypes.c_int32)),
        ("edge_w", ctypes.POINTER(ctypes.c_double)),
        ("bedge_b", ctypes.POINTER(ctypes.c_int32)),
        ("bedge_w", ctypes.POINTER(ctypes.c_double)),
        ("wedge_b", ctypes.POINTER(ctypes.c_int32)),
        ("wedge_w", ctypes.POINTER(ctypes.c_double)),
        ("claimed_edges", ctypes.c_int64),
    ]


def _build() -> None:
    """Compile the source unless the library is newer than it."""
    if LIBRARY.exists() and \
            LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(SOURCE),
                        "-o", str(tmp)], check=True, capture_output=True,
                       timeout=GXX_TIMEOUT_S)
        os.replace(tmp, LIBRARY)
    finally:
        tmp.unlink(missing_ok=True)


def library():
    """The loaded parser library, built at first use; None when it cannot
    be built here (the reason is printed once)."""
    global _lib, _unavailable
    with _lock:
        if _lib is not None or _unavailable:
            return _lib
        try:
            _build()
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            _unavailable = f"{type(e).__name__}: {e} {detail.decode()[:400]}"
            print("mgcfd_tpu_torch.native: the mesh parser did not build "
                  f"({_unavailable.strip()}); reading meshes in Python",
                  file=sys.stderr)
            return None
        lib = ctypes.CDLL(str(LIBRARY))
        lib.mgcfd_last_error.restype = ctypes.c_char_p
        lib.mgcfd_last_error.argtypes = []
        lib.mgcfd_parse_dat.restype = ctypes.POINTER(_ParsedMesh)
        lib.mgcfd_parse_dat.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.mgcfd_parse_coords.restype = ctypes.c_int
        lib.mgcfd_parse_coords.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.mgcfd_parse_mg.restype = ctypes.c_int64
        lib.mgcfd_parse_mg.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.mgcfd_free_mesh.restype = None
        lib.mgcfd_free_mesh.argtypes = [ctypes.POINTER(_ParsedMesh)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return library() is not None


class NativeParseError(ValueError):
    """The library refused a file; the caller parses it in Python, whose
    exception is the one raised."""


def _copy(ptr, count: int, dtype) -> np.ndarray:
    if count == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype,
                                                            copy=True)


def parse_dat_native(path: str, flip_all: bool, need_coords: bool):
    """The level in `path` (and its .coords sidecar when need_coords and it
    exists) -> MeshLevel, validated; None when the library is unavailable.
    Raises NativeParseError where the library refuses the files."""
    lib = library()
    if lib is None:
        return None
    from ..core.types import MeshLevel
    from ..mesh.io_dat import _warn_edge_mismatch

    pm = lib.mgcfd_parse_dat(os.fsencode(path), 1 if flip_all else 0)
    if not pm:
        raise NativeParseError(lib.mgcfd_last_error().decode())
    try:
        m = pm.contents
        ei, eb, ew = m.num_internal, m.num_boundary, m.num_wall
        claimed = m.claimed_edges
        lvl = MeshLevel(
            volumes=_copy(m.volumes, m.num_nodes, np.float64), coords=None,
            edge_a=_copy(m.edge_a, ei, np.int32),
            edge_b=_copy(m.edge_b, ei, np.int32),
            edge_w=_copy(m.edge_w, 3 * ei, np.float64).reshape(ei, 3),
            bedge_b=_copy(m.bedge_b, eb, np.int32),
            bedge_w=_copy(m.bedge_w, 3 * eb, np.float64).reshape(eb, 3),
            wedge_b=_copy(m.wedge_b, ew, np.int32),
            wedge_w=_copy(m.wedge_w, 3 * ew, np.float64).reshape(ew, 3))
    finally:
        lib.mgcfd_free_mesh(pm)
    coords_path = path + ".coords"
    if need_coords and os.path.exists(coords_path):
        coords = np.empty((lvl.num_nodes, 3), np.float64)
        if lib.mgcfd_parse_coords(
                os.fsencode(coords_path),
                coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                lvl.num_nodes) != 0:
            raise NativeParseError(f"{coords_path}: malformed coords")
        lvl.coords = coords
    try:
        lvl.validate()
    except ValueError as e:
        raise NativeParseError(str(e)) from None
    _warn_edge_mismatch(path, claimed, lvl.num_edges)
    return lvl


def parse_mg_native(path: str):
    """The mg connectivity in `path` as int64; None when the library is
    unavailable. Raises NativeParseError where the library refuses the
    file."""
    lib = library()
    if lib is None:
        return None
    count = lib.mgcfd_parse_mg(os.fsencode(path), None, 0)
    if count < 0:
        raise NativeParseError(f"{path}: malformed mg connectivity")
    out = np.empty(count, np.int64)
    got = lib.mgcfd_parse_mg(
        os.fsencode(path),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), count)
    if got != count:
        raise NativeParseError(f"{path}: malformed mg connectivity")
    return out
