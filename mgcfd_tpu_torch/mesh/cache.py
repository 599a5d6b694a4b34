"""The npz sidecar cache of parsed mesh levels, in mgcfd_tpu.mesh.cache's
format: the same directory (.meshcache/ beside the .dat file), keys and
_FORMAT, so that each package loads a sidecar the other wrote. The
counterpart of the reference's binary mesh cache (io_enhanced.cpp:19-24,
:203-405; euler3d_cpu_double.cpp:176-230): keyed by the source files'
mtimes, and a stale or corrupt sidecar falls back to the parser, as
read_grid_from_bin returning false does."""
from __future__ import annotations

import os
import zipfile

import numpy as np

from ..core.constants import MeshVariant
from ..core.types import MeshLevel

CACHE_DIR_NAME = ".meshcache"
_FORMAT = 2


def _cache_path(path: str) -> str:
    d = os.path.join(os.path.dirname(os.path.abspath(path)), CACHE_DIR_NAME)
    return os.path.join(d, os.path.basename(path) + ".npz")


def _try_load(cpath: str, src_mtime: float, mg_mtime: float,
              variant: MeshVariant, need_coords: bool):
    """The cached level, or None when the sidecar is missing, stale,
    cached without the coords this load needs, or unreadable."""
    if not os.path.exists(cpath):
        return None
    try:
        with np.load(cpath, allow_pickle=False) as z:
            if int(z["format"]) != _FORMAT \
                    or float(z["src_mtime"]) != src_mtime \
                    or float(z["mg_mtime"]) != mg_mtime \
                    or str(z["variant"]) != variant.value:
                return None
            coords = z["coords"] if z["coords"].size else None
            if need_coords and coords is None:
                return None
            mg = z["mg_mapping"] if z["mg_mapping"].size else None
            return MeshLevel(
                volumes=z["volumes"], coords=coords,
                edge_a=z["edge_a"], edge_b=z["edge_b"], edge_w=z["edge_w"],
                bedge_b=z["bedge_b"], bedge_w=z["bedge_w"],
                wedge_b=z["wedge_b"], wedge_w=z["wedge_w"],
                mg_mapping=mg)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def load_mesh_cached(path: str, variant: MeshVariant,
                     need_coords: bool = True,
                     mg_path: str | None = None,
                     use_native: bool = True) -> MeshLevel:
    """One level (and its MG connectivity, when mg_path is given) through
    the cache; parse (natively unless use_native is False) and write the
    sidecar on a miss."""
    from .io_dat import read_grid_dat, read_mg_connectivity

    cpath = _cache_path(path)
    src_mtime = os.path.getmtime(path)
    mg_mtime = os.path.getmtime(mg_path) if mg_path else 0.0
    lvl = _try_load(cpath, src_mtime, mg_mtime, variant, need_coords)
    if lvl is not None:
        return lvl
    lvl = read_grid_dat(path, variant, need_coords=need_coords,
                        use_native=use_native)
    if mg_path:
        lvl.mg_mapping = read_mg_connectivity(mg_path, use_native)
    # the writer's own temporary file, renamed whole: the sharded
    # solver's ranks may parse and store the same level at once
    tmp = f"{cpath}.{os.getpid()}.tmp.npz"
    try:
        os.makedirs(os.path.dirname(cpath), exist_ok=True)
        np.savez(tmp,
                 format=_FORMAT,
                 src_mtime=src_mtime, mg_mtime=mg_mtime,
                 variant=variant.value,
                 volumes=lvl.volumes,
                 coords=lvl.coords if lvl.coords is not None
                 else np.zeros(0),
                 edge_a=lvl.edge_a, edge_b=lvl.edge_b, edge_w=lvl.edge_w,
                 bedge_b=lvl.bedge_b, bedge_w=lvl.bedge_w,
                 wedge_b=lvl.wedge_b, wedge_w=lvl.wedge_w,
                 mg_mapping=lvl.mg_mapping if lvl.mg_mapping is not None
                 else np.zeros(0, dtype=np.int64))
        os.replace(tmp, cpath)
    except OSError:
        pass
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lvl
