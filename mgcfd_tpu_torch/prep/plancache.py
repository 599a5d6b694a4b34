"""Content-keyed npz cache of the port's plans (plan_cache_dir, the CLI's
--plan-cache): the scheme of mgcfd_tpu's cached_plan
(mgcfd_tpu/prep/window.py:630-700).

A plan is stored as <cache_dir>/<kind>-<key>.npz, where the key hashes
the format version and every array the plan is built from, so a changed
mesh or weight builds a new file rather than reusing a stale one. The
write goes to a .tmp.npz file that is then renamed, so a reader never
sees half a file, and any failure to load one (a foreign, truncated or
stale file) falls back to building the plan again.

The port's plans are owner-sorted CSRs (prep/csr.py) and span plans
(prep/shift.py), not mgcfd_tpu's TPU window plans: each package keeps
its own files, under kinds of its own (every kind here starts with
"torch-"), and never reads the other's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

from .csr import CSRPlan
from .shift import ShiftPlan

# bump when a plan builder changes what it returns: the key includes it
PLAN_FORMAT_VERSION = 1
_TYPES = {"CSRPlan": CSRPlan, "ShiftPlan": ShiftPlan}

# loads and builds per kind since the process started (or reset_stats)
STATS = {"loaded": {}, "built": {}}


def reset_stats() -> None:
    STATS["loaded"].clear()
    STATS["built"].clear()


def _content_key(arrays) -> str:
    h = hashlib.sha1()
    h.update(str(PLAN_FORMAT_VERSION).encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:20]


def _pack(obj, pre: str = "") -> dict:
    """A plan (a CSRPlan or ShiftPlan dataclass, a tuple or list of them
    and arrays, ints) as flat npz entries, each node tagged by type."""
    if dataclasses.is_dataclass(obj):
        out = {pre + "type": np.asarray(type(obj).__name__)}
        for f in dataclasses.fields(obj):
            out.update(_pack(getattr(obj, f.name), f"{pre}{f.name}."))
        return out
    if isinstance(obj, (list, tuple)):
        out = {pre + "type": np.asarray(type(obj).__name__),
               pre + "len": np.asarray(len(obj))}
        for i, v in enumerate(obj):
            out.update(_pack(v, f"{pre}{i}."))
        return out
    if isinstance(obj, (int, np.integer)):
        return {pre + "type": np.asarray("int"),
                pre + "value": np.asarray(int(obj))}
    return {pre + "type": np.asarray("array"), pre + "value": np.asarray(obj)}


def _unpack(flat: dict, pre: str = ""):
    kind = str(flat[pre + "type"])
    if kind in _TYPES:
        cls = _TYPES[kind]
        return cls(**{f.name: _unpack(flat, f"{pre}{f.name}.")
                      for f in dataclasses.fields(cls)})
    if kind in ("list", "tuple"):
        items = [_unpack(flat, f"{pre}{i}.")
                 for i in range(int(flat[pre + "len"]))]
        return items if kind == "list" else tuple(items)
    if kind == "int":
        return int(flat[pre + "value"])
    if kind == "array":
        return flat[pre + "value"]
    raise ValueError(f"unknown plan entry type {kind!r}")


def cached_plan(cache_dir: str, kind: str, key_arrays, build):
    """build() when cache_dir is "", else the plan stored under `kind`
    and the key of `key_arrays`, built and stored on a miss or on any
    failure to load."""
    if not cache_dir:
        return build()
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{kind}-{_content_key(key_arrays)}.npz")
    if os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                obj = _unpack(dict(z.items()))
            STATS["loaded"][kind] = STATS["loaded"].get(kind, 0) + 1
            return obj
        except Exception:
            pass
    obj = build()
    STATS["built"][kind] = STATS["built"].get(kind, 0) + 1
    tmp = path + ".tmp.npz"       # .npz suffix: savez must not append one
    np.savez(tmp, **_pack(obj))
    os.replace(tmp, path)
    return obj
