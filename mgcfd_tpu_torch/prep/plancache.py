"""Content-keyed npz cache of the port's plans (plan_cache_dir, the CLI's
--plan-cache): the scheme of mgcfd_tpu's cached_plan
(mgcfd_tpu/prep/window.py:630-700).

A plan is stored as <cache_dir>/<kind>-<key>.npz, where the key hashes
the format version and every array the plan is built from, so a changed
mesh or weight builds a new file rather than reusing a stale one. The
write goes to a temporary file of the writing process that is then
renamed, so a reader never sees half a file and processes that build the
same plan at once (the sharded solver's ranks) each rename a whole copy
of their own; any failure to load one (a foreign, truncated or stale
file) falls back to building the plan again.

Each call is the span mgcfd.plan (utils/spans.py), with the children
mgcfd.plan.key (the content hash), then mgcfd.plan.load or
mgcfd.plan.build. It counts plans.loaded.<kind> or plans.built.<kind>
(a plan built without a cache directory too) and the bytes hashed for
keys, plans.key_bytes.

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

from ..utils import spans
from .csr import CSRPlan
from .shift import ShiftPlan

# bump when a plan builder changes what it returns: the key includes it
PLAN_FORMAT_VERSION = 1
_TYPES = {"CSRPlan": CSRPlan, "ShiftPlan": ShiftPlan}


def register_type(cls) -> None:
    """Let cached plans hold dataclasses of `cls` (the sharded solver's
    partitions, parallel/partition.py, which registers its own)."""
    _TYPES[cls.__name__] = cls


def _content_key(arrays) -> str:
    h = hashlib.sha1()
    h.update(str(PLAN_FORMAT_VERSION).encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
        spans.count("plans.key_bytes", a.nbytes)
    return h.hexdigest()[:20]


def _pack(obj, pre: str = "") -> dict:
    """A plan (a registered dataclass, a tuple or list of them and arrays,
    ints, None) as flat npz entries, each node tagged by type."""
    if obj is None:
        return {pre + "type": np.asarray("none")}
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
    if kind == "none":
        return None
    if kind == "array":
        return flat[pre + "value"]
    raise ValueError(f"unknown plan entry type {kind!r}")


@spans.span("mgcfd.plan")
def cached_plan(cache_dir: str, kind: str, key_arrays, build):
    """build() when cache_dir is "", else the plan stored under `kind`
    and the key of `key_arrays`, built and stored on a miss or on any
    failure to load."""
    path = ""
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        with spans.span("mgcfd.plan.key"):
            key = _content_key(key_arrays)
        path = os.path.join(cache_dir, f"{kind}-{key}.npz")
    if path and os.path.exists(path):
        try:
            with spans.span("mgcfd.plan.load"), \
                    np.load(path, allow_pickle=False) as z:
                obj = _unpack(dict(z.items()))
            spans.count(f"plans.loaded.{kind}")
            return obj
        except Exception:
            pass
    with spans.span("mgcfd.plan.build"):
        obj = build()
    spans.count(f"plans.built.{kind}")
    if not path:
        return obj
    # the writer's own temporary file; the .npz suffix keeps savez from
    # appending one
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **_pack(obj))
    os.replace(tmp, path)
    return obj
