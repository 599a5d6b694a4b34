"""Checkpoint / resume of solver state (mgcfd_tpu/utils/checkpoint.py).

An .npz snapshot of the full per-level state (variables and residuals,
node-major (N, 5) in the caller's node order), the cycle counter, the RMS
history and a mesh fingerprint that refuses to resume onto a different
problem. The fingerprint, the npz keys and the ckpt-%06d.npz names are
mgcfd_tpu's, so that each package resumes from the other's checkpoints.
"""
from __future__ import annotations

import glob
import hashlib
import os

import numpy as np
import torch


def _fingerprint(mesh) -> str:
    h = hashlib.sha256()
    h.update(mesh.variant.value.encode())
    for lvl in mesh.levels:
        h.update(np.int64([lvl.num_nodes, lvl.num_internal_edges,
                           lvl.num_boundary_edges,
                           lvl.num_wall_edges]).tobytes())
        h.update(np.ascontiguousarray(lvl.volumes[:64]).tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(directory: str, mesh, state: dict, cycle: int,
                    rms_history=None) -> str:
    """Write ckpt-<cycle>.npz under `directory` (through a .tmp.npz file
    and a rename); state holds node-major numpy arrays per level."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt-{cycle:06d}.npz")
    payload = {
        "cycle": np.int64(cycle),
        "fingerprint": np.bytes_(_fingerprint(mesh).encode()),
        "num_levels": np.int64(len(state["variables"])),
        "rms_history": np.asarray(rms_history if rms_history is not None
                                  else [], dtype=np.float64),
    }
    for i, (v, r) in enumerate(zip(state["variables"],
                                   state["residuals"])):
        payload[f"variables_{i}"] = np.asarray(v)
        payload[f"residuals_{i}"] = np.asarray(r)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> str | None:
    paths = sorted(glob.glob(os.path.join(directory, "ckpt-*.npz")))
    return paths[-1] if paths else None


def load_checkpoint(path: str, mesh, dtype, device=None):
    """-> (state, cycle, rms_history): the state's node-major tensors on
    `device` at `dtype` (a bfloat16 state of either package included).
    Raises ValueError on a mesh mismatch."""
    z = np.load(path, allow_pickle=False)
    fp = bytes(z["fingerprint"]).decode()
    want = _fingerprint(mesh)
    if fp != want:
        raise ValueError(
            f"checkpoint {path} was written for a different problem "
            f"(fingerprint {fp} != {want})")
    L = int(z["num_levels"])

    def put(a):
        a = np.asarray(a)
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            # mgcfd_tpu's bfloat16 state (an ml_dtypes array) is stored as
            # raw 2-byte records: their bits are torch's bfloat16
            t = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.as_tensor(a)
        return t.to(device=device, dtype=dtype)

    state = {
        "variables": [put(z[f"variables_{i}"]) for i in range(L)],
        "residuals": [put(z[f"residuals_{i}"]) for i in range(L)],
    }
    return state, int(z["cycle"]), [float(x) for x in z["rms_history"]]
