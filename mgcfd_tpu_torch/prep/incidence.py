"""ELL incidence tables: scatter-free flux accumulation (accumulate='ell';
mgcfd_tpu/prep/incidence.py, whose module pulls in jax through its
package, so the port keeps its own copy).

Per-edge values are computed edge-major, then each NODE gathers the
values of its incident half-edges: a fixed-width (ELL) gather and a
masked sum, no write conflicts by construction (FLUX_FISSION's
update_edges, cfd_loops.cpp:159-213, re-expressed as a gather).

Half-edge stream layout (concatenated, in this order):
    [0, Ei)            internal a-side   (+val)
    [Ei, 2*Ei)         internal b-side   (-val)
    [2*Ei, 2*Ei+Eb)    boundary b-side   (+val)
    [..., +Ew)         wall b-side       (+val)
    [H, H+1)           one zero pad slot (gathered by padding lanes)

Tables (N, D): `slots` indexes into that stream (H = pad slot for unused
lanes), `signs` is +1/-1/0; the b-side's sign is already in its stream
values, so the sum masks padding only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import MeshLevel


@dataclasses.dataclass
class IncidenceTables:
    slots: np.ndarray      # (N, D) int32 into the half-edge value stream
    signs: np.ndarray      # (N, D) int8: +1 / -1 / 0 (padding)
    width: int             # D = max node degree (over all edge classes)
    stream_len: int        # H (without the pad slot)

    @property
    def num_nodes(self):
        return self.slots.shape[0]


def build_incidence(lvl: MeshLevel) -> IncidenceTables:
    """mgcfd_tpu's build_incidence, array for array."""
    n = lvl.num_nodes
    ei = lvl.num_internal_edges
    eb = lvl.num_boundary_edges
    ew = lvl.num_wall_edges
    H = 2 * ei + eb + ew

    # destination node and sign per half-edge
    dest = np.concatenate([lvl.edge_a, lvl.edge_b, lvl.bedge_b,
                           lvl.wedge_b]).astype(np.int64)
    sign = np.concatenate([
        np.ones(ei, np.int8), -np.ones(ei, np.int8),
        np.ones(eb, np.int8), np.ones(ew, np.int8)])

    order = np.argsort(dest, kind="stable")
    dest_sorted = dest[order]
    counts = np.bincount(dest_sorted, minlength=n)
    width = max(1, int(counts.max()))

    slots = np.full((n, width), H, dtype=np.int32)  # H = zero pad slot
    signs = np.zeros((n, width), dtype=np.int8)
    # lane position of each sorted half-edge within its node's row
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    lane = np.arange(dest.shape[0], dtype=np.int64) - starts[dest_sorted]
    slots[dest_sorted, lane] = order.astype(np.int32)
    signs[dest_sorted, lane] = sign[order]
    return IncidenceTables(slots=slots, signs=signs, width=width,
                           stream_len=H)


@dataclasses.dataclass
class DeviceIncidence:
    """The tables on the device: the flat slots (N * D,) int64 and the
    padding mask |signs| (N, D) at the state's dtype."""
    slots: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def from_tables(t: IncidenceTables, device, dtype) -> "DeviceIncidence":
        return DeviceIncidence(
            slots=torch.as_tensor(t.slots.reshape(-1).astype(np.int64)
                                  ).to(device),
            mask=torch.as_tensor(np.abs(t.signs).astype(np.float64)).to(
                device=device, dtype=dtype))


def ell_accumulate(tables: DeviceIncidence, val_internal, val_boundary,
                   val_wall, val_internal_b=None):
    """fluxes[n] = sum_d |signs[n, d]| * stream[slots[n, d]]: a flat 1D
    gather of the half-edge stream, then the masked sum over D, as
    mgcfd_tpu's ell_accumulate. val_internal_b defaults to -val_internal
    (antisymmetry)."""
    if val_internal_b is None:
        val_internal_b = -val_internal
    stream = torch.cat([
        val_internal, val_internal_b, val_boundary, val_wall,
        torch.zeros((1, val_internal.shape[-1]), dtype=val_internal.dtype,
                    device=val_internal.device)], dim=0)
    n, d = tables.mask.shape
    gathered = stream[tables.slots].reshape(n, d, -1)     # (N, D, NVAR)
    return (tables.mask[:, :, None] * gathered).sum(dim=1)
