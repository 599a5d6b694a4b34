"""The fused stages' boundary/wall operand, compacted.

The dense operand nc (11, N) holds each node's aggregated boundary
normals (rows 0:3), wall normals (3:6) and far-field wall constant
(6:11), and is zero on every node without a boundary or wall face: on the
M6 hierarchies about 90 % of the nodes. BoundaryRows keeps only the rows
that are not all zero, in node order, with a bit a node saying which:

  mask  (ceil(N / 32),) int32: bit i % 32 of word i // 32 is set where
        node i's row is stored, that is unless its 11 values are all +0.0
        bit for bit (a -0.0 is stored);
  rank  (ceil(N / 32),) int32: the stored rows before each word;
  vals  (11, stored) in the storage dtype: the stored rows.

Node i's row is vals[:, rank[i // 32] + popcount(mask[i // 32] & below
i)] where its bit is set, else zeros. The kernels (csrc/csr_common.cuh
boundary_row) read it so and take the zeros from registers; dense()
expands it back, bit for bit, for the plain versions.
"""
from __future__ import annotations

import dataclasses

import torch

NC_ROWS = 11
WORD = 32
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclasses.dataclass
class BoundaryRows:
    num_nodes: int
    mask: torch.Tensor   # (ceil(N / 32),) int32, one bit a node
    rank: torch.Tensor   # (ceil(N / 32),) int32, stored rows before a word
    vals: torch.Tensor   # (11, stored) storage dtype

    @property
    def stored(self) -> int:
        return int(self.vals.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "BoundaryRows":
        return dataclasses.replace(self, mask=self.mask.to(device),
                                   rank=self.rank.to(device),
                                   vals=self.vals.to(device))

    def dense(self) -> torch.Tensor:
        """The (11, N) operand it was built from, bit for bit."""
        n, dev = self.num_nodes, self.vals.device
        out = torch.zeros((NC_ROWS, n), dtype=self.vals.dtype, device=dev)
        if n == 0 or self.stored == 0:
            return out
        words = self.mask.to(torch.int64) & 0xFFFFFFFF
        shift = torch.arange(WORD, device=dev)
        bits = ((words[:, None] >> shift) & 1)            # (words, 32)
        below = torch.cumsum(bits, dim=1) - bits
        at = (self.rank.to(torch.int64)[:, None] + below).reshape(-1)[:n]
        stored = bits.reshape(-1)[:n].bool()
        return torch.where(stored[None],
                           self.vals[:, at.clamp(max=self.stored - 1)], out)


def stored_rows(nc: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the nodes whose 11 values are not all +0.0 bit for
    bit."""
    return (nc.view(_BITS[nc.element_size()]) != 0).any(dim=0)


def boundary_rows(nc: torch.Tensor) -> BoundaryRows:
    """The compact operand of a dense (11, N) nc, on nc's device and in
    its dtype."""
    if nc.dim() != 2 or nc.shape[0] != NC_ROWS:
        raise ValueError(f"boundary_rows: nc must be (11, N), got "
                         f"{tuple(nc.shape)}")
    n, dev = int(nc.shape[1]), nc.device
    stored = stored_rows(nc)
    pad = -n % WORD
    bits = torch.cat([stored, stored.new_zeros(pad)]).reshape(-1, WORD)
    words = (bits.to(torch.int64)
             << torch.arange(WORD, device=dev)).sum(dim=1)
    # the unsigned words as int32, bit for bit
    mask = (words - (words >> 31) * (1 << 32)).to(torch.int32)
    per_word = bits.sum(dim=1)
    rank = (torch.cumsum(per_word, dim=0) - per_word).to(torch.int32)
    return BoundaryRows(num_nodes=n, mask=mask, rank=rank,
                        vals=nc[:, stored].contiguous())


def as_dense(nc) -> torch.Tensor:
    """A fused stage's boundary operand as the dense (11, N) nc: a
    BoundaryRows expanded, a tensor as it is."""
    return nc.dense() if isinstance(nc, BoundaryRows) else nc


def check_rows(bnd, q, n: int, name: str) -> None:
    """Raise unless bnd is the compact operand of n nodes beside q: its
    vals (11, stored) in q's dtype, its mask and rank int32 of a word per
    32 nodes, each contiguous on q's device."""
    if not isinstance(bnd, BoundaryRows) or bnd.num_nodes != n:
        raise ValueError(f"{name}: the boundary operand must be the "
                         f"BoundaryRows of {n} nodes (kernels/boundary.py)")
    words = -(-n // WORD)
    for what, t, shape, dtype in (
            ("vals", bnd.vals, (NC_ROWS, bnd.stored), q.dtype),
            ("mask", bnd.mask, (words,), torch.int32),
            ("rank", bnd.rank, (words,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: boundary {what} must be a contiguous "
                             f"{shape} {dtype} tensor on {q.device}")
