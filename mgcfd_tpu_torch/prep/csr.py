"""Owner-sorted CSR plans for the kernel path (accumulate='window').

They carry what mgcfd_tpu.prep.window's plans MEAN — lists of half-edges
(owner, neighbour, weights) whose values accumulate into the owner — not
the TPU's (8, 128) packing. Every half-edge is in the CSR, so there is no
spill list. Row i owns entries row_ptr[i]:row_ptr[i+1]; within a row the
entries keep their order in the half-edge list.

  flux      (build_window_plan, window.py:396): each internal edge
            (a, b, w) gives (a, b, +w) and (b, a, -w); weights are the
            rows w0, w1, w2 and the precomputed |w|. build_edge_csr
            makes the same plan of any edge list: the shift path's
            spill edges.
  restrict  (build_restrict_window, window.py:706): coarse owner, fine
            child, weight 1/count, plus the `mapped` mask.
  prolong   (composed_prolong_halves, window.py:449-512): the composed
            operator wavg = P @ rc over (fine owner, coarse neighbour)
            pairs, duplicate pairs collapsed by summing their weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import MeshLevel


@dataclasses.dataclass
class CSRPlan:
    num_rows: int            # owner space
    num_cols: int            # neighbour space
    row_ptr: np.ndarray      # (num_rows + 1,) int64
    owner: np.ndarray        # (H,) int64, the row of each entry (sorted)
    col: np.ndarray          # (H,) int64, neighbour ids
    w: np.ndarray            # (K, H) float64 per-entry weights

    @property
    def num_entries(self) -> int:
        return int(self.col.shape[0])


def _csr(num_rows: int, num_cols: int, owner, nbr, w) -> CSRPlan:
    owner = np.asarray(owner, np.int64)
    order = np.argsort(owner, kind="stable")
    row_ptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(owner, minlength=num_rows), out=row_ptr[1:])
    return CSRPlan(num_rows=num_rows, num_cols=num_cols, row_ptr=row_ptr,
                   owner=owner[order],
                   col=np.asarray(nbr, np.int64)[order],
                   w=np.ascontiguousarray(np.asarray(w)[:, order]))


def build_edge_csr(num_nodes: int, a, b, w) -> CSRPlan:
    """Both halves of each edge (a, b, w) — (a, b, +w) and (b, a, -w) —
    with weights (w0, w1, w2, |w|), |w| in fp64 on the host."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    w = np.asarray(w, np.float64).reshape(-1, 3)
    ewt = np.sqrt((w ** 2).sum(axis=1))
    wt = np.concatenate([w.T, -w.T], axis=1)
    wt = np.concatenate([wt, np.concatenate([ewt, ewt])[None]], axis=0)
    return _csr(num_nodes, num_nodes, np.concatenate([a, b]),
                np.concatenate([b, a]), wt)


def build_flux_csr(lvl: MeshLevel) -> CSRPlan:
    """Both halves of every internal edge of a level."""
    return build_edge_csr(lvl.num_nodes, lvl.edge_a, lvl.edge_b, lvl.edge_w)


def build_restrict_csr(mapping: np.ndarray, num_fine: int,
                       num_coarse: int):
    """Restriction as a weighted sum: coarse owners gather their fine
    children (ids < len(mapping)) at weight 1/count — the segment mean.
    Returns (plan, mapped); unmapped coarse nodes keep their old value."""
    mapping = np.asarray(mapping, np.int64)
    counts = np.bincount(mapping, minlength=num_coarse)
    w = (1.0 / np.maximum(counts, 1))[mapping]
    plan = _csr(num_coarse, num_fine, mapping,
                np.arange(mapping.shape[0], dtype=np.int64), w[None])
    return plan, counts > 0


def build_prolong_csr(fine: MeshLevel, coarse: MeshLevel) -> CSRPlan:
    """The composed prolongation wavg[i] = sum_j P_ij rc[j] (coarse
    residuals rc), so that vars_fine += res_fine - wavg. With G[n] =
    rc[mapping[n]], the reference operator (mg_loops.cpp:678-864) is

      wavg = coincident ? G : (dense_local * G + sum_e B1_e G[b2]) / wsum

    and substituting G gives per fine node i one weight on its parent
    (1.0 if coincident, else dense_local_i / wsum_i) plus B1_e / wsum_i
    on the parent of each edge neighbour b2 (the a1 -> b2 quirk reads
    rc[b1] = G[b2], so the b-side terms are all node-local)."""
    n = fine.num_nodes
    mapping = fine.mg_mapping
    if mapping is None or mapping.shape[0] != n or fine.coords is None \
            or coarse.coords is None:
        raise ValueError("the prolongation needs coords on both levels "
                         "and a mapping of every fine node")
    coincident = np.all(fine.coords == coarse.coords[mapping], axis=1)
    a2 = fine.edge_a.astype(np.int64)
    b2 = fine.edge_b.astype(np.int64)
    a1 = mapping[a2]
    b1 = mapping[b2]

    def idist(p, q):
        d = p - q
        with np.errstate(divide="ignore"):
            out = 1.0 / np.sqrt((d * d).sum(axis=1))
        return np.nan_to_num(out, posinf=0.0, neginf=0.0)

    la = (~coincident[a2]).astype(np.float64)
    lb = (~coincident[b2]).astype(np.float64)
    A1 = la * idist(fine.coords[a2], coarse.coords[a1])
    B1 = la * idist(coarse.coords[b1], fine.coords[a2])
    BS = lb * (idist(fine.coords[b2], coarse.coords[b1])
               + idist(coarse.coords[a1], fine.coords[b2]))
    dense_local = np.zeros(n)
    np.add.at(dense_local, a2, A1)
    np.add.at(dense_local, b2, BS)
    wsum = dense_local.copy()
    np.add.at(wsum, a2, B1)

    inv = 1.0 / np.where(wsum > 0, wsum, 1.0)
    dense_w = np.where(coincident, 1.0, dense_local * inv)
    live = B1 != 0.0             # B1 == 0 where a2 is coincident
    owner = np.concatenate([np.arange(n, dtype=np.int64), a2[live]])
    nbr = np.concatenate([mapping.astype(np.int64), b1[live]])
    w = np.concatenate([dense_w, B1[live] * inv[a2[live]]])
    # collapse duplicate (fine, parent) pairs: under 8:1 coarsening many
    # of a node's neighbours share a parent
    nc = coarse.num_nodes
    uniq, idx = np.unique(owner * np.int64(nc) + nbr, return_inverse=True)
    w = np.bincount(idx, weights=w)
    return _csr(n, nc, uniq // nc, uniq % nc, w[None])
