"""Mesh partitioning for the sharded solver (mgcfd_tpu/parallel/
partition.py), numpy only, its arrays equal to mgcfd_tpu's element for
element:

  - nodes are split into P contiguous blocks of B = ceil(n / P) (the
    generator or RCM gives locality; partition_order_2d makes the blocks
    2-D tiles instead);
  - each internal edge is owned by the shard of its end a; boundary and
    wall edges by the shard of their node;
  - a shard's SEPARATOR is its nodes that the cross-shard edges touch;
    their values travel as one all_gather of a (P, Smax, 5) pool per flux
    evaluation, and the indexed-stream paths return foreign
    contributions with one reduce-scatter;
  - levels 0..S-1 are sharded, the coarser ones replicated; the transfers
    across a boundary use the MG bookkeeping below.

Everything here stacks the P shards on a leading axis, as mgcfd_tpu's
arrays for shard_map do; each rank of the port takes its own row. The
storage width is B: mgcfd_tpu rounds it up to whole (8, 128) TPU windows
when it packs window plans, which the port does not build. In their place
each rank builds owner-sorted CSRs of its own shard (shard_flux_csr,
shard_restrict_csr, shard_prolong_csr; the style of prep/csr.py), through
the plan cache keyed by (p, P). partition_level goes through the plan
cache too, so that ranks sharing a cache directory partition a level once.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import MeshLevel, MultigridMesh
from ..prep import plancache
from ..prep.csr import CSRPlan, _csr
from ..prep.renumber import apply_node_order

# shard_levels=0 (auto) shards a level while it keeps this many nodes a
# shard. mgcfd_tpu set it as a host-side proxy for the crossover it
# measured on the TPU (4 vreg windows of nodes a shard); it has not been
# measured on the card.
AUTO_NODES_PER_SHARD = 4096


@dataclasses.dataclass
class ShardedLevelData:
    """Stacked per-shard arrays of one level (leading axis = P), the
    fields of mgcfd_tpu's ShardedLevelData that are not TPU window plans."""
    volumes: np.ndarray          # (P, B)
    node_mask: np.ndarray        # (P, B) 1.0 for real nodes, 0.0 padding
    coords: np.ndarray | None    # (P, B, 3)
    # owned internal edges, indices into the combined [block | pool]
    # space (B + P * Smax); padding is a zero-weight self-edge on node 0
    edge_a: np.ndarray           # (P, E) int32
    edge_b: np.ndarray           # (P, E) int32
    edge_w: np.ndarray           # (P, E, 3)
    bedge_b: np.ndarray          # (P, Eb) int32, block-local
    bedge_w: np.ndarray          # (P, Eb, 3)
    wedge_b: np.ndarray          # (P, Ew) int32
    wedge_w: np.ndarray          # (P, Ew, 3)
    sep_idx: np.ndarray          # (P, Smax) int32, block-local
    sep_mask: np.ndarray         # (P, Smax) float
    # shift decomposition of shard-local edges (accumulate='shift')
    shift_deltas: list
    shift_w: np.ndarray          # (P, D, B, 3)
    shift_wpad: np.ndarray | None  # (P, 4, D * B) rolled form
    dense_bd: np.ndarray         # (P, B, 3) summed boundary normals
    dense_wl: np.ndarray         # (P, B, 3) summed wall normals
    # every owned edge (covered by spans or not), for the prolongation
    pro_dest_a: np.ndarray       # (P, Efull) int32 combined
    pro_dest_b: np.ndarray
    num_nodes: int
    block: int                   # storage width (== part_width here)
    part_width: int              # node i belongs to shard i // part_width
    smax: int
    # multigrid to the next level, which is replicated (_attach_mg)
    mg_mapping: np.ndarray | None = None   # (P, B) int64; padding -> Nc
    mg_counts: np.ndarray | None = None    # (Nc,)
    mg_mapped: np.ndarray | None = None    # (Nc,) bool
    coincident: np.ndarray | None = None   # (P, B) bool
    parent: np.ndarray | None = None       # (P, B) int32
    pro_a1: np.ndarray | None = None       # (P, Efull) int32
    pro_b1: np.ndarray | None = None
    pro_id_a1a2: np.ndarray | None = None  # (P, Efull)
    pro_id_b1a2: np.ndarray | None = None
    pro_id_b1b2: np.ndarray | None = None
    pro_id_a1b2: np.ndarray | None = None
    pro_live_a: np.ndarray | None = None
    pro_live_b: np.ndarray | None = None
    # when the next level is sharded too (_attach_mg_padded)
    mgp_pad: np.ndarray | None = None      # (P, B) int64, P*Bc = dump
    mgc_counts: np.ndarray | None = None   # (P, Bc)
    mgc_mapped: np.ndarray | None = None   # (P, Bc) bool
    c_raw2pad: np.ndarray | None = None    # (Nc,) int32

    @property
    def P(self) -> int:
        return self.volumes.shape[0]

    def bounds(self, p: int) -> tuple[int, int]:
        """Shard p's global node range [lo, hi)."""
        lo = p * self.part_width
        return lo, max(lo, min(lo + self.part_width, self.num_nodes))


plancache.register_type(ShardedLevelData)


@dataclasses.dataclass
class ShardedMeshData:
    levels: list                   # ShardedLevelData, levels 0..S-1
    coarse_levels: list            # replicated MeshLevels S..L-1
    P: int

    @property
    def level0(self) -> ShardedLevelData:
        return self.levels[0]


def partition_order_2d(coords: np.ndarray, P: int,
                       shape: tuple[int, int] | None = None) -> np.ndarray:
    """The permutation (order[new_id] = old_id) under which contiguous
    B-blocks are Px x Py tiles: nodes chunked into Px groups of Py * B by
    x rank, each group into tiles of B by y rank; block b is tile
    (b // Py, b % Py), and each tile keeps the input order of its nodes
    (so RCM or the generator's locality survives inside a tile)."""
    n = coords.shape[0]
    if shape is None:
        px = int(np.sqrt(P))
        while P % px:
            px -= 1
        shape = (P // px, px)
    Px, Py = shape
    if Px * Py != P:
        raise ValueError(f"partition shape {shape} != {P} shards")
    B = -(-n // P)
    ox = np.argsort(coords[:, 0], kind="stable")
    order = np.empty(n, np.int64)
    pos = 0
    for i in range(Px):
        grp = ox[i * Py * B:min((i + 1) * Py * B, n)]
        oy = grp[np.argsort(coords[grp, 1], kind="stable")]
        for j in range(Py):
            tile = np.sort(oy[j * B:min((j + 1) * B, len(oy))])
            order[pos:pos + len(tile)] = tile
            pos += len(tile)
    return order


def partition2d_hierarchy(mesh: MultigridMesh, P: int,
                          shape: tuple[int, int] | None = None):
    """Every level reordered by partition_order_2d, the mg maps fixed as
    renumber_hierarchy fixes them. Returns (new mesh, orders), orders[l]
    [new_id] = old_id, for translating the state back."""
    new_levels, orders = [], []
    for lev, lvl in enumerate(mesh.levels):
        if lvl.coords is None:
            raise ValueError("2-D partitioning needs node coords")
        order = partition_order_2d(lvl.coords, P, shape)
        inv = np.empty_like(order)
        inv[order] = np.arange(order.shape[0])
        new_levels.append(apply_node_order(lvl, order))
        orders.append(order)
        if lev > 0 and new_levels[lev - 1].mg_mapping is not None:
            new_levels[lev - 1].mg_mapping = inv[new_levels[lev - 1]
                                                 .mg_mapping]
    return (MultigridMesh(levels=new_levels, variant=mesh.variant,
                          problem_size=mesh.problem_size, name=mesh.name),
            orders)


def _separators(lvl: MeshLevel, P: int, B: int):
    """Both ends of every cross-shard edge, per owning shard in ascending
    order: (sep_idx, sep_mask, smax, rank) with rank[node] the node's
    position in its shard's list (0 for nodes in none)."""
    part = np.minimum(lvl.edge_a.astype(np.int64) // B, P - 1)
    cross = part != np.minimum(lvl.edge_b.astype(np.int64) // B, P - 1)
    nodes = np.unique(np.concatenate([lvl.edge_a[cross],
                                      lvl.edge_b[cross]]).astype(np.int64))
    owner = np.minimum(nodes // B, P - 1)
    counts = np.bincount(owner, minlength=P)
    smax = max(1, int(counts.max()) if nodes.size else 0)
    start = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    rank = np.zeros(lvl.num_nodes, np.int64)
    rank[nodes] = np.arange(nodes.size) - start[owner]
    sep_idx = np.zeros((P, smax), np.int32)
    sep_mask = np.zeros((P, smax))
    sep_idx[owner, rank[nodes]] = nodes - owner * B
    sep_mask[owner, rank[nodes]] = 1.0
    return sep_idx, sep_mask, smax, rank


def _combined_index(nodes, shard: int, P: int, B: int, smax: int, rank):
    """Index of each node into shard `shard`'s [block (B) | pool (P*Smax)]
    space: its block slot if the shard owns it, else its pool slot."""
    nodes = np.asarray(nodes, np.int64)
    part = np.minimum(nodes // B, P - 1)
    return np.where(part == shard, nodes - part * B,
                    B + part * smax + rank[nodes]).astype(np.int32)


def partition_level(lvl: MeshLevel, P: int, use_shift: bool = False,
                    shift_max_deltas: int = 8,
                    shift_min_density: float = 0.01) -> ShardedLevelData:
    """One level's stacked shard arrays (mgcfd_tpu's partition_level with
    use_window=False)."""
    n = lvl.num_nodes
    B = -(-n // P)

    def part(idx):
        return np.minimum(idx // B, P - 1)

    def local(idx):
        return idx - part(idx) * B

    ea = lvl.edge_a.astype(np.int64)
    eb = lvl.edge_b.astype(np.int64)
    owner, pb = part(ea), part(eb)

    # --- shift decomposition of shard-local edges: the spans are chosen
    # over all shards, so every shard has the same delta list ---
    span = eb - ea
    eligible = (pb == owner) & (span > 0) & (span < B) & \
        (local(ea) + span < B)
    cnt = np.bincount(span[eligible], minlength=1)
    order_d = np.argsort(cnt)[::-1]
    deltas = [] if not use_shift else [
        int(d) for d in order_d[:shift_max_deltas]
        if d > 0 and cnt[d] >= max(1, shift_min_density * n)]
    covered = np.zeros(ea.shape[0], dtype=bool)
    shift_w = np.zeros((P, max(1, len(deltas)), B, 3))
    for di, d in enumerate(deltas):
        sel = np.flatnonzero(eligible & (span == d) & ~covered)
        # one edge per (owner, local a) and delta: the first wins
        _, first = np.unique(owner[sel] * B + local(ea[sel]),
                             return_index=True)
        keep = sel[np.sort(first)]
        shift_w[owner[keep], di, local(ea[keep])] = lvl.edge_w[keep]
        covered[keep] = True
    shift_wpad = None
    if deltas:
        D = len(deltas)
        shift_wpad = np.zeros((P, 4, D * B))
        for di in range(D):
            shift_wpad[:, :3, di * B:(di + 1) * B] = \
                shift_w[:, di].transpose(0, 2, 1)
            shift_wpad[:, 3, di * B:(di + 1) * B] = np.sqrt(
                (shift_w[:, di] ** 2).sum(axis=2))

    sep_idx, sep_mask, smax, rank = _separators(lvl, P, B)

    # --- per-shard edge streams (uncovered edges; the covered ones live
    # in the span diagonals) and the full stream for the prolongation ---
    def streams(keep):
        m = max(1, int(np.bincount(owner[keep], minlength=P).max()))
        a = np.zeros((P, m), np.int32)
        b = np.zeros((P, m), np.int32)
        w = np.zeros((P, m, 3))
        for p in range(P):
            sel = (owner == p) & keep
            k = int(sel.sum())
            a[p, :k] = _combined_index(ea[sel], p, P, B, smax, rank)
            b[p, :k] = _combined_index(eb[sel], p, P, B, smax, rank)
            w[p, :k] = lvl.edge_w[sel]
        return a, b, w

    edge_a, edge_b, edge_w = streams(~covered)
    pro_dest_a, pro_dest_b, _ = streams(np.ones_like(covered))

    def local_edges(idx, wts):
        idx = idx.astype(np.int64)
        p_of = part(idx)
        m = max(1, int(np.bincount(p_of, minlength=P).max()))
        out_i = np.zeros((P, m), np.int32)
        out_w = np.zeros((P, m, 3))
        for p in range(P):
            sel = p_of == p
            out_i[p, :sel.sum()] = local(idx[sel])
            out_w[p, :sel.sum()] = wts[sel]
        return out_i, out_w

    bedge_b, bedge_w = local_edges(lvl.bedge_b, lvl.bedge_w)
    wedge_b, wedge_w = local_edges(lvl.wedge_b, lvl.wedge_w)

    volumes = np.ones((P, B))
    node_mask = np.zeros((P, B))
    coords = np.zeros((P, B, 3)) if lvl.coords is not None else None
    for p in range(P):
        lo, hi = p * B, min((p + 1) * B, n)
        volumes[p, :hi - lo] = lvl.volumes[lo:hi]
        node_mask[p, :hi - lo] = 1.0
        if coords is not None:
            coords[p, :hi - lo] = lvl.coords[lo:hi]

    dense_bd = np.zeros((P, B, 3))
    dense_wl = np.zeros((P, B, 3))
    for arr, idx, w in ((dense_bd, lvl.bedge_b, lvl.bedge_w),
                        (dense_wl, lvl.wedge_b, lvl.wedge_w)):
        idx = idx.astype(np.int64)
        np.add.at(arr, (part(idx), local(idx)), w)

    return ShardedLevelData(
        volumes=volumes, node_mask=node_mask, coords=coords,
        edge_a=edge_a, edge_b=edge_b, edge_w=edge_w,
        bedge_b=bedge_b, bedge_w=bedge_w, wedge_b=wedge_b, wedge_w=wedge_w,
        sep_idx=sep_idx, sep_mask=sep_mask, shift_deltas=deltas,
        shift_w=shift_w, shift_wpad=shift_wpad, dense_bd=dense_bd,
        dense_wl=dense_wl, pro_dest_a=pro_dest_a, pro_dest_b=pro_dest_b,
        num_nodes=n, block=B, part_width=B, smax=smax)


def _attach_mg(sl: ShardedLevelData, lvl: MeshLevel,
               coarse: MeshLevel) -> None:
    """MG bookkeeping from sharded `lvl` to raw-indexed `coarse`: the
    restriction onto a replicated coarse level, and the prolongation into
    `lvl` (which reads raw coarse residuals)."""
    mapping = lvl.mg_mapping
    if mapping is None or mapping.shape[0] != lvl.num_nodes:
        raise ValueError("sharded multigrid requires a full fine->coarse "
                         "mapping")
    P, B = sl.P, sl.part_width
    mg = np.full((P, B), coarse.num_nodes, dtype=np.int64)
    coin = np.zeros((P, B), dtype=bool)
    full_coin = np.all(lvl.coords == coarse.coords[mapping], axis=1)
    for p in range(P):
        lo, hi = sl.bounds(p)
        mg[p, :hi - lo] = mapping[lo:hi]
        coin[p, :hi - lo] = full_coin[lo:hi]
    counts = np.bincount(mapping, minlength=coarse.num_nodes).astype(
        np.float64)
    sl.mg_mapping = mg
    sl.mg_counts = counts
    sl.mg_mapped = counts > 0
    sl.coincident = coin
    sl.parent = np.minimum(mg, coarse.num_nodes - 1).astype(np.int32)
    _attach_prolong_geometry(sl, lvl, coarse, full_coin)


def _attach_mg_padded(sl_f: ShardedLevelData, sl_c: ShardedLevelData,
                      lvl_f: MeshLevel) -> None:
    """Extras for a sharded -> sharded restriction: fine nodes target the
    coarse level's padded block space (P * Bc), so that one reduce-scatter
    lands each shard its own coarse block; c_raw2pad takes the gathered
    padded blocks back to raw order for the prolongation."""
    P = sl_f.P
    mapping = lvl_f.mg_mapping.astype(np.int64)
    Bc, Wc, Nc = sl_c.block, sl_c.part_width, sl_c.num_nodes
    pc = np.minimum(mapping // Wc, P - 1)
    pad = pc * Bc + (mapping - pc * Wc)
    mgp = np.full((P, sl_f.block), P * Bc, dtype=np.int64)
    for p in range(P):
        lo, hi = sl_f.bounds(p)
        mgp[p, :hi - lo] = pad[lo:hi]
    counts_raw = np.bincount(mapping, minlength=Nc).astype(np.float64)
    cc = np.zeros((P, Bc))
    cm = np.zeros((P, Bc), dtype=bool)
    for p in range(P):
        lo, hi = sl_c.bounds(p)
        cc[p, :hi - lo] = counts_raw[lo:hi]
        cm[p, :hi - lo] = counts_raw[lo:hi] > 0
    g = np.arange(Nc, dtype=np.int64)
    pg = np.minimum(g // Wc, P - 1)
    sl_f.mgp_pad = mgp
    sl_f.mgc_counts = cc
    sl_f.mgc_mapped = cm
    sl_f.c_raw2pad = (pg * Bc + (g - pg * Wc)).astype(np.int32)


def _attach_prolong_geometry(sl: ShardedLevelData, lvl: MeshLevel,
                             coarse: MeshLevel,
                             full_coin: np.ndarray) -> None:
    """Per owned edge, the prolongation's static geometry (ops/mg.py's
    prolong_residuals_interpolate, the a1 -> b2 quirk included: id_a1b2
    pairs with b1)."""
    P, B = sl.P, sl.part_width
    mapping = lvl.mg_mapping
    owner = np.minimum(lvl.edge_a // B, P - 1)
    shape = sl.pro_dest_a.shape

    def idist(p, q):
        d = p - q
        return 1.0 / np.sqrt((d * d).sum(axis=1))

    pro = {k: np.zeros(shape) for k in
           ("id_a1a2", "id_b1a2", "id_b1b2", "id_a1b2", "live_a", "live_b")}
    a1s = np.zeros(shape, np.int32)
    b1s = np.zeros(shape, np.int32)
    for p in range(P):
        sel = owner == p
        a2 = lvl.edge_a[sel].astype(np.int64)
        b2 = lvl.edge_b[sel].astype(np.int64)
        a1, b1 = mapping[a2], mapping[b2]
        ca1, cb1 = coarse.coords[a1], coarse.coords[b1]
        ca2, cb2 = lvl.coords[a2], lvl.coords[b2]
        m = a2.shape[0]
        a1s[p, :m] = a1
        b1s[p, :m] = b1
        with np.errstate(divide="ignore"):
            pro["id_a1a2"][p, :m] = idist(ca2, ca1)
            pro["id_b1a2"][p, :m] = idist(cb1, ca2)
            pro["id_b1b2"][p, :m] = idist(cb2, cb1)
            pro["id_a1b2"][p, :m] = idist(ca1, cb2)
        pro["live_a"][p, :m] = (~full_coin[a2]).astype(np.float64)
        pro["live_b"][p, :m] = (~full_coin[b2]).astype(np.float64)
    # coincident ends give infinite inverse distances, masked by live_*
    for keys, live in ((("id_a1a2", "id_b1a2"), "live_a"),
                       (("id_b1b2", "id_a1b2"), "live_b")):
        for k in keys:
            pro[k][~np.isfinite(pro[k])] = 0.0
            pro[k] *= pro[live] > 0
    sl.pro_a1, sl.pro_b1 = a1s, b1s
    sl.pro_id_a1a2, sl.pro_id_b1a2 = pro["id_a1a2"], pro["id_b1a2"]
    sl.pro_id_b1b2, sl.pro_id_a1b2 = pro["id_b1b2"], pro["id_a1b2"]
    sl.pro_live_a, sl.pro_live_b = pro["live_a"], pro["live_b"]


def num_sharded_levels(mesh: MultigridMesh, P: int,
                       shard_levels: int) -> int:
    """S: shard_levels clamped to 1..L-1 (1 for a single level); 0 is
    auto, which shards while a level keeps AUTO_NODES_PER_SHARD nodes a
    shard."""
    L = mesh.num_levels
    if shard_levels == 0:
        S = 1
        while S < L - 1 and \
                mesh.levels[S].num_nodes >= AUTO_NODES_PER_SHARD * P:
            S += 1
        return S
    return max(1, min(shard_levels, max(1, L - 1)))


def partition_mesh(mesh: MultigridMesh, P: int, use_shift: bool = False,
                   shard_levels: int = 1,
                   plan_cache_dir: str = "") -> ShardedMeshData:
    """Shard levels 0..S-1 (num_sharded_levels) and attach their MG
    bookkeeping; levels S.. stay replicated. Each level's partition goes
    through the plan cache."""
    L = mesh.num_levels
    S = num_sharded_levels(mesh, P, shard_levels)
    levels = mesh.levels

    def build(i):
        sl = partition_level(levels[i], P, use_shift=use_shift)
        if i + 1 < L:
            _attach_mg(sl, levels[i], levels[i + 1])
        return sl

    slevels = []
    for i in range(S):
        lv, nxt = levels[i], (levels[i + 1] if i + 1 < L else None)
        key = [lv.volumes, lv.edge_a, lv.edge_b, lv.edge_w, lv.bedge_b,
               lv.bedge_w, lv.wedge_b, lv.wedge_w,
               np.asarray([P, use_shift])]
        if nxt is not None:
            key += [lv.coords, lv.mg_mapping, nxt.coords]
        slevels.append(plancache.cached_plan(
            plan_cache_dir, f"torch-partition-P{P}", key,
            lambda i=i: build(i)))
    for i in range(S - 1):
        _attach_mg_padded(slevels[i], slevels[i + 1], levels[i])
    return ShardedMeshData(levels=slevels, coarse_levels=levels[S:], P=P)


# ---------------------------------------------------------------------------
# each rank's owner-sorted CSRs (the port's counterpart of the TPU window
# plans mgcfd_tpu packs per shard)
# ---------------------------------------------------------------------------

def _sep_rank(sl: ShardedLevelData) -> np.ndarray:
    """rank[node]: the node's slot in its shard's separator list."""
    rank = np.zeros(sl.num_nodes, np.int64)
    p, r = np.nonzero(sl.sep_mask)
    rank[p * sl.part_width + sl.sep_idx[p, r]] = r
    return rank


def shard_flux_csr(lvl: MeshLevel, sl: ShardedLevelData, p: int) -> CSRPlan:
    """Shard p's flux and rw CSR: rows its B block nodes, columns the
    combined [block | pool] space. Every half-edge into an owned node is
    in it, the foreign ones too: (a, b, +w) when p owns a, (b, a, -w) when
    p owns b (a gather-only halo, no return collective). Within a row the
    halves keep build_edge_csr's order, so at P = 1 it is that CSR."""
    P, B, smax = sl.P, sl.part_width, sl.smax
    ea = lvl.edge_a.astype(np.int64)
    eb = lvl.edge_b.astype(np.int64)
    sa = np.minimum(ea // B, P - 1) == p
    sb = np.minimum(eb // B, P - 1) == p
    rank = _sep_rank(sl)
    owner = np.concatenate([ea[sa], eb[sb]]) - p * B
    nbr = _combined_index(np.concatenate([eb[sa], ea[sb]]), p, P, B, smax,
                          rank)
    w = np.concatenate([lvl.edge_w[sa], -lvl.edge_w[sb]]).reshape(-1, 3)
    ewt = np.sqrt((w ** 2).sum(axis=1))
    return _csr(B, B + P * smax, owner, nbr,
                np.concatenate([w.T, ewt[None]], axis=0))


def restrict_targets(lvl: MeshLevel, sl: ShardedLevelData,
                     next_sl: ShardedLevelData | None):
    """(destination of each fine node, destination width): the raw coarse
    id when the next level is replicated, else its padded block slot
    pc * Bc + local."""
    mapping = lvl.mg_mapping.astype(np.int64)
    if next_sl is None:
        return mapping, int(sl.mg_counts.shape[0])
    P, Bc, Wc = sl.P, next_sl.block, next_sl.part_width
    pc = np.minimum(mapping // Wc, P - 1)
    return pc * Bc + (mapping - pc * Wc), P * Bc


def shard_restrict_csr(lvl: MeshLevel, sl: ShardedLevelData,
                       next_sl: ShardedLevelData | None,
                       p: int) -> CSRPlan:
    """Shard p's restriction partial sums: rows the destination space
    (restrict_targets), columns the B block nodes, weight 1/count_global,
    so that the sum over shards is the children's mean."""
    dest, width = restrict_targets(lvl, sl, next_sl)
    counts = np.bincount(dest, minlength=width).astype(np.float64)
    w = (1.0 / np.maximum(counts, 1.0))[dest]
    lo, hi = sl.bounds(p)
    return _csr(width, sl.part_width, dest[lo:hi],
                np.arange(hi - lo, dtype=np.int64), w[None, lo:hi])


def shard_prolong_csr(full: CSRPlan, sl: ShardedLevelData,
                      p: int) -> CSRPlan:
    """Shard p's rows of the level's composed prolongation `full`
    (build_prolong_csr), from the raw coarse residuals to its B block
    nodes: no collective."""
    lo, hi = sl.bounds(p)
    s, e = int(full.row_ptr[lo]), int(full.row_ptr[hi])
    row_ptr = np.full(sl.part_width + 1, e - s, np.int64)
    row_ptr[:hi - lo + 1] = full.row_ptr[lo:hi + 1] - s
    return CSRPlan(num_rows=sl.part_width, num_cols=full.num_cols,
                   row_ptr=row_ptr, owner=full.owner[s:e] - lo,
                   col=full.col[s:e], w=np.ascontiguousarray(full.w[:, s:e]))
