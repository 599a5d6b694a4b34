"""The sharded multigrid solver over torch.distributed (mgcfd_tpu/parallel/
sharded.py, which runs one shard_map'd program over a device mesh).

Each rank is a process that owns one shard: row p = rank of the stacked
partition (parallel/partition.py). A cycle is MGCFDSolver's own cycle;
this solver overrides its per-level methods (_visit_level, _restrict,
_prolong, _rms and the cycle's invalid count) on the sharded levels:

  - sharded levels 0..S-1: each rank smooths its node block. A flux
    evaluation gathers the separator pool (one all_gather) into the
    combined [block | pool] operand. On the kernel paths ('window',
    'pallas') the edge_csr flux and rw kernels then run over the rank's
    owner CSR, which holds every half-edge into an owned node, the foreign
    ones too: no return collective. On the edge-stream paths ('segment'
    and its variants, 'shift') the owned edges' values are summed over
    [block | pool] and the pool's part returns to its owners by one
    reduce-scatter, as in mgcfd_tpu; 'shift' adds the rolled span
    diagonals of the shard-local edges. Boundary and wall flux come from
    the per-node aggregated normals. The step factor's global min is an
    all_reduce MIN (exact in any order), the RMS and the invalid count
    all_reduce SUMs;
  - the transfers across a sharded level: restriction as partial means at
    1/count_global weights (the wsum kernel on the kernel paths, else a
    segment sum), then an all_reduce SUM onto a replicated coarse level,
    or a reduce-scatter onto a sharded one; prolongation from the raw
    coarse residuals through the rank's rows of the composed prolongation
    (the wsum kernel, no collective; the coarse blocks all_gathered first
    when the coarse level is sharded), else mgcfd_tpu's static per-edge
    geometry with its reduce-scatter;
  - replicated levels S..L-1: every rank runs MGCFDSolver's own visits and
    transfers on them (fused_stage on 'window', the span kernels on
    'pallas'), identically; their invalid counts go into the cycle's
    counter of the replicated levels, which is not summed over the ranks.

run_batched: under NCCL a batch of K cycles is one CUDA graph
(solver.CycleGraph), the collectives captured with the kernels. Under
gloo (the CPU tests, and ranks that share one card) the collectives run
on the host and cannot be captured, so a batch loops cycle(); which of
the two is decided by the backend when the solver is built.

Interface: as MGCFDSolver's, but variables(), step_factors() and every
checkpoint write are collectives (each gathers the sharded levels), so
every rank must call them; rank 0 writes the checkpoints and prints.
Checkpoints are node-major in the caller's node order at real width, as
the single-device solver's: a run moves between any P, a 2-D
decomposition and MGCFDSolver, in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import SolverConfig
from ..core.constants import NVAR, RK, MeshVariant, far_field_state
from ..core.types import MultigridMesh
from ..kernels import DeviceCSR, edge_csr
from ..kernels.fused_stage import invalid_count
from ..mesh.build import apply_ewt_conditioning
from ..ops import (cbrt_volumes, compute_step_factor,
                   compute_step_factor_legacy, indirect_rw_edge_values,
                   internal_edge_flux, internal_edge_flux_crippled, tops)
from ..prep.csr import build_prolong_csr
from ..prep.plancache import cached_plan
from ..solver.solver import (DTYPES, DeviceLevel, DeviceMesh, MGCFDSolver,
                             kscope, prepare_device_mesh, resolve_accumulate,
                             resolve_device, variable_major)
from ..utils.checkpoint import latest_checkpoint, load_checkpoint
from .comm import Comm
from .partition import (ShardedLevelData, partition2d_hierarchy,
                        partition_mesh, restrict_targets, shard_flux_csr,
                        shard_prolong_csr, shard_restrict_csr)

# the stacked arrays each rank keeps its row of, on the device
_ROW_FLOAT = ("node_mask", "sep_mask", "pro_id_a1a2", "pro_id_b1a2",
              "pro_id_b1b2", "pro_id_a1b2", "pro_live_a", "pro_live_b",
              "mgc_counts")
_ROW_INDEX = ("sep_idx", "pro_a1", "pro_b1", "pro_dest_a", "pro_dest_b",
              "parent", "mgp_pad")


def conditioned(mesh: MultigridMesh) -> MultigridMesh:
    """The mesh with its edge weights conditioned per variant, on copies:
    what ShardedSolver partitions (a caller can fill the plan cache with
    partition_mesh(conditioned(mesh), P, plan_cache_dir=...) before the
    ranks start)."""
    levels = [dataclasses.replace(lv, edge_w=lv.edge_w.copy(),
                                  bedge_w=lv.bedge_w.copy(),
                                  wedge_w=lv.wedge_w.copy())
              for lv in mesh.levels]
    apply_ewt_conditioning(levels, mesh.variant)
    return MultigridMesh(levels=levels, variant=mesh.variant,
                         problem_size=mesh.problem_size, name=mesh.name)


@dataclasses.dataclass
class ShardLevel:
    """One sharded level on one rank: `dev` holds the rank's block as a
    DeviceLevel (num_nodes = B; its volumes, owned edge stream, aggregated
    boundary/wall constants `nc`, and on the kernel paths its flux CSR
    `csr`, restriction CSR and prolongation rows), `c` the exchange and
    transfer tensors under mgcfd_tpu's names, `host` the stacked
    partition."""
    dev: DeviceLevel
    c: dict
    host: ShardedLevelData
    deltas: list

    @property
    def B(self) -> int:
        return self.host.block

    @property
    def pool(self) -> int:
        return self.host.P * self.host.smax


class ShardedSolver(MGCFDSolver):
    """MGCFDSolver's cycle over P ranks (module docstring). Every rank
    builds one with the same mesh and config inside an initialised
    process group of config.num_partitions ranks (parallel/comm.py,
    parallel/launch.py). device: the card (the rank's own under NCCL,
    card 0 when the ranks share it) unless 'cpu'."""

    def __init__(self, mesh: MultigridMesh,
                 config: SolverConfig | None = None, device=None):
        self.config = config or SolverConfig()
        self.config.validate()
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.comm = Comm(device)
        P = self.config.num_partitions
        if self.comm.size != P:
            raise ValueError(f"num_partitions={P} but the process group "
                             f"has {self.comm.size} ranks")
        self.P, self.rank = P, self.comm.rank
        self.mesh = mesh
        self.dtype = DTYPES[self.config.dtype]
        self.legacy = mesh.variant.uses_legacy_step_factor
        # 'auto' is decided on the whole mesh, as MGCFDSolver decides it
        resolve_accumulate(mesh, self.config, device)
        self._kernels = self.config.accumulate in ("window", "pallas")
        self._tstate = variable_major(self.config)

        cond = conditioned(mesh)
        # a 2-D tile decomposition is a node order: the state goes in and
        # out in the caller's order through part_orders
        self.part_orders = self.part_invs = None
        if self.config.partition_2d:
            shape = None
            if self.config.partition_2d != "auto":
                shape = tuple(int(x) for x in
                              self.config.partition_2d.lower().split("x"))
            cond, self.part_orders = partition2d_hierarchy(cond, P, shape)
            self.part_invs = [np.argsort(o) for o in self.part_orders]
        self._conditioned = cond
        self.smesh = partition_mesh(
            cond, P, use_shift=self.config.accumulate == "shift",
            shard_levels=self.config.shard_levels,
            plan_cache_dir=self.config.plan_cache_dir)
        self.S = S = len(self.smesh.levels)
        self.shards = [self._shard_level(i) for i in range(S)]
        # the replicated levels: MGCFDSolver's device levels, built on
        # weights conditioned already (FVCORR conditions nothing)
        coarse = prepare_device_mesh(
            MultigridMesh(levels=cond.levels[S:], variant=MeshVariant.FVCORR),
            self.config, device) if cond.num_levels > S else None
        self.dmesh = DeviceMesh(
            levels=[sh.dev for sh in self.shards]
            + (coarse.levels if coarse else []),
            variant=mesh.variant,
            ff_flux=torch.as_tensor(far_field_state(np.float64)[1]).to(
                device=device, dtype=self.dtype))

        ff = far_field_state(np.float64)[0]
        self.state = {
            "variables": [self._block(np.tile(ff, (sh.B, 1)))
                          for sh in self.shards]
            + [self._coarse(np.tile(ff, (lv.num_nodes, 1)))
               for lv in cond.levels[S:]],
            "residuals": [self._block(np.zeros((sh.B, NVAR)))
                          for sh in self.shards]
            + [self._coarse(np.zeros((lv.num_nodes, NVAR)))
               for lv in cond.levels[S:]]}
        self.rms_history: list[float] = []
        self.completed_cycles = 0
        self._graph = None
        if self.config.resume and self.config.checkpoint_dir:
            path = latest_checkpoint(self.config.checkpoint_dir)
            if path is not None:
                st, self.completed_cycles, self.rms_history = \
                    load_checkpoint(path, mesh, torch.float64, "cpu")
                self.load_state(st)

    # --- set-up ------------------------------------------------------------

    def _put(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype or self.dtype)

    def _block(self, a):
        """A (B, 5) host block -> (5, B) on the device."""
        return self._put(np.asarray(a, np.float64).T)

    def _coarse(self, a):
        """A replicated level's (N, 5) host array in its path's layout."""
        a = np.asarray(a, np.float64)
        return self._put(a.T if self._tstate else a)

    def _shard_level(self, i: int) -> ShardLevel:
        """This rank's row of sharded level i, on the device, with its
        CSRs through the plan cache (kinds torch-shard-*-p<p>of<P>)."""
        sl, p, P = self.smesh.levels[i], self.rank, self.P
        lvl = self._conditioned.levels[i]
        cache = self.config.plan_cache_dir
        ff_flux = far_field_state(np.float64)[1]
        volumes = self._put(sl.volumes[p])
        dev = DeviceLevel(
            num_nodes=sl.block, volumes=volumes,
            cbrt_volumes=cbrt_volumes(volumes), coords=None,
            edge_a=self._put(sl.edge_a[p], torch.int64),
            edge_b=self._put(sl.edge_b[p], torch.int64),
            edge_w=self._put(sl.edge_w[p]),
            bedge_b=self._put(sl.bedge_b[p], torch.int64),
            bedge_w=self._put(sl.bedge_w[p]),
            wedge_b=self._put(sl.wedge_b[p], torch.int64),
            wedge_w=self._put(sl.wedge_w[p]),
            mg_mapping=None if sl.mg_mapping is None
            else self._put(sl.mg_mapping[p], torch.int64))
        wl = sl.dense_wl[p]
        dev.nc = self._put(np.concatenate(
            [sl.dense_bd[p].T, wl.T,
             0.5 * np.einsum("nd,dv->vn", wl, ff_flux)], axis=0))
        tag = f"p{p}of{P}"
        if self._kernels:
            dev.csr = DeviceCSR.from_plan(cached_plan(
                cache, f"torch-shard-flux-{tag}",
                (lvl.edge_a, lvl.edge_b, lvl.edge_w,
                 np.asarray([lvl.num_nodes, p, P])),
                lambda: shard_flux_csr(lvl, sl, p)), self.device,
                self.dtype)
        if sl.mg_mapping is not None:
            nxt = self._conditioned.levels[i + 1]
            next_sl = self.smesh.levels[i + 1] \
                if i + 1 < len(self.smesh.levels) else None
            if self._kernels:
                _, width = restrict_targets(lvl, sl, next_sl)
                dev.restrict_csr = DeviceCSR.from_plan(cached_plan(
                    cache, f"torch-shard-restrict-{tag}",
                    (lvl.mg_mapping, np.asarray([lvl.num_nodes, width, p,
                                                 P])),
                    lambda: shard_restrict_csr(lvl, sl, next_sl, p)),
                    self.device, self.dtype)
                sizes = np.asarray([lvl.num_nodes, nxt.num_nodes])
                full = cached_plan(
                    cache, "torch-prolong",
                    (lvl.edge_a, lvl.edge_b, lvl.coords, nxt.coords,
                     lvl.mg_mapping, sizes),
                    lambda: build_prolong_csr(lvl, nxt))
                dev.prolong_csr = DeviceCSR.from_plan(
                    shard_prolong_csr(full, sl, p), self.device, self.dtype)
            mapped = sl.mg_mapped if next_sl is None else sl.mgc_mapped[p]
            dev.restrict_mapped = torch.as_tensor(mapped).to(self.device)
        c = {}
        for name in _ROW_FLOAT + _ROW_INDEX:
            a = getattr(sl, name)
            if a is not None:
                c[name] = self._put(a[p], torch.int64 if name in _ROW_INDEX
                                    else None)
        if sl.mg_counts is not None:
            c["mg_counts"] = self._put(sl.mg_counts)
        if sl.coincident is not None:
            c["coincident"] = torch.as_tensor(sl.coincident[p]).to(
                self.device)
        if sl.c_raw2pad is not None:
            c["c_raw2pad"] = self._put(sl.c_raw2pad, torch.int64)
        if sl.shift_wpad is not None and \
                self.config.accumulate == "shift":
            c["shift_wpad"] = self._put(sl.shift_wpad[p])
        return ShardLevel(dev=dev, c=c, host=sl,
                          deltas=list(sl.shift_deltas)
                          if "shift_wpad" in c else [])

    def _captures(self) -> bool:
        return self.device.type == "cuda" and self.comm.capturable

    # --- one sharded level -------------------------------------------------

    def _exchange(self, sh: ShardLevel, q):
        """(5, B) -> the combined (5, B + P * Smax) [block | pool]."""
        pool = self.comm.all_gather(q[:, sh.c["sep_idx"]])   # (P, 5, Smax)
        return torch.cat([q, pool.permute(1, 0, 2).reshape(NVAR, sh.pool)],
                         dim=1)

    def _pool_return(self, sh: ShardLevel, seg):
        """The pool rows (P * Smax, ...) of a segment sum back to their
        owners: (Smax, ...) summed over ranks, padding slots zeroed."""
        recv = self.comm.reduce_scatter(
            seg.reshape((self.P, sh.host.smax) + tuple(seg.shape[1:])))
        mask = sh.c["sep_mask"]
        return recv * (mask[:, None] if recv.ndim == 2 else mask)

    def _step_factor(self, sh: ShardLevel, q):
        """mgcfd_tpu's _sharded_step_factor: the corrected variant's min
        over the real nodes of every rank (all_reduce MIN)."""
        prim = tops.t_primitives(q)
        lvl = sh.dev
        if self.legacy:
            return 0.5 / (torch.sqrt(lvl.volumes)
                          * (prim["speed"] + prim["sos"]))
        dt = 0.5 * lvl.cbrt_volumes / (prim["speed"] + prim["sos"])
        dt = torch.where(sh.c["node_mask"] > 0, dt,
                         torch.full_like(dt, float("inf")))
        return self.comm.all_reduce(torch.min(dt), "min") / lvl.volumes

    def _flux(self, sh: ShardLevel, q):
        """Internal + boundary + wall flux of the block, (5, B)."""
        lvl, c = sh.dev, sh.c
        bw = tops.t_dense_boundary_wall_flux(q, lvl.nc[0:3], lvl.nc[3:6],
                                             lvl.nc[6:11])
        if self._kernels:
            return edge_csr.flux(lvl.csr, self._exchange(sh, q), q) + bw
        comb = self._exchange(sh, q).T
        val = internal_edge_flux(comb[lvl.edge_a], comb[lvl.edge_b],
                                 lvl.edge_w)
        seg = torch.zeros((sh.B + sh.pool, NVAR), dtype=q.dtype,
                          device=q.device).index_add_(
            0, torch.cat([lvl.edge_a, lvl.edge_b]), torch.cat([val, -val]))
        flux = seg[:sh.B].T
        if sh.deltas:
            flux = flux + tops.t_shift_flux_rolled(sh.deltas,
                                                   c["shift_wpad"], q)
        flux = flux + bw
        return flux.index_add(1, c["sep_idx"],
                              self._pool_return(sh, seg[sh.B:]).T)

    def _indirect_rw(self, sh: ShardLevel, q) -> None:
        """The rw twin of _flux with the same halo traffic; its result is
        discarded."""
        lvl = sh.dev
        if self._kernels:
            edge_csr.rw(lvl.csr, self._exchange(sh, q), q)
            return
        comb = self._exchange(sh, q).T
        va, vb = indirect_rw_edge_values(comb[lvl.edge_a], comb[lvl.edge_b],
                                         lvl.edge_w)
        seg = torch.zeros((sh.B + sh.pool, NVAR), dtype=q.dtype,
                          device=q.device).index_add_(
            0, torch.cat([lvl.edge_a, lvl.edge_b]), torch.cat([va, vb]))
        self._pool_return(sh, seg[sh.B:])
        if sh.deltas:
            tops.t_shift_rw_rolled(sh.deltas, sh.c["shift_wpad"], q)

    def _visit_sharded(self, i: int, q):
        """One smoothing pass of sharded level i on a (5, B) block:
        (q, residual, this rank's invalid count)."""
        sh = self.shards[i]
        old = q
        with kscope("compute_step", i):
            sf = self._step_factor(sh, q)
        with kscope("invalid_count", i):
            invalid = torch.zeros((), dtype=torch.int64, device=q.device)
        for j in range(RK):
            if self.config.flux_cripple:
                # the crippled twin over the owned edge stream, discarded
                # (outside every kscope, as in MGCFDSolver)
                comb = self._exchange(sh, q).T
                internal_edge_flux_crippled(comb[sh.dev.edge_a],
                                            comb[sh.dev.edge_b],
                                            sh.dev.edge_w)
            with kscope("flux", i):
                flux = self._flux(sh, q)
            with kscope("time_step", i):
                q = tops.t_time_step(j, sf, flux, old)
            with kscope("invalid_count", i):
                invalid = invalid + invalid_count(q)
            if self.config.include_indirect_rw:
                with kscope("indirect_rw", i):
                    self._indirect_rw(sh, q)
        with kscope("residual", i):
            return q, q - old, invalid

    # --- transfers across a sharded level ----------------------------------

    def _restrict(self, i: int, vars_f, vars_c):
        """Level i onto level i + 1; from a sharded level onto a sharded
        or a replicated one here."""
        if i >= self.S:
            return super()._restrict(i, vars_f, vars_c)
        sh = self.shards[i]
        mapped = sh.dev.restrict_mapped
        if i + 1 < self.S:                    # onto a sharded level
            Bc = vars_c.shape[1]
            if self._kernels:
                part = edge_csr.restrict(sh.dev.restrict_csr, vars_f)
                mean = self.comm.reduce_scatter(
                    part.reshape(NVAR, self.P, Bc).permute(1, 0, 2))
            else:
                partial = torch.zeros(
                    (self.P * Bc + 1, NVAR), dtype=vars_f.dtype,
                    device=vars_f.device).index_add_(
                    0, sh.c["mgp_pad"], vars_f.T)[:self.P * Bc]
                sums = self.comm.reduce_scatter(
                    partial.reshape(self.P, Bc, NVAR))
                counts = sh.c["mgc_counts"]
                safe = torch.where(mapped, counts, torch.ones_like(counts))
                mean = (sums / safe[:, None]).T
            return torch.where(mapped[None], mean, vars_c).contiguous()
        if self._kernels:
            mean = self.comm.all_reduce(
                edge_csr.restrict(sh.dev.restrict_csr, vars_f))  # (5, Nc)
        else:
            counts = sh.c["mg_counts"]
            nc = counts.shape[0]
            partial = torch.zeros(
                (nc + 1, NVAR), dtype=vars_f.dtype,
                device=vars_f.device).index_add_(
                0, sh.dev.mg_mapping, vars_f.T)[:nc]
            sums = self.comm.all_reduce(partial)
            safe = torch.where(mapped, counts, torch.ones_like(counts))
            mean = (sums / safe[:, None]).T
        if self._tstate:
            return torch.where(mapped[None], mean, vars_c).contiguous()
        return torch.where(mapped[:, None], mean.T, vars_c).contiguous()

    def _prolong(self, i: int, res_c, res_f, vars_f):
        """vars_f += res_f - the interpolated coarse residual, level i from
        level i + 1's residuals; on a sharded level here, where on the
        kernel paths the wsum kernel's store makes the update (its
        epilogue)."""
        if i >= self.S:
            return super()._prolong(i, res_c, res_f, vars_f)
        sh = self.shards[i]
        if i + 1 < self.S:       # the coarse blocks, gathered, in raw order
            allb = self.comm.all_gather(res_c)                # (P, 5, Bc)
            res_c = allb.permute(1, 0, 2).reshape(NVAR, -1)[
                :, sh.c["c_raw2pad"]]
            varmajor = True
        else:
            varmajor = self._tstate
        if self._kernels:
            rc = res_c if varmajor else res_c.T
            return edge_csr.prolong(sh.dev.prolong_csr, rc.contiguous(),
                                    correct=(vars_f, res_f))
        c = sh.c
        rc = res_c.T if varmajor else res_c                   # (Nc, 5)
        r_a1, r_b1 = rc[c["pro_a1"]], rc[c["pro_b1"]]
        la, lb = c["pro_live_a"], c["pro_live_b"]
        val_a = la[:, None] * (c["pro_id_a1a2"][:, None] * r_a1
                               + c["pro_id_b1a2"][:, None] * r_b1)
        w_a = la * (c["pro_id_a1a2"] + c["pro_id_b1a2"])
        # the reference's quirk: a1 -> b2 takes b1's residual
        val_b = lb[:, None] * ((c["pro_id_b1b2"]
                                + c["pro_id_a1b2"])[:, None] * r_b1)
        w_b = lb * (c["pro_id_b1b2"] + c["pro_id_a1b2"])
        dest = torch.cat([c["pro_dest_a"], c["pro_dest_b"]])
        n = sh.B + sh.pool
        acc = torch.zeros((n, NVAR), dtype=rc.dtype, device=rc.device)
        acc.index_add_(0, dest, torch.cat([val_a, val_b]))
        ws = torch.zeros(n, dtype=rc.dtype, device=rc.device)
        ws.index_add_(0, dest, torch.cat([w_a, w_b]))
        acc_l = acc[:sh.B].index_add(0, c["sep_idx"],
                                     self._pool_return(sh, acc[sh.B:]))
        ws_l = ws[:sh.B].index_add(0, c["sep_idx"],
                                   self._pool_return(sh, ws[sh.B:]))
        safe = torch.where(ws_l > 0, ws_l, torch.ones_like(ws_l))
        wavg = torch.where(c["coincident"][:, None], rc[c["parent"]],
                           acc_l / safe[:, None])
        return (vars_f + (res_f - wavg.T)).contiguous()

    # --- the cycle: MGCFDSolver.cycle over these levels ---------------------

    def _new_cycle_count(self):
        """(this rank's block levels' invalid count, the replicated
        levels' one): only the first is summed over the ranks."""
        with kscope("invalid_count", 0):
            blocks = torch.zeros((), dtype=torch.int64, device=self.device)
        return blocks, super()._new_cycle_count()

    def _invalid_total(self, count):
        """The invalid count over all ranks."""
        blocks, replicated = count
        with kscope("invalid_count", 0):
            return self.comm.all_reduce(blocks) + replicated

    def _visit_level(self, lev: int, q, count):
        """A sharded level through _visit_sharded, its count into the
        block levels' counter; a replicated one as MGCFDSolver's."""
        if lev >= self.S:
            return super()._visit_level(lev, q, count[1])
        q, res, n_bad = self._visit_sharded(lev, q)
        with kscope("invalid_count", lev):
            count[0].add_(n_bad)
        return q, res

    def _rms(self, res):
        """The RMS of level 0's residual over the real nodes of every
        rank."""
        with kscope("rms", 0):
            sq = torch.sum(res * res * self.shards[0].c["node_mask"][None])
            return torch.sqrt(self.comm.all_reduce(sq)
                              / self.shards[0].host.num_nodes)

    def run(self, cycles: int | None = None, verbose: bool = False):
        """MGCFDSolver.run over the ranks: rank 0 prints and writes the
        checkpoints."""
        return super().run(cycles, verbose and self.rank == 0)

    def run_batched(self, cycles: int, cycles_per_dispatch: int = 10,
                    verbose: bool = False):
        """K cycles a batch (MGCFDSolver.run_batched): one CUDA graph of K
        cycles under NCCL, the eager loop under gloo (module docstring)."""
        return super().run_batched(cycles, cycles_per_dispatch,
                                   verbose and self.rank == 0)

    def _save_checkpoint(self) -> None:
        st = self._state_node_major()            # every rank gathers
        if self.rank == 0:
            from ..utils.checkpoint import save_checkpoint
            save_checkpoint(self.config.checkpoint_dir, self.mesh, st,
                            self.completed_cycles, self.rms_history)
        dist.barrier()

    # --- the state, node-major in the caller's order -----------------------

    def _level_node_major(self, t, level: int) -> torch.Tensor:
        """One level's (N, 5) state on the CPU in the caller's order (a
        collective for a sharded level)."""
        if level < self.S:
            sh = self.shards[level]
            blocks = self.comm.all_gather(t).permute(0, 2, 1).cpu()
            out = torch.cat([blocks[p, :hi - lo] for p, (lo, hi) in
                             enumerate(map(sh.host.bounds, range(self.P)))])
        else:
            out = (t.T if self._tstate else t).cpu()
        if self.part_invs is not None:
            out = out[torch.as_tensor(self.part_invs[level])]
        return out

    def _state_node_major(self) -> dict:
        def host(t, lev):
            t = self._level_node_major(t, lev)
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return {k: [host(t, lev) for lev, t in enumerate(v)]
                for k, v in self.state.items()}

    def load_state(self, state: dict) -> None:
        """Install a node-major state in the caller's order ({'variables':
        [...], 'residuals': [...]} per level); each rank takes its
        blocks."""
        new = {}
        for key in ("variables", "residuals"):
            out = []
            for lev, a in enumerate(state[key]):
                a = a.detach().to("cpu", torch.float64).numpy() \
                    if isinstance(a, torch.Tensor) else \
                    np.asarray(a, np.float64)
                if self.part_orders is not None:
                    a = a[self.part_orders[lev]]
                if lev < self.S:
                    sh = self.shards[lev]
                    lo, hi = sh.host.bounds(self.rank)
                    blk = self.state[key][lev].T.to(
                        "cpu", torch.float64).numpy().copy()
                    blk[:hi - lo] = a[lo:hi]
                    out.append(self._block(blk))
                else:
                    out.append(self._coarse(a))
            new[key] = out
        self.state = new

    def variables(self, level: int = 0) -> np.ndarray:
        """(N, 5) variables of one level in the caller's order, float64
        numpy; a collective on a sharded level."""
        return self._level_node_major(self.state["variables"][level],
                                      level).to(torch.float64).numpy()

    def step_factors(self, level: int = 0) -> np.ndarray:
        """(N,) step factors of the current state (the dump's), from the
        gathered level on the host; a collective on a sharded level."""
        v = torch.as_tensor(self.variables(level)).to(self.dtype)
        vol = torch.as_tensor(self.mesh.levels[level].volumes).to(self.dtype)
        sf = compute_step_factor_legacy(v, vol) if self.legacy else \
            compute_step_factor(v, vol)
        return sf.to(torch.float64).numpy()


def _dryrun_rank(rank: int) -> None:
    from ..bench.flagship import FlagshipSpec, flagship_mesh
    n = dist.get_world_size()
    solver = ShardedSolver(
        flagship_mesh(FlagshipSpec(nx=8, ny=8, nz=8, num_levels=3)),
        SolverConfig(dtype="float32", num_partitions=n,
                     include_indirect_rw=False), device="cpu")
    solver.run(1)
    solver_w = ShardedSolver(
        flagship_mesh(FlagshipSpec(nx=16, ny=12, nz=12, num_levels=3)),
        SolverConfig(dtype="float32", num_partitions=n,
                     accumulate="window", include_indirect_rw=True,
                     shard_levels=2), device="cpu")
    solver_w.run(1)
    rms, rms_w = solver.rms_history[-1], solver_w.rms_history[-1]
    if len(solver_w.smesh.levels) != 2 or not (
            np.isfinite(rms) and np.isfinite(rms_w)):
        raise RuntimeError(f"dryrun({n}): rms {rms}, window rms {rms_w}, "
                           f"{len(solver_w.smesh.levels)} sharded levels")
    if rank == 0:
        print(f"dryrun({n}): ok, rms={rms:.3e}, window rms={rms_w:.3e}",
              flush=True)


def dryrun(n: int) -> None:
    """mgcfd_tpu's dryrun over n gloo ranks on the CPU: one cycle on an 8^3
    box of 3 levels ('auto', which is 'segment' on the CPU), then one of
    accumulate='window' with shard_levels=2 on a 16x12x12 box, wide
    enough that every shard has cross-shard half-edges; each RMS must be
    finite. Raises if a rank fails.

        python -c "from mgcfd_tpu_torch.parallel import dryrun; dryrun(2)"
    """
    from .launch import run_ranks, stop_servers
    try:
        run_ranks(_dryrun_rank, n, device_type="cpu")
    finally:
        stop_servers()
