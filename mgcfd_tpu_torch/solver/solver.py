"""Single-device multigrid Euler solver.

Control flow of mgcfd_tpu.solver.solver (reference main loop
euler3d_cpu_double.cpp:371-694): per level visit, copy the old state,
compute the step factor, run 3 RK stages (internal + boundary + wall
flux, time step, invalid count, then the indirect_rw twin), and form the
residual; per cycle visit levels 0..L-1 on the way up, restricting after
each, then prolong/visit pairs down to level 1 (level 0 is visited at the
start of the next cycle). `run` runs it eagerly, and the host reads one
RMS and one invalid count per cycle; `run_batched` runs K cycles per
batch, on CUDA as one replay of a CUDA graph that captured them
(CycleGraph), and reads the K RMS values and invalid counts once.

Paths, chosen by SolverConfig.accumulate:
  'segment'  node-major (N, 5) state, plain edge-stream ops (index_add_)
             — the CPU path and the card's plain reference; 'scatter'
             (chained index_add_) and 'ell' (incidence-table gathers,
             prep/incidence.py) accumulate the same values otherwise;
  'window'   variable-major (5, N) state through the CUDA kernels over
             owner-sorted CSR plans (fused RK stage, rw twin, restriction
             and composed prolongation); on the CPU the same wrappers run
             their plain versions. With fuse_window_stage=False each
             stage is the edge_csr flux kernel over the owner CSR, plus
             boundary/wall, then the time step and the invalid count;
  'pallas'   variable-major state through the span kernels of box-class
             meshes (prep/shift.py): one fused RK stage per launch (or,
             with fuse_stage=False, the span flux kernel and separate
             boundary/wall, time step and invalid count), the span rw
             twin, and the CSR kernels for the MG transfers and for the
             edges the span plan leaves over (spill);
  'shift'    the span decomposition in plain PyTorch: node-major per-span
             slices, or with transposed=True the variable-major rolled
             evaluation.

The reference's kernel variants: flux_cripple runs the crippled flux
twin before each RK stage's flux on every path and discards it (outside
every kscope, where mgcfd_tpu runs it outside every named scope);
flux_fission splits a node-major stage's flux into the per-edge values
(kscope flux) and their accumulation (kscope update);
flux_precompute_edge_weights hands the edge-stream paths |w| taken in
float64 on the host. With mg_gather=False the kernel paths restrict and
prolong through the plain scatter formulation, as mgcfd_tpu does with
its gather tables off. `run` writes a checkpoint (utils/checkpoint.py)
every checkpoint_every cycles, and the solver resumes from the latest
one when asked (resume); run_batched writes none, as in mgcfd_tpu.

The functions of one solver step (compute_step, flux, update, time_step,
indirect_rw, restrict, prolong) each run inside kscope(function, level).
The instrumented solver (monitor/instrument.py) runs this same cycle with
the fused stages off and times each function there (timed_calls). While a
measurement has switched them on (measured_ranges), each runs inside a
torch.profiler range k_<function>_l<level>, which monitor/opstats.py
charges device time to, and so does the cycle's bookkeeping
(invalid_count, residual, and rms on level 0, run's host reads of them
included), which the reference times under no kernel; switched off, as
always outside a measurement, no range is entered.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.config import SolverConfig
from ..core.constants import NVAR, RK, MeshVariant, far_field_state
from ..core.types import MultigridMesh
from .. import kernels
from ..kernels import DeviceCSR, DeviceShift, edge_csr, shift
from ..kernels.fused_stage import fused_stage, invalid_count
from ..kernels.step_factor import StepScratch
from ..mesh.build import apply_ewt_conditioning
from ..ops import (accumulate_flux, boundary_edge_flux, calc_rms,
                   cbrt_volumes, compute_step_factor,
                   compute_step_factor_legacy,
                   indirect_rw_edge_values, internal_edge_flux,
                   internal_edge_flux_crippled,
                   invalid_variables_count, mg_restrict,
                   prolong_residuals_interpolate, residual, time_step,
                   wall_edge_flux)
from ..ops import tops
from ..prep.csr import build_edge_csr, build_flux_csr, build_prolong_csr, \
    build_restrict_csr
from ..prep.incidence import DeviceIncidence, build_incidence, \
    ell_accumulate
from ..prep.plancache import cached_plan
from ..prep.shift import build_shift_plan, shift_flux
from ..utils import spans
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, \
    save_checkpoint

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class DeviceLevel:
    num_nodes: int
    volumes: torch.Tensor
    cbrt_volumes: torch.Tensor     # cbrt(V), taken once (step factor)
    coords: Optional[torch.Tensor]
    edge_a: torch.Tensor           # int64
    edge_b: torch.Tensor
    edge_w: torch.Tensor
    bedge_b: torch.Tensor
    bedge_w: torch.Tensor
    wedge_b: torch.Tensor
    wedge_w: torch.Tensor
    mg_mapping: Optional[torch.Tensor]
    # flux_precompute_edge_weights: |edge_w| (the edge-stream paths)
    edge_ewt: Optional[torch.Tensor] = None
    ell: Optional[DeviceIncidence] = None  # accumulate='ell'
    # accumulate='window'
    csr: Optional[DeviceCSR] = None        # flux plan of this level
    # accumulate='window', 'pallas', transposed 'shift'
    nc: Optional[torch.Tensor] = None      # (11, N) boundary/wall consts
    step: Optional[StepScratch] = None     # the step factor kernel's (CUDA)
    # accumulate='pallas', 'shift': the span plan and its spill edges
    shift: Optional[DeviceShift] = None
    spill_csr: Optional[DeviceCSR] = None  # 'pallas'; None if no spill
    spill: Optional[tuple] = None          # 'shift': (a, b, w) tensors
    # MG transfers through the kernels ('window', 'pallas')
    restrict_csr: Optional[DeviceCSR] = None   # this level -> next
    # the sharded solver's block levels: the coarse nodes with a child
    restrict_mapped: Optional[torch.Tensor] = None
    prolong_csr: Optional[DeviceCSR] = None    # next level -> this


@dataclasses.dataclass
class DeviceMesh:
    levels: list
    variant: MeshVariant
    ff_flux: torch.Tensor           # (3, 5)


def resolve_device(device=None) -> torch.device:
    """None means the card: raise if CUDA is absent rather than fall back
    to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "MGCFDSolver runs on CUDA unless asked otherwise and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return device


SHIFT_COVERAGE = 0.995   # auto takes the span kernels at this coverage


def resolve_accumulate(mesh: MultigridMesh, config: SolverConfig,
                       device: torch.device):
    """accumulate='auto' -> 'segment' with flux_fission (the one
    fission-structured target, as in mgcfd_tpu) or on the CPU; on CUDA
    'pallas' when every level's shift plan covers >= SHIFT_COVERAGE of
    its edges (box-class meshes), else 'window', at fp32 and fp64 alike
    (the H100 runs fp64 natively). Explicit modes are never overridden.
    Mutates config in place. Returns the levels' shift plans when it
    built them, else None, so that the caller need not build them again.
    bfloat16 resolves as float32 does: on the card the kernels keep it as
    a storage format, as JAX's do on the TPU."""
    if config.accumulate != "auto":
        return None
    if config.flux_fission or device.type != "cuda":
        config.accumulate = "segment"
        return None
    plans = [shift_plan(lv, config.plan_cache_dir) for lv in mesh.levels]
    cov = min(p.coverage for p in plans)
    config.accumulate = "pallas" if cov >= SHIFT_COVERAGE else "window"
    return plans


def shift_plan(lvl, cache_dir: str):
    """The level's span plan, through the plan cache when it has a
    directory."""
    return cached_plan(
        cache_dir, "torch-shift",
        (lvl.edge_a, lvl.edge_b, lvl.edge_w, np.asarray([lvl.num_nodes])),
        lambda: build_shift_plan(lvl))


def variable_major(config: SolverConfig) -> bool:
    """Whether the path keeps the state as (5, N)."""
    return (config.accumulate in ("window", "pallas")
            or (config.accumulate == "shift" and config.transposed))


def upload(make):
    """make(), a host -> device copy and cast, inside an mgcfd.upload
    span; the bytes of the tensors it returns (a tensor, or a dataclass
    of them) are added to the upload.bytes counter."""
    with spans.span("mgcfd.upload"):
        out = make()
    fields = [out] if isinstance(out, torch.Tensor) else vars(out).values()
    spans.count("upload.bytes", sum(t.nbytes for t in fields
                                    if isinstance(t, torch.Tensor)))
    return out


def prepare_device_mesh(mesh: MultigridMesh, config: SolverConfig,
                        device: torch.device) -> DeviceMesh:
    """Condition the edge weights per mesh variant (euler3d:333-352) on
    copies, cast to the configured dtype, upload, and build the plans and
    boundary/wall constants of the chosen path, each plan through the
    plan cache (config.plan_cache_dir). Every float64 host array is cast
    as mgcfd_tpu casts it (torch rounds float64 -> bfloat16 through
    float32, as jnp.asarray and ml_dtypes do)."""
    dtype = DTYPES[config.dtype]
    with spans.span("mgcfd.prepare.condition"):
        levels = [dataclasses.replace(lv, edge_w=lv.edge_w.copy(),
                                      bedge_w=lv.bedge_w.copy(),
                                      wedge_w=lv.wedge_w.copy())
                  for lv in mesh.levels]
        apply_ewt_conditioning(levels, mesh.variant)
    # the plans' spans and spill edges do not depend on the weights, so
    # plans built on the conditioned levels decide `auto` too
    plans = resolve_accumulate(dataclasses.replace(mesh, levels=levels),
                               config, device)
    mode = config.accumulate
    cache = config.plan_cache_dir
    if mode in ("pallas", "shift") and plans is None:
        plans = [shift_plan(lv, cache) for lv in levels]
    ff_flux = far_field_state(np.float64)[1]

    def put(x, dt=dtype):
        return upload(lambda: torch.as_tensor(np.asarray(x)).to(
            device=device, dtype=dt))

    dlevels = []
    for li, lv in enumerate(levels):
        volumes = put(lv.volumes)
        d = DeviceLevel(
            num_nodes=lv.num_nodes, volumes=volumes,
            cbrt_volumes=cbrt_volumes(volumes),
            coords=None if lv.coords is None else put(lv.coords),
            edge_a=put(lv.edge_a, torch.int64),
            edge_b=put(lv.edge_b, torch.int64), edge_w=put(lv.edge_w),
            bedge_b=put(lv.bedge_b, torch.int64), bedge_w=put(lv.bedge_w),
            wedge_b=put(lv.wedge_b, torch.int64), wedge_w=put(lv.wedge_w),
            mg_mapping=None if lv.mg_mapping is None
            else put(lv.mg_mapping, torch.int64))
        if config.flux_precompute_edge_weights:
            d.edge_ewt = put(np.sqrt((lv.edge_w ** 2).sum(axis=1)))
        if mode == "ell":
            tables = build_incidence(lv)
            d.ell = upload(lambda: DeviceIncidence.from_tables(
                tables, device, dtype))
        if mode == "window":
            csr = cached_plan(
                cache, "torch-flux", (lv.edge_a, lv.edge_b, lv.edge_w,
                                      np.asarray([lv.num_nodes])),
                lambda lv=lv: build_flux_csr(lv))
            d.csr = upload(lambda: DeviceCSR.from_plan(csr, device, dtype))
        if mode in ("pallas", "shift"):
            plan = plans[li]
            d.shift = upload(lambda: DeviceShift.from_plan(
                plan, lv.num_nodes, device, dtype))
            if mode == "shift":
                d.spill = (put(plan.spill_a, torch.int64),
                           put(plan.spill_b, torch.int64),
                           put(plan.spill_w))
            elif plan.spill_a.shape[0]:
                spill = cached_plan(
                    cache, "torch-spill",
                    (plan.spill_a, plan.spill_b, plan.spill_w,
                     np.asarray([lv.num_nodes])),
                    lambda lv=lv, p=plan: build_edge_csr(
                        lv.num_nodes, p.spill_a, p.spill_b, p.spill_w))
                d.spill_csr = upload(lambda: DeviceCSR.from_plan(
                    spill, device, dtype))
        if variable_major(config):
            bdn, wln, wlc = tops.build_dense_boundary_wall(
                lv.num_nodes, lv.bedge_b, lv.bedge_w, lv.wedge_b,
                lv.wedge_w, ff_flux)
            d.nc = put(np.concatenate([bdn, wln, wlc], axis=0))
            if device.type == "cuda":
                d.step = StepScratch(lv.num_nodes, dtype, device)
        dlevels.append(d)
    if mode in ("window", "pallas") and config.mg_gather:
        for i in range(len(levels) - 1):
            fine, coarse = levels[i], levels[i + 1]
            sizes = np.asarray([fine.num_nodes, coarse.num_nodes])
            # its `mapped` mask is the CSR's rows with entries, which the
            # kernel's store reads (apply_restrict)
            plan, _ = cached_plan(
                cache, "torch-restrict", (fine.mg_mapping, sizes),
                lambda f=fine, c=coarse: build_restrict_csr(
                    f.mg_mapping, f.num_nodes, c.num_nodes))
            dlevels[i].restrict_csr = upload(lambda: DeviceCSR.from_plan(
                plan, device, dtype))
            prolong = cached_plan(
                cache, "torch-prolong",
                (fine.edge_a, fine.edge_b, fine.coords, coarse.coords,
                 fine.mg_mapping, sizes),
                lambda f=fine, c=coarse: build_prolong_csr(f, c))
            dlevels[i].prolong_csr = upload(lambda: DeviceCSR.from_plan(
                prolong, device, dtype))
    return DeviceMesh(levels=dlevels, variant=mesh.variant,
                      ff_flux=put(ff_flux))


# ---------------------------------------------------------------------------
# the measurement's ranges (mgcfd_tpu's _kscope)
# ---------------------------------------------------------------------------

_ranges_on = False
# while timed_calls is on: (function, level, range) -> the context that
# times the call (monitor/instrument.py's InstrumentedSolver)
_timer = None


@contextlib.contextmanager
def measured_ranges():
    """Switch the k_<function>_l<level> ranges on inside the block
    (monitor/opstats.py), for MGCFDSolver's cycle and the instrumented
    solver's calls. A module-level switch: the ranges cost host time, so
    run and the CUDA graph's capture enter them only while a measurement
    asks."""
    global _ranges_on
    _ranges_on = True
    try:
        yield
    finally:
        _ranges_on = False


@contextlib.contextmanager
def timed_calls(timer):
    """Inside the block every kscope is also timed by `timer` (the
    instrumented solver's), which is given the function, the level and
    the range to enter."""
    global _timer
    _timer = timer
    try:
        yield
    finally:
        _timer = None


def kscope(function: str, level: int):
    """The range k_<function>_l<level> while measured_ranges is on, else
    a context that does nothing; inside timed_calls, wrapped in its
    timer."""
    rng = (spans.profiler_range(f"k_{function}_l{level}") if _ranges_on
           else spans.OFF)
    return rng if _timer is None else _timer(function, level, rng)


# ---------------------------------------------------------------------------
# one level, node-major paths ('segment', 'shift')
# ---------------------------------------------------------------------------

def _flux_values(lvl: DeviceLevel, variables, ff_flux):
    """Per-edge values (internal, boundary, wall) of the edge stream; the
    internal ones with the precomputed |w| where the level has it."""
    val_bd = boundary_edge_flux(variables[lvl.bedge_b], lvl.bedge_w)
    val_w = wall_edge_flux(variables[lvl.wedge_b], lvl.wedge_w, ff_flux)
    val_i = internal_edge_flux(variables[lvl.edge_a], variables[lvl.edge_b],
                               lvl.edge_w, lvl.edge_ewt)
    return val_i, val_bd, val_w


def _accumulate(lvl: DeviceLevel, vals, mode: str):
    """The per-edge values into (N, 5): the incidence tables' gathers
    ('ell'), chained index_add_ ('scatter') or one index_add_."""
    val_i, val_bd, val_w = vals
    if mode == "ell":
        return ell_accumulate(lvl.ell, val_i, val_bd, val_w)
    return accumulate_flux(lvl.num_nodes, lvl.edge_a, lvl.edge_b, val_i,
                           lvl.bedge_b, val_bd, lvl.wedge_b, val_w,
                           mode="scatter" if mode == "scatter"
                           else "segment")


def _compute_fluxes(lvl: DeviceLevel, variables, ff_flux, mode: str):
    """Internal + boundary + wall flux: the edge stream's values and their
    accumulation, or on the 'shift' path the per-span slices plus the
    boundary and wall edges summed apart and then added (the order of
    mgcfd_tpu)."""
    if lvl.shift is None:
        return _accumulate(lvl, _flux_values(lvl, variables, ff_flux), mode)
    val_bd = boundary_edge_flux(variables[lvl.bedge_b], lvl.bedge_w)
    val_w = wall_edge_flux(variables[lvl.wedge_b], lvl.wedge_w, ff_flux)
    n = lvl.num_nodes
    sh = lvl.shift
    weights = [sh.w[k, :3, :n - d].T for k, d in enumerate(sh.deltas)]
    flux = shift_flux(sh.deltas, weights, lvl.spill, variables,
                      internal_edge_flux, n)
    bw = torch.zeros_like(flux).index_add_(
        0, torch.cat([lvl.bedge_b, lvl.wedge_b]), torch.cat([val_bd, val_w]))
    return flux + bw


def _crippled_twin(lvl: DeviceLevel, variables) -> None:
    """FLUX_CRIPPLE (euler3d_cpu_double.cpp:399-418): the crippled flux
    over every internal edge of a node-major (N, 5) state or view, its
    result discarded. It runs outside every kscope, as mgcfd_tpu runs it
    outside every named scope."""
    internal_edge_flux_crippled(variables[lvl.edge_a],
                                variables[lvl.edge_b], lvl.edge_w)


def _indirect_rw(lvl: DeviceLevel, variables):
    """The data-movement twin (indirect_rw_loop.cpp); its result is
    discarded, as the reference's zero_fluxes discards it."""
    val_a, val_b = indirect_rw_edge_values(
        variables[lvl.edge_a], variables[lvl.edge_b], lvl.edge_w)
    return accumulate_flux(lvl.num_nodes, lvl.edge_a, lvl.edge_b, val_a,
                           val_internal_b=val_b)


def step_factor(lvl: DeviceLevel, variables, legacy_step: bool):
    """Step factor of an (N, 5) state (cfd_loops.cpp:13-157)."""
    if legacy_step:
        return compute_step_factor_legacy(variables, lvl.volumes)
    return compute_step_factor(variables, lvl.volumes, lvl.cbrt_volumes)


def _visit(lvl: DeviceLevel, variables, ff_flux, config: SolverConfig,
           legacy_step: bool, tag: int):
    """One smoothing pass (euler3d_cpu_double.cpp:383-512): returns
    (variables, residuals, invalid_count). tag: the level, for kscope."""
    old = variables
    with kscope("compute_step", tag):
        sf = step_factor(lvl, variables, legacy_step)
    with kscope("invalid_count", tag):
        invalid = torch.zeros((), dtype=torch.int64, device=variables.device)
    for j in range(RK):
        if config.flux_cripple:
            _crippled_twin(lvl, variables)
        if config.flux_fission:
            with kscope("flux", tag):
                vals = _flux_values(lvl, variables, ff_flux)
            with kscope("update", tag):
                fluxes = _accumulate(lvl, vals, config.accumulate)
        else:
            with kscope("flux", tag):
                fluxes = _compute_fluxes(lvl, variables, ff_flux,
                                         config.accumulate)
        with kscope("time_step", tag):
            variables = time_step(j, sf, fluxes, old)
        with kscope("invalid_count", tag):
            invalid = invalid + invalid_variables_count(variables)
        if config.include_indirect_rw:
            with kscope("indirect_rw", tag):
                _indirect_rw(lvl, variables)
    with kscope("residual", tag):
        return variables, residual(old, variables), invalid


# ---------------------------------------------------------------------------
# one level, variable-major paths ('window', 'pallas', transposed 'shift')
# ---------------------------------------------------------------------------

def t_stage_factors(lvl: DeviceLevel, q, legacy_step: bool):
    """The RK stages' factors (RK, N) of a (5, N) state: the step_factor
    kernel's on the card (the level's scratch), its plain version on the
    CPU."""
    return kernels.step_factor.step_factor(q, lvl.volumes, lvl.cbrt_volumes,
                                           legacy_step, lvl.step)


def _new_count(tag: int, device):
    """A visit's invalid count where its caller keeps none: an int64
    zero."""
    with kscope("invalid_count", tag):
        return torch.zeros((), dtype=torch.int64, device=device)


def _visit_window(lvl: DeviceLevel, q, config: SolverConfig,
                  legacy_step: bool, tag: int, count=None):
    """The kernel-path smoothing pass on a (5, N) state: ONE fused_stage
    launch per RK stage covers flux, boundary/wall, time step and invalid
    count (its device time lands on the flux range, as in mgcfd_tpu), and
    the last stage's launch also stores the residual (its epilogue); the
    step factor stays outside (its global min is a cross-block
    reduction): one step_factor call gives every stage's factor. With
    fuse_window_stage=False each stage is t_compute_fluxes, the time step
    and the invalid count instead (mgcfd_tpu's _visit_transposed), and the
    residual an eager q - old. The rw twin's kernel runs after each stage
    and its result is discarded. The invalid count is added into count,
    an int64 counter (the cycle's; a new one where it is None): by the
    fused stages' kernels, else eagerly. Returns (q, residual, count)."""
    fused = config.fuse_window_stage is not False
    old = q
    with kscope("compute_step", tag):
        fac = t_stage_factors(lvl, q, legacy_step)
    if count is None:
        count = _new_count(tag, q.device)
    for j in range(RK):
        if config.flux_cripple:
            _crippled_twin(lvl, q.T)
        if fused:
            with kscope("flux", tag):
                out = fused_stage(lvl.csr, lvl.nc, q, old, fac[j], count,
                                  residual=j == RK - 1)
            q = out[0]
        else:
            with kscope("flux", tag):
                flux = t_compute_fluxes(lvl, q, config)
            with kscope("time_step", tag):
                q = old + fac[j][None] * flux
            with kscope("invalid_count", tag):
                count.add_(invalid_count(q))
        if config.include_indirect_rw:
            with kscope("indirect_rw", tag):
                t_indirect_rw(lvl, q, config)
    if fused:
        return q, out[2], count
    with kscope("residual", tag):
        return q, q - old, count


def t_compute_fluxes(lvl: DeviceLevel, q, config: SolverConfig):
    """Internal + boundary + wall flux of a (5, N) state (mgcfd_tpu's
    t_compute_fluxes): the edge_csr flux kernel over the level's owner CSR
    ('window'), or the span flux and its spill edges ('pallas', transposed
    'shift'), plus the dense boundary/wall flux. Shared by the solver's
    unfused stages and the instrumented solver."""
    if config.accumulate == "window":
        flux = edge_csr.flux(lvl.csr, q)
    else:
        flux = _span_flux(lvl, q, config.accumulate == "pallas")
    return flux + tops.t_dense_boundary_wall_flux(
        q, lvl.nc[0:3], lvl.nc[3:6], lvl.nc[6:11])


def t_indirect_rw(lvl: DeviceLevel, q, config: SolverConfig) -> None:
    """The indirect_rw twin of t_compute_fluxes (mgcfd_tpu's
    t_indirect_rw); its result is discarded."""
    if config.accumulate == "window":
        edge_csr.rw(lvl.csr, q)
    else:
        _span_rw(lvl, q, config.accumulate == "pallas")


def _span_flux(lvl: DeviceLevel, q, kernels: bool):
    """Internal flux over the spans plus the spill edges, (5, N): through
    the kernels ('pallas'), or the rolled plain evaluation and a segment
    sum of the spill edges (transposed 'shift')."""
    sh = lvl.shift
    if kernels:
        flux = shift.flux(sh, q)
        if lvl.spill_csr is not None:
            flux = flux + edge_csr.flux(lvl.spill_csr, q)
        return flux
    flux = (tops.t_shift_flux_rolled(sh.deltas, sh.w, q) if sh.deltas
            else torch.zeros_like(q))
    sa, sb, sw = lvl.spill
    if sa.shape[0]:
        val = tops.t_internal_edge_flux(q[:, sa], q[:, sb], sw.T)
        flux = flux + tops.t_segment_accumulate(
            torch.cat([val, -val], dim=1), torch.cat([sa, sb]),
            q.shape[1])
    return flux


def _span_rw(lvl: DeviceLevel, q, kernels: bool):
    """The indirect_rw twin of _span_flux; its result is discarded."""
    sh = lvl.shift
    if kernels:
        shift.rw(sh, q)
        if lvl.spill_csr is not None:
            edge_csr.rw(lvl.spill_csr, q)
        return
    if sh.deltas:
        tops.t_shift_rw_rolled(sh.deltas, sh.w, q)
    sa, sb, sw = lvl.spill
    if sa.shape[0]:
        valr = q[:, sa] + q[:, sb] + torch.sum(sw.T, dim=0)[None]
        tops.t_segment_accumulate(torch.cat([valr, -valr], dim=1),
                                  torch.cat([sa, sb]), q.shape[1])


def _visit_span(lvl: DeviceLevel, q, config: SolverConfig,
                legacy_step: bool, tag: int, count=None):
    """The smoothing pass of the span paths on a (5, N) state
    (mgcfd_tpu's _visit_transposed). 'pallas' with fuse_stage: ONE
    shift.fused_stage launch per RK stage, the spill edges' flux (from
    the edge_csr flux kernel) entering as its operand, with
    _visit_window's epilogues (the count into count, the last stage's
    residual). Otherwise each stage is the span flux, plus the dense
    boundary/wall flux, then the time step and the invalid count, and the
    residual an eager q - old. One step_factor call gives every stage's
    factor. The rw twin runs after each stage. Returns (q, residual,
    count), as _visit_window."""
    fused = config.accumulate == "pallas" and config.fuse_stage
    old = q
    with kscope("compute_step", tag):
        fac = t_stage_factors(lvl, q, legacy_step)
    if count is None:
        count = _new_count(tag, q.device)
    for j in range(RK):
        if config.flux_cripple:
            _crippled_twin(lvl, q.T)
        if fused:
            with kscope("flux", tag):
                spill = (None if lvl.spill_csr is None
                         else edge_csr.flux(lvl.spill_csr, q))
                out = shift.fused_stage(lvl.shift, lvl.nc, q, old, fac[j],
                                        spill, count, residual=j == RK - 1)
            q = out[0]
        else:
            with kscope("flux", tag):
                flux = t_compute_fluxes(lvl, q, config)
            with kscope("time_step", tag):
                q = old + fac[j][None] * flux
            with kscope("invalid_count", tag):
                count.add_(invalid_count(q))
        if config.include_indirect_rw:
            with kscope("indirect_rw", tag):
                t_indirect_rw(lvl, q, config)
    if fused:
        return q, out[2], count
    with kscope("residual", tag):
        return q, q - old, count


# ---------------------------------------------------------------------------
# multigrid transfers
# ---------------------------------------------------------------------------

def apply_restrict(fine: DeviceLevel, coarse: DeviceLevel, vars_f, vars_c,
                   tstate: bool):
    """Restrict the fine variables onto the coarse level (euler3d:547-552);
    unmapped coarse nodes keep their value. Through the kernels where the
    level has their plan, whose store keeps vars_c on the rows with no
    fine child (its epilogue); tstate: the state is (5, N)."""
    if fine.restrict_csr is not None:
        return edge_csr.restrict(fine.restrict_csr, vars_f, keep=vars_c)
    if tstate:
        return apply_restrict(fine, coarse, vars_f.T, vars_c.T,
                              False).T.contiguous()
    return mg_restrict(vars_f, vars_c, fine.mg_mapping, coarse.num_nodes)


def apply_prolong(fine: DeviceLevel, coarse: DeviceLevel, res_c, res_f,
                  vars_f, tstate: bool):
    """vars_f += res_f - interpolated coarse residual (mg_loops.cpp:
    678-864, with the a1 -> b2 quirk); through the kernels where the level
    has their plan, the update in the kernel's store (its epilogue)."""
    if fine.prolong_csr is not None:
        return edge_csr.prolong(fine.prolong_csr, res_c,
                                correct=(vars_f, res_f))
    if tstate:
        return apply_prolong(fine, coarse, res_c.T, res_f.T, vars_f.T,
                             False).T.contiguous()
    return prolong_residuals_interpolate(
        res_c, res_f, vars_f, fine.mg_mapping, coarse.coords, fine.coords,
        fine.edge_a, fine.edge_b)


# ---------------------------------------------------------------------------
# K cycles as one CUDA graph
# ---------------------------------------------------------------------------

class CycleGraph:
    """K consecutive cycles of a CUDA solver captured as one CUDA graph
    (the counterpart of mgcfd_tpu's make_multi_cycle_fn, K cycles in one
    lax.scan). The graph reads the state from static buffers and, at the
    end of the captured region, copies each level's new variables and
    residuals back into them, so one replay advances the buffers by K
    cycles. It also leaves the K RMS values and invalid counts stacked on
    the device. ``launches`` holds the kernel launches one capture
    recorded, by wrapper, by edge_csr shape and by epilogue; a replay
    calls no wrapper, so replay() adds them to the counts. The
    construction is
    the span mgcfd.capture: the warm-up cycle, until the device has run
    it (mgcfd.capture.warmup), then the capture (mgcfd.capture.graph)."""

    @spans.span("mgcfd.capture")
    def __init__(self, solver: "MGCFDSolver", k: int):
        self.k = k
        st = solver.state
        self.variables = [t.clone() for t in st["variables"]]
        self.residuals = [t.clone() for t in st["residuals"]]
        counts = kernels.launch_counts(shapes=True)
        try:
            # warm-up on a clone of the state, on a side stream as torch's
            # capture recipe asks: the first launch of a kernel builds the
            # library and sets its attributes, which capture must not do
            with spans.span("mgcfd.capture.warmup"):
                side = torch.cuda.Stream(solver.device)
                side.wait_stream(torch.cuda.current_stream(solver.device))
                with torch.cuda.stream(side):
                    solver.state = {"variables": [t.clone() for t in
                                                  self.variables],
                                    "residuals": [t.clone() for t in
                                                  self.residuals]}
                    solver.cycle()
                torch.cuda.current_stream(solver.device).wait_stream(side)
                side.synchronize()
            kernels.reset_launch_counts()
            with spans.span("mgcfd.capture.graph"):
                self.graph = torch.cuda.CUDAGraph()
                solver.state = {"variables": list(self.variables),
                                "residuals": list(self.residuals)}
                with torch.cuda.graph(self.graph):
                    rms, invalid = [], []
                    for _ in range(k):
                        r, i = solver.cycle()
                        rms.append(r)
                        invalid.append(i)
                    for key, bufs in (("variables", self.variables),
                                      ("residuals", self.residuals)):
                        for buf, t in zip(bufs, solver.state[key]):
                            buf.copy_(t)
                    self.rms = torch.stack(rms)
                    self.invalid = torch.stack(invalid)
            self.launches = kernels.launch_counts(shapes=True)
        finally:
            solver.state = st
            kernels.reset_launch_counts()
            kernels.add_launch_counts(counts)
        spans.count("graph.captures")

    def replay(self, solver: "MGCFDSolver"):
        """Advance the solver's state by K cycles; returns the stacked
        (rms (K,), invalid (K,)) on the device. Afterwards solver.state
        names the graph's buffers, which the next replay overwrites."""
        for key, bufs in (("variables", self.variables),
                          ("residuals", self.residuals)):
            for buf, t in zip(bufs, solver.state[key]):
                if t is not buf:
                    buf.copy_(t)
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        solver.state = {"variables": list(self.variables),
                        "residuals": list(self.residuals)}
        return self.rms, self.invalid


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


class MGCFDSolver:
    """Owns the device mesh and state, runs V-cycles and performs the
    fail-fast invalid-state check between cycles (validation.cpp:107-138).
    The state is node-major at this interface: variables(level) is
    (N, 5) whatever the internal layout. The construction is the span
    mgcfd.solver; on CUDA it first creates the device's context, in the
    span mgcfd.context, so that no upload is charged for it."""

    @spans.span("mgcfd.solver")
    def __init__(self, mesh: MultigridMesh,
                 config: SolverConfig | None = None, device=None):
        self.config = config or SolverConfig()
        self.config.validate()
        if self.config.num_partitions > 1:
            raise NotImplementedError(
                f"MGCFDSolver runs on one device; num_partitions="
                f"{self.config.num_partitions} is parallel.ShardedSolver's")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            with spans.span("mgcfd.context"):
                torch.cuda.synchronize(self.device)
        self.mesh = mesh
        self.dmesh = prepare_device_mesh(mesh, self.config, self.device)
        self.dtype = DTYPES[self.config.dtype]
        self._tstate = variable_major(self.config)
        self.state = self._layout(
            [np.tile(far_field_state(np.float64)[0], (lv.num_nodes, 1))
             for lv in mesh.levels],
            [np.zeros((lv.num_nodes, NVAR)) for lv in mesh.levels])
        self.rms_history: list[float] = []
        self.completed_cycles = 0
        self._graph: Optional[CycleGraph] = None
        if self.config.resume and self.config.checkpoint_dir:
            path = latest_checkpoint(self.config.checkpoint_dir)
            if path is not None:
                st, self.completed_cycles, self.rms_history = \
                    load_checkpoint(path, mesh, self.dtype, self.device)
                self.state = self._layout(st["variables"], st["residuals"])

    def _layout(self, variables, residuals) -> dict:
        """Node-major arrays or tensors -> the state dict in the path's
        layout, on the device at the solver's dtype."""
        def put(a):
            t = a if isinstance(a, torch.Tensor) else \
                torch.as_tensor(np.asarray(a, np.float64))
            t = upload(lambda: t.to(device=self.device, dtype=self.dtype))
            return t.T.contiguous() if self._tstate else t
        return {"variables": [put(v) for v in variables],
                "residuals": [put(r) for r in residuals]}

    def _state_node_major(self) -> dict:
        """The state as node-major (N, 5) numpy arrays, as checkpoints
        store it (bfloat16 widened to float32, which is exact)."""
        def host(t):
            t = self._node_major(t).detach().to("cpu")
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return {k: [host(t) for t in v] for k, v in self.state.items()}

    def load_state(self, state: dict) -> None:
        """Install a node-major state ({'variables': [...],
        'residuals': [...]} per level, see convert.state_from_arrays)."""
        self.state = self._layout(state["variables"], state["residuals"])

    def cycle(self):
        """One V-cycle; returns (level-0 RMS, invalid count), device
        scalars."""
        levels = self.dmesh.levels
        L = len(levels)
        legacy = self.dmesh.variant.uses_legacy_step_factor
        variables = self.state["variables"]
        residuals = self.state["residuals"]
        # the cycle's invalid count, which the variable-major visits' fused
        # stages add into in their kernels
        invalid_total = _new_count(0, self.device)

        mode = self.config.accumulate
        tstate = self._tstate

        def visit(lev):
            if mode == "window":
                v, res, _ = _visit_window(levels[lev], variables[lev],
                                          self.config, legacy, lev,
                                          invalid_total)
            elif tstate:
                v, res, _ = _visit_span(levels[lev], variables[lev],
                                        self.config, legacy, lev,
                                        invalid_total)
            else:
                v, res, inv = _visit(levels[lev], variables[lev],
                                     self.dmesh.ff_flux, self.config,
                                     legacy, lev)
                with kscope("invalid_count", lev):
                    invalid_total.add_(inv)
            variables[lev] = v
            residuals[lev] = res
            return res

        rms = None
        for lev in range(L - 1):
            res = visit(lev)
            if lev == 0:
                with kscope("rms", 0):
                    rms = calc_rms(res, levels[0].num_nodes)
            with kscope("restrict", lev):
                variables[lev + 1] = apply_restrict(
                    levels[lev], levels[lev + 1], variables[lev],
                    variables[lev + 1], tstate)
        res = visit(L - 1)
        if L == 1:
            with kscope("rms", 0):
                rms = calc_rms(res, levels[0].num_nodes)
        for lev in range(L - 2, -1, -1):
            with kscope("prolong", lev):
                variables[lev] = apply_prolong(
                    levels[lev], levels[lev + 1], residuals[lev + 1],
                    residuals[lev], variables[lev], tstate)
            if lev > 0:
                visit(lev)
        return rms, invalid_total

    def run(self, cycles: int | None = None, verbose: bool = False):
        """Run `cycles` more V-cycles (default config.num_cycles), writing
        a checkpoint every config.checkpoint_every completed cycles when
        config.checkpoint_dir is set. Raises FloatingPointError when a
        checked cycle produced an invalid state."""
        cycles = cycles if cycles is not None else self.config.num_cycles
        check_every = max(1, self.config.check_invalid_every)
        ck_every = self.config.checkpoint_every
        for i in range(cycles):
            rms, invalid = self.cycle()
            if (i + 1) % check_every == 0 or i == cycles - 1:
                with kscope("invalid_count", 0):
                    inv = int(invalid)
                if inv > 0:
                    raise FloatingPointError(
                        f"invalid state detected during cycle {i + 1}: "
                        f"{inv} bad entries (NaN/Inf/negative density or "
                        f"energy)")
                with kscope("rms", 0):
                    self.rms_history.append(float(rms))
                if verbose:
                    print(f"MG cycle {i + 1} / {cycles} "
                          f"(RMS = {self.rms_history[-1]:.3e})", flush=True)
            self.completed_cycles += 1
            if (ck_every and self.config.checkpoint_dir
                    and self.completed_cycles % ck_every == 0):
                self._save_checkpoint()
        return self.state

    def _save_checkpoint(self) -> None:
        save_checkpoint(self.config.checkpoint_dir, self.mesh,
                        self._state_node_major(), self.completed_cycles,
                        self.rms_history)

    def _captures(self) -> bool:
        """Whether run_batched captures its batches as CUDA graphs."""
        return self.device.type == "cuda"

    def _batch(self, k: int, traced: bool):
        """K cycles; returns (rms (K,), invalid (K,)) on the device. On
        CUDA one replay of the cached graph of K cycles (captured at the
        first batch of this K, outside the span); elsewhere the eager
        loop. traced: inside the span mgcfd.batch.replay."""
        captures = self._captures()
        if captures and (self._graph is None or self._graph.k != k):
            self._graph = None     # free the old graph's pool first
            self._graph = CycleGraph(self, k)
        with spans.when(traced, "mgcfd.batch.replay"):
            if captures:
                return self._graph.replay(self)
            out = [self.cycle() for _ in range(k)]
            return (torch.stack([r for r, _ in out]),
                    torch.stack([i for _, i in out]))

    def run_batched(self, cycles: int, cycles_per_dispatch: int = 10,
                    verbose: bool = False):
        """Run `cycles` cycles in batches of K = cycles_per_dispatch (see
        _batch), as mgcfd_tpu's run_batched does: the RMS and invalid
        count of every cycle are kept on the device, the fail-fast check
        runs once per batch, and a tail shorter than K goes through run.
        It writes no checkpoint, as mgcfd_tpu's run_batched writes none
        (the tail through run keeps run's cadence). While a profiler
        records, each batch is the spans mgcfd.batch.replay and
        mgcfd.batch.read (the host's read of the invalid counts and RMS
        values); otherwise a batch records nothing."""
        k = max(1, min(cycles_per_dispatch, cycles))
        done = 0
        while done < cycles:
            if cycles - done < k:
                self.run(cycles - done, verbose=verbose)
                return self.state
            traced = spans.profiling()
            rms, invalid = self._batch(k, traced)
            done += k
            self.completed_cycles += k
            with spans.when(traced, "mgcfd.batch.read"):
                inv = int(invalid.sum())
                if inv > 0:
                    raise FloatingPointError(
                        f"invalid state detected within cycles "
                        f"{done - k + 1}..{done}: {inv} bad entries")
                self.rms_history.extend(
                    rms.to("cpu", torch.float64).tolist())
            if verbose:
                print(f"MG cycle {done} / {cycles} "
                      f"(RMS = {self.rms_history[-1]:.3e})", flush=True)
        return self.state

    def _node_major(self, t: torch.Tensor) -> torch.Tensor:
        return t.T if self._tstate else t

    def variables(self, level: int = 0) -> np.ndarray:
        """(N, 5) variables of one level, as float64 numpy."""
        v = self._node_major(self.state["variables"][level])
        return v.detach().to("cpu", torch.float64).numpy()

    def step_factors(self, level: int = 0) -> np.ndarray:
        """(N,) step factors of the current state, as float64 numpy."""
        lvl = self.dmesh.levels[level]
        v = self._node_major(self.state["variables"][level])
        sf = step_factor(lvl, v, self.dmesh.variant.uses_legacy_step_factor)
        return sf.detach().to("cpu", torch.float64).numpy()
