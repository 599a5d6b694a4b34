"""Solver / run configuration: the field names of ``mgcfd_tpu``'s
SolverConfig, so that a configuration reads the same in both packages.

A field whose feature has no counterpart in the port must keep its
default; ``validate()`` raises NotImplementedError for any other value and
says why. It refuses flux_fission where mgcfd_tpu refuses it, with the
same ValueError, and a sharding field it cannot use (num_partitions below
1, shard_levels below 0) with a ValueError.
"""
from __future__ import annotations

import dataclasses

ACCUMULATE_MODES = ("auto", "segment", "scatter", "ell", "window", "pallas",
                    "shift")
MONITOR_MODES = ("fused", "instrumented")
# bfloat16 is a storage format: the kernels load bf16, compute in f32 and
# round once on store; the plain paths run op by op in bf16, as XLA does
DTYPES = ("float32", "float64", "bfloat16")

# field -> why it has no counterpart; it must keep its default
_NO_COUNTERPART = {
    "window_tile_order": "the port runs its kernels in the caller's node "
                         "order; the tile interleave is a TPU layout",
    "compile_cache_dir": "the port compiles no XLA programs; its kernels "
                         "build once into build/mgcfd_tpu_torch/",
}


@dataclasses.dataclass
class SolverConfig:
    # --- runtime flags (reference CLI: config.cpp:32-47) ---
    input_file: str = ""
    input_file_directory: str = ""
    output_file_prefix: str = ""      # -o: the monitor's reports
    mesh_duplicate_count: int = 1
    num_cycles: int = 25              # -g (config.cpp:63)
    validate_result: bool = False
    output_variables: bool = False
    output_fluxes: bool = False
    output_step_factors: bool = False
    output_volumes: bool = False
    output_edge_fluxes: bool = False

    # --- kernel variants (reference compile-time macros, same names) ---
    flux_fission: bool = False
    flux_cripple: bool = False
    flux_precompute_edge_weights: bool = False
    # the FLUX_REUSE_* macros only label the CSV's "Flux options" field,
    # as in mgcfd_tpu (the kernels already share their reciprocals)
    flux_reuse_flux: bool = False
    flux_reuse_div: bool = False
    flux_reuse_factor: bool = False
    include_indirect_rw: bool = True  # the reference runs it in the RK loop

    # utils/checkpoint.py: node-major npz snapshots, each package's
    # readable by the other
    checkpoint_dir: str = ""
    checkpoint_every: int = 0         # cycles between snapshots (0 = off)
    resume: bool = False              # resume from the latest snapshot
    event_config_file: str = ""       # -p: the cost file's events

    dtype: str = "float32"            # one of DTYPES
    # 'auto' resolves at solver build: 'segment' with flux_fission or on
    # the CPU; on CUDA 'pallas' when every level's shift plan covers
    # >= 0.995 of its edges (box-class meshes), else 'window'.
    #   'segment'  the plain edge-stream path (one index_add_);
    #   'scatter'  the same values through chained index_add_ calls;
    #   'ell'      each node gathers its half-edges' values from fixed-
    #              width incidence tables (prep/incidence.py);
    #   'window'   the CSR kernels — on the card an owner-sorted CSR
    #              (prep/csr.py), not the TPU's (8, 128) window plan;
    #   'pallas'   the span kernels of box-class meshes (prep/shift.py,
    #              kernels/shift.py), spill edges through the CSR kernels;
    #   'shift'    the span decomposition in plain PyTorch.
    # The names are kept so that the flags line up with mgcfd_tpu.
    accumulate: str = "auto"
    # accumulate='pallas': one fused kernel launch per RK stage (True),
    # or the span flux kernel, then boundary/wall, time step and invalid
    # count as separate ops (False)
    fuse_stage: bool = True
    # accumulate='window' runs each RK stage as one fused kernel launch
    # (None or True), or the edge_csr flux kernel over the owner CSR, then
    # boundary/wall, time step and invalid count as separate ops (False)
    fuse_window_stage: bool | None = None
    # accumulate='shift': variable-major (5, N) state with the rolled span
    # evaluation (True) or node-major per-span slices (False); the kernel
    # modes are variable-major whatever its value
    transposed: bool = False
    window_tile_order: bool = True
    # the MG transfers through the wsum kernels on the kernel paths
    # (True), or the plain scatter formulation (False), as in mgcfd_tpu
    mg_gather: bool = True
    plan_cache_dir: str = ""          # content-keyed npz cache of the
    # port's plans (prep/plancache.py); "" = rebuild
    compile_cache_dir: str = ""
    check_invalid_every: int = 1      # host-side NaN-guard cadence (cycles)
    # the sharded solver (parallel/): ranks, each owning one shard; an
    # optional 2-D tiling ('PXxPY' or 'auto'); levels sharded (0 = auto)
    num_partitions: int = 1
    partition_2d: str = ""
    shard_levels: int = 1
    monitor_mode: str = "fused"       # one of MONITOR_MODES (the CLI's)

    def validate(self) -> None:
        """Reject a configuration the port would silently get wrong.
        FLUX_FISSION is the reference's per-edge store + update split
        (flux_loops.cpp:120-123, cfd_loops.cpp:159-213); the span and CSR
        formulations have no per-edge store phase, so the flag is refused
        there, as mgcfd_tpu refuses it (its SolverConfig.validate); the
        edge-stream modes (segment, scatter, ell) honour it."""
        if self.accumulate not in ACCUMULATE_MODES:
            raise ValueError(f"unknown accumulate mode {self.accumulate!r}")
        if self.dtype not in DTYPES:
            raise NotImplementedError(
                f"dtype={self.dtype!r} is not ported (the port runs "
                f"{', '.join(DTYPES)})")
        if self.num_partitions < 1 or self.shard_levels < 0:
            raise ValueError(
                f"num_partitions={self.num_partitions} (at least 1), "
                f"shard_levels={self.shard_levels} (0 = auto, or more)")
        for f in dataclasses.fields(SolverConfig):
            if f.name in _NO_COUNTERPART and \
                    getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"SolverConfig.{f.name} has no counterpart in the "
                    f"port: {_NO_COUNTERPART[f.name]}")
        if self.flux_fission and (
                self.accumulate in ("shift", "pallas", "window")
                or self.transposed):
            how = (f"accumulate='{self.accumulate}'"
                   + (" with transposed state" if self.transposed else ""))
            raise ValueError(
                f"flux_fission is undefined for {how}: these "
                "formulations have no per-edge store phase. Use "
                "accumulate='segment' (structurally fission) or drop "
                "the flag.")
        if self.monitor_mode not in MONITOR_MODES:
            raise ValueError(f"unknown monitor mode {self.monitor_mode!r}")

    def flux_options_string(self) -> str:
        """CSV 'Flux options' field (io_enhanced.cpp:895-908 semantics)."""
        s = ""
        if self.flux_precompute_edge_weights:
            s += "PrecomputeLength;"
        if self.flux_reuse_div:
            s += "Reciprocal;"
        if self.flux_reuse_factor:
            s += "ReuseFactor;"
        if self.flux_reuse_flux:
            s += "ReuseFluxes;"
        return s

    def flux_variant_string(self) -> str:
        return "FluxCripple" if self.flux_cripple else "Normal"
