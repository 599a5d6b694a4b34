"""Solver / run configuration: the field names of ``mgcfd_tpu``'s
SolverConfig, so that a configuration reads the same in both packages.

A field whose feature the port does not have must keep its default;
``validate()`` raises NotImplementedError for any other value and names
the ROADMAP item that brings the feature, or says that the field chooses
a TPU formulation with no counterpart here.
"""
from __future__ import annotations

import dataclasses

ACCUMULATE_MODES = ("auto", "segment", "window", "pallas", "shift")
# bfloat16 is a storage format: the kernels load bf16, compute in f32 and
# round once on store; the plain paths run op by op in bf16, as XLA does
DTYPES = ("float32", "float64", "bfloat16")

# accumulate values of the JAX package that the port does not have yet
_ACCUMULATE_ROADMAP = {
    "ell": "ROADMAP.md queue 1, item 4 (prep/incidence.py)",
    "scatter": "ROADMAP.md queue 1, item 4 (accumulate_flux scatter mode)",
}

# field -> ROADMAP item; the field must keep its default until then
_NOT_PORTED = {
    "output_file_prefix": "queue 1, item 6 (validate/golden.py dumps)",
    "validate_result": "queue 1, item 6 (validate/)",
    "output_variables": "queue 1, item 6 (validate/golden.py dumps)",
    "output_fluxes": "queue 1, item 6 (validate/golden.py dumps)",
    "output_step_factors": "queue 1, item 6 (validate/golden.py dumps)",
    "output_volumes": "queue 1, item 6 (validate/golden.py dumps)",
    "output_edge_fluxes": "queue 1, item 6 (validate/golden.py dumps)",
    "flux_cripple": "queue 1, item 4 (crippled flux twin)",
    "flux_precompute_edge_weights": "queue 1, item 4 (segment-path |w|)",
    "checkpoint_dir": "queue 1, item 6 (utils/checkpoint.py)",
    "checkpoint_every": "queue 1, item 6 (utils/checkpoint.py)",
    "resume": "queue 1, item 6 (utils/checkpoint.py)",
    "event_config_file": "queue 1, item 7 (monitor/events.py)",
    "num_partitions": "queue 1, item 9 (parallel/)",
    "partition_2d": "queue 1, item 9 (parallel/)",
    "shard_levels": "queue 1, item 9 (parallel/)",
    "monitor_mode": "queue 1, item 7 (monitor/)",
    "flux_fission": "queue 1, item 4 (the fission formulation of "
                    "accumulate_flux)",
    "flux_reuse_flux": "queue 1, item 7 (monitor/csvout.py flux options)",
    "flux_reuse_div": "queue 1, item 7 (monitor/csvout.py flux options)",
    "flux_reuse_factor": "queue 1, item 7 (monitor/csvout.py flux "
                         "options)",
    "mg_gather": "queue 1, item 4 (the scatter formulation of the MG "
                 "transfers)",
    "plan_cache_dir": "queue 1, item 4 (prep/window.py cached_plan)",
}

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
    output_file_prefix: str = ""
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
    flux_reuse_flux: bool = False
    flux_reuse_div: bool = False
    flux_reuse_factor: bool = False
    include_indirect_rw: bool = True  # the reference runs it in the RK loop

    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    resume: bool = False
    event_config_file: str = ""

    dtype: str = "float32"            # one of DTYPES
    # 'auto' resolves at solver build: on CUDA 'pallas' when every
    # level's shift plan covers >= 0.995 of its edges (box-class meshes),
    # else 'window'; 'segment' on the CPU.
    #   'segment'  the plain edge-stream path (index_add_);
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
    # (None or True); the unfused pipeline (False) is not ported
    fuse_window_stage: bool | None = None
    # accumulate='shift': variable-major (5, N) state with the rolled span
    # evaluation (True) or node-major per-span slices (False); the kernel
    # modes are variable-major whatever its value
    transposed: bool = False
    window_tile_order: bool = True
    mg_gather: bool = True
    plan_cache_dir: str = ""
    compile_cache_dir: str = ""
    check_invalid_every: int = 1      # host-side NaN-guard cadence (cycles)
    num_partitions: int = 1
    partition_2d: str = ""
    shard_levels: int = 1
    monitor_mode: str = "fused"

    def validate(self) -> None:
        """Reject a configuration the port would silently get wrong."""
        if self.accumulate in _ACCUMULATE_ROADMAP:
            raise NotImplementedError(
                f"accumulate='{self.accumulate}' is not ported yet: "
                f"{_ACCUMULATE_ROADMAP[self.accumulate]}")
        if self.accumulate not in ACCUMULATE_MODES:
            raise ValueError(f"unknown accumulate mode {self.accumulate!r}")
        if self.dtype not in DTYPES:
            raise NotImplementedError(
                f"dtype={self.dtype!r} is not ported (the port runs "
                f"{', '.join(DTYPES)})")
        for f in dataclasses.fields(SolverConfig):
            if f.name in _NOT_PORTED and \
                    getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"SolverConfig.{f.name} is not ported yet: ROADMAP.md "
                    f"{_NOT_PORTED[f.name]}")
            if f.name in _NO_COUNTERPART and \
                    getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"SolverConfig.{f.name} has no counterpart in the "
                    f"port: {_NO_COUNTERPART[f.name]}")
        if self.fuse_window_stage is False:
            raise NotImplementedError(
                "SolverConfig.fuse_window_stage=False (the unfused window "
                "stage) is not ported yet: ROADMAP.md queue 1, items 7 "
                "and 9 (the instrumented and sharded solvers run it)")
