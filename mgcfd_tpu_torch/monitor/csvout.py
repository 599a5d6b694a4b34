"""CSV output with the reference's schema (mgcfd_tpu's monitor/csvout.py).

The reference writes Times.csv, PAPI.csv and LoopNumIters.csv with a
shared 16-column identification prefix (prepare_csv_identification,
io_enhanced.cpp:858-1016) followed by per-kernel x per-level columns
(timer.cpp:106-195, loop_stats.cpp:83-171). The column names and file
names are mgcfd_tpu's, so that its bench/aggregate.py reads the port's
Times.csv and LoopNumIters.csv unchanged. The values name the port's
platform: CC "torch", CC version torch.__version__ (with the CUDA
version it was built for), Instruction set the card's name (or "cpu"),
SIMD len the lanes of a warp (1 on the CPU), CPU the device string.
PAPI.csv's counterpart is KernelCosts.csv: one row per event of the `-p`
selection (monitor/events.py), the same kernel x level columns.
"""
from __future__ import annotations

import dataclasses
import os

ID_COLUMNS = ["Size", "Mesh", "MG cycles", "Flux variant", "Flux options",
              "CC", "CC version", "Opt level", "Instruction set", "SIMD",
              "SIMD len", "OpenMP", "Num threads", "Permit scatter OpenMP",
              "Flux fission", "CPU"]
KERNEL_COLUMNS = ["flux", "update", "compute_step", "time_step",
                  "restrict", "prolong", "indirect_rw"]
COSTS_FILE = "KernelCosts.csv"


@dataclasses.dataclass
class CsvIdentification:
    size: int
    mesh_name: str
    mg_cycles: int
    flux_variant: str
    flux_options: str
    cc: str
    cc_version: str
    opt_level: str
    instruction_set: str
    simd: str
    simd_len: str
    openmp: str
    num_threads: int
    omp_scatters: str
    flux_fission: str
    cpu: str

    @staticmethod
    def build(config, mesh, device) -> "CsvIdentification":
        import torch
        cuda = device.type == "cuda"
        version = torch.__version__
        if torch.version.cuda:
            version += f" (CUDA {torch.version.cuda})"
        return CsvIdentification(
            size=mesh.problem_size,
            mesh_name=mesh.variant.value,
            mg_cycles=config.num_cycles,
            flux_variant=config.flux_variant_string(),
            flux_options=config.flux_options_string(),
            cc="torch",
            cc_version=version,
            opt_level="3",
            instruction_set=(torch.cuda.get_device_name(device) if cuda
                             else "cpu"),
            simd="Y",
            simd_len="32" if cuda else "1",
            # as mgcfd_tpu's: Num threads is the partition count
            openmp="Strong" if config.num_partitions > 1 else "Off",
            num_threads=config.num_partitions,
            omp_scatters="N",
            flux_fission="Y" if config.flux_fission else "N",
            cpu=str(device),
        )

    def header(self) -> str:
        return ",".join(ID_COLUMNS) + ","

    def row(self) -> str:
        return (f"{self.size},{self.mesh_name},{self.mg_cycles},"
                f"{self.flux_variant},{self.flux_options},{self.cc},"
                f"{self.cc_version},{self.opt_level},"
                f"{self.instruction_set},{self.simd},{self.simd_len},"
                f"{self.openmp},{self.num_threads},{self.omp_scatters},"
                f"{self.flux_fission},{self.cpu},")


def _output_path(prefix: str, name: str) -> str:
    """The reference's report path: prefix + name, with a '.' between
    them unless the prefix is a directory (ends in '/')."""
    path = prefix or ""
    if path and not path.endswith("/"):
        path += "."
    return path + name


def _kernel_cells(data: dict, num_levels: int) -> str:
    return "".join(f"{data.get((k, lev), 0)},"
                   for lev in range(num_levels) for k in KERNEL_COLUMNS)


def _kernel_header(num_levels: int) -> str:
    return "".join(f"{k}{lev}," for lev in range(num_levels)
                   for k in KERNEL_COLUMNS)


def _write(filepath: str, lines: list) -> str:
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    with open(filepath, "w") as f:
        f.write("\n".join(lines) + "\n")
    return filepath


def _write_wide_csv(filepath: str, ident: CsvIdentification,
                    per_level: dict, num_levels: int,
                    total: float | None) -> str:
    """One row (ThreadNum 0): per-kernel x per-level columns in the
    reference order, plus Total for Times.csv."""
    header = ident.header() + "ThreadNum,CpuId," + _kernel_header(num_levels)
    row = ident.row() + "0,0," + _kernel_cells(per_level, num_levels)
    if total is not None:
        header += "Total,"
        row += f"{total},"
    return _write(filepath, [header, row])


def write_times_csv(prefix: str, ident: CsvIdentification, times: dict,
                    num_levels: int, total_time: float) -> str:
    return _write_wide_csv(_output_path(prefix, "Times.csv"), ident, times,
                           num_levels, total_time)


def write_loop_stats_csv(prefix: str, ident: CsvIdentification,
                         iters: dict, num_levels: int) -> str:
    return _write_wide_csv(_output_path(prefix, "LoopNumIters.csv"), ident,
                           iters, num_levels, None)


def write_costs_csv(prefix: str, ident: CsvIdentification, events: list,
                    num_levels: int) -> str:
    """KernelCosts.csv in PAPI.csv's layout: one row per event,
    events = [(event name, {(kernel, level): value})]."""
    header = ident.header() + "ThreadNum,CpuId,Event," \
        + _kernel_header(num_levels)
    lines = [header] + [ident.row() + f"0,0,{event},"
                        + _kernel_cells(data, num_levels)
                        for event, data in events]
    return _write(_output_path(prefix, COSTS_FILE), lines)
