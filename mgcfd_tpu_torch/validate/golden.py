"""Golden-solution validation and array dumps (mgcfd_tpu's
validate/golden.py).

File naming follows the reference (io_enhanced.cpp:26-74):
  output:   <prefix.>variables.size=<m>x.cycles=<g>.level=<l>
  solution: <dir>/solution.variables.size=<m>x.cycles=<g>.level=<l>
Dump format: 5-column %.17e rows (io.cpp:201-233), which is what
read_double_array consumes, so a dump is a usable golden state. Each
writer writes the same bytes as mgcfd_tpu's for the same arrays.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.constants import NVAR, MeshVariant


def _suffix(mesh_duplicate_count: int, num_cycles: int, level: int) -> str:
    return (f"size={mesh_duplicate_count}x.cycles={num_cycles}"
            f".level={level}")


def output_filepath(prefix: str, name: str, m: int, cycles: int,
                    level: int) -> str:
    path = prefix or ""
    if path and not path.endswith("/"):
        path += "."
    return f"{path}{name}.{_suffix(m, cycles, level)}"


def solution_filepath(directory: str, name: str, m: int, cycles: int,
                      level: int) -> str:
    d = directory or ""
    if d and not d.endswith("/"):
        d += "/"
    return f"{d}solution.{name}.{_suffix(m, cycles, level)}"


def dump_variables(path: str, variables: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for row in variables:
            f.write(" ".join(f"{x:.17e}" for x in row) + "\n")


def dump_scalars(path: str, values: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for x in values:
            f.write(f"{x:.17e}\n")


def read_solution(path: str, nel: int, ncol: int = NVAR) -> np.ndarray:
    return np.loadtxt(path).reshape(nel, ncol)


def dump_edge_fluxes(prefix: str, m: int, cycles: int, level: int,
                     val_internal: np.ndarray,
                     val_boundary: np.ndarray,
                     val_wall: np.ndarray) -> list[str]:
    """Per-edge flux dumps: five files (edge_p/_mx/_my/_mz/_pe), one
    "a b" pair per edge, internal then boundary then wall (dump_edge_fluxes,
    io_enhanced.cpp:672-789). The internal b-side is the exact negation of
    the a-side; boundary and wall edges have no a-side (zero, as the
    reference's zero_edges leaves them). The CLI computes the values from
    the final variables, where the reference dumps the last RK stage's
    (computed from that stage's start state), as mgcfd_tpu's CLI does."""
    names = {0: "edge_p", 1: "edge_mx", 2: "edge_my", 3: "edge_mz",
             4: "edge_pe"}
    zeros_b = np.zeros(val_boundary.shape[0])
    zeros_w = np.zeros(val_wall.shape[0])
    paths = []
    for v, name in names.items():
        a_col = np.concatenate([val_internal[:, v], zeros_b, zeros_w])
        b_col = np.concatenate([-val_internal[:, v], val_boundary[:, v],
                                val_wall[:, v]])
        path = output_filepath(prefix, name, m, cycles, level)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for a, b in zip(a_col, b_col):
                f.write(f"{a:.17e} {b:.17e}\n")
        paths.append(path)
    return paths


class ValidationError(AssertionError):
    pass


def identify_differences(test_values: np.ndarray,
                         master_values: np.ndarray,
                         variant: MeshVariant,
                         raise_on_fail: bool = True) -> int:
    """Elementwise comparison with the reference's tolerances
    (validation.cpp:140-199): relative 10.0e-9 with absolute floor
    3.0e-19, relaxed to 1.0e-15 for FVCORR. Returns the violation
    count."""
    rel = 10.0e-9
    abs_floor = 1.0e-15 if variant is MeshVariant.FVCORR else 3.0e-19
    acceptable = np.maximum(np.abs(master_values) * rel, abs_floor)
    bad = np.abs(test_values - master_values) > acceptable
    count = int(bad.sum())
    if count and raise_on_fail:
        idx = tuple(np.argwhere(bad)[0])
        raise ValidationError(
            f"{count} values exceed tolerance; first at {idx}: "
            f"test={test_values[idx]!r} master={master_values[idx]!r}")
    return count
