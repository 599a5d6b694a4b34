"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources under csrc/ have a plain C interface (no torch headers): one
nvcc process a source, all started together, compiles them in the time of
the slowest, and one ``nvcc -shared`` links them into one library.
The library lands in build/mgcfd_tpu_torch/ at the repository root, named
by a hash of the sources and flags: a changed source builds anew, an
unchanged one loads the existing file. The file is written under a
temporary name and renamed into place, so concurrent builders never see a
half-written library and no lock file is needed.

The first library() of a process is the span mgcfd.library
(utils/spans.py): the sources' hash, a build when there is no library
for them (the child span mgcfd.library.build; the counter
library.builds), and the load.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

import torch

from ..utils import spans

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mgcfd_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
NVCC_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I = ctypes.c_int64
# C entry point -> argtypes (pointers and the stream as c_void_p, sizes,
# flags and the dtype code as c_int64); every entry point returns its
# cudaError_t
_SIGNATURES = {
    "mgcfd_edge_csr": [_I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P,
                       _P, _P],
    "mgcfd_fused_stage": [_I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                          _P, _P, _P, _P, _P, _I, _P],
    "mgcfd_shift_flux": [_I, _I, _P, _I, _P, _P, _P, _I, _P],
    "mgcfd_shift_flux_at": [_I, _I, _I, _I, _P, _I, _P, _P, _P, _I, _P],
    "mgcfd_shift_flux_shape": [_I, _I, _I, _I, _P],
    "mgcfd_wsum_at": [_I, _I, _I, _P, _P, _P, _I, _P, _I, _P, _I, _P, _P,
                      _P, _P],
    "mgcfd_wsum_shape": [_I, _I, _I, _P],
    "mgcfd_rw_at": [_I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P],
    "mgcfd_rw_shape": [_I, _I, _I, _P],
    "mgcfd_flux_at": [_I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P],
    "mgcfd_flux_shape": [_I, _I, _I, _P],
    "mgcfd_shift_fused_stage": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                                _P, _P, _P, _I, _P, _P, _P, _P, _I, _P],
    "mgcfd_step_factor": [_I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P],
}

# the dtype code every C entry point takes first: the storage type of the
# state and weights (bfloat16 is computed in float32 and rounded on store);
# an entry point returns cudaErrorInvalidValue for any other code
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH): the CUDA kernels are built at first use")


def library_path() -> Path:
    """Where the library for the current sources lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmgcfd_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc_run(cmd: list[str], timeout: float) -> None:
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {r.returncode}:\n"
                           f"{' '.join(cmd)}\n{r.stderr}")


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu unless the library for these sources exists: an
    object a source, their nvcc processes started together, then one
    link. The first compile to fail, in time, raises with its message.
    Returns (path, seconds spent in nvcc; 0.0 when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{stem}.tmp.so")
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{stem}.{s.stem}.o" for s in srcs]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    try:
        with spans.span("mgcfd.library.build"), \
                ThreadPoolExecutor(len(srcs)) as pool:
            for f in as_completed(
                    pool.submit(_nvcc_run, [nvcc, *compile_flags, "-c", "-o",
                                            str(o), str(s)], NVCC_TIMEOUT_S)
                    for s, o in zip(srcs, objs)):
                f.result()
            _nvcc_run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                      NVCC_TIMEOUT_S)
        spans.count("library.builds")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use in this process)."""
    global _lib
    if _lib is None:
        with spans.span("mgcfd.library"):
            lib = ctypes.CDLL(str(build()[0]))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    """The C entry points' code for the storage type of `t`."""
    return DTYPE_CODES[t.dtype]


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
