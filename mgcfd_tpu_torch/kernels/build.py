"""Build the CUDA kernels with one nvcc call and load them with ctypes.

The sources under csrc/ have a plain C interface (no torch headers), so
one ``nvcc -shared`` call builds them all into one library in seconds.
The library lands in build/mgcfd_tpu_torch/ at the repository root, named
by a hash of the sources and flags: a changed source builds anew, an
unchanged one loads the existing file. The file is written under a
temporary name and renamed into place, so concurrent builders never see a
half-written library and no lock file is needed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

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
    "mgcfd_edge_csr": [_I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P],
    "mgcfd_fused_stage": [_I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                          _P],
    "mgcfd_shift_flux": [_I, _I, _P, _I, _P, _P, _P, _I, _P],
    "mgcfd_shift_flux_at": [_I, _I, _I, _I, _P, _I, _P, _P, _P, _I, _P],
    "mgcfd_shift_flux_shape": [_I, _I, _I, _I, _P],
    "mgcfd_wsum_at": [_I, _I, _I, _P, _P, _P, _I, _P, _I, _P, _I, _P],
    "mgcfd_wsum_shape": [_I, _I, _I, _P],
    "mgcfd_rw_at": [_I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P],
    "mgcfd_rw_shape": [_I, _I, _I, _P],
    "mgcfd_shift_fused_stage": [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                                _P, _P, _P, _P, _I, _P],
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


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns (path, seconds spent in nvcc; 0.0 when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=NVCC_TIMEOUT_S)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {r.returncode}:\n"
                               f"{' '.join(cmd)}\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use in this process)."""
    global _lib
    if _lib is None:
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
