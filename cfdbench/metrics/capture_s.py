"""capture_s: host seconds of the CUDA graph's construction at the first
batch (a warm-up cycle on a side stream, the kernel library's load on a
fresh process, then the capture of K cycles): the program's span
mgcfd.capture."""
from cfdbench.program_spans import setup_seconds


def read(record):
    return setup_seconds("mgcfd.capture")
