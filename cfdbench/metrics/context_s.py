"""context_s: host seconds of the CUDA context's creation, which
MGCFDSolver makes explicit at the start of its construction: the
program's span mgcfd.context."""
from cfdbench.program_spans import setup_seconds


def read(record):
    return setup_seconds("mgcfd.context")
