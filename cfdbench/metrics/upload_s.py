"""upload_s: host seconds of the host -> device copies and casts of the
mesh, the plans and the state: the program's spans mgcfd.upload."""
from cfdbench.program_spans import setup_seconds


def read(record):
    return setup_seconds("mgcfd.upload")
