"""plans_s: host seconds of the plans, each through the plan cache (the
content hash of its arrays, then the npz load or the build and store):
the program's spans mgcfd.plan, the outermost of each nest."""
from cfdbench.program_spans import setup_seconds


def read(record):
    return setup_seconds("mgcfd.plan")
