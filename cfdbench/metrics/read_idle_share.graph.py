"""read_idle_share.graph: the share of the traced run_batched calls'
device span in which the device idled while the host read a batch's
invalid counts and RMS values (the program's span mgcfd.batch.read), in
%."""
from cfdbench.program_spans import idle_share


def read(record):
    return idle_share(record, "mgcfd.batch.read")
