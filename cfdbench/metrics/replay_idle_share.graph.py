"""replay_idle_share.graph: the share of the traced run_batched calls'
device span in which the device idled while the host was inside a
batch's replay (the program's span mgcfd.batch.replay: the graph's
launch), in %."""
from cfdbench.program_spans import idle_share


def read(record):
    return idle_share(record, "mgcfd.batch.replay")
