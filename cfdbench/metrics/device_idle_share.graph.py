"""device_idle_share.graph: the share of the traced run_batched calls'
device span (first kernel's start to last kernel's end) in which no
device operation ran."""


def read(record):
    tr = record.get("trace")
    if not tr or record["mix"]["entry"] != "run_batched":
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
