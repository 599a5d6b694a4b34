"""device_idle_share.graph.x8: device_idle_share.graph in the -m 8
cells, where it moves cycle_ms.x8."""


def read(record):
    tr = record.get("trace")
    if not tr or record["mix"]["entry"] != "run_batched":
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
