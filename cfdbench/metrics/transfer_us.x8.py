"""transfer_us.x8: transfer_us in the -m 8 cells, where it moves
cycle_ms.x8."""


def read(record):
    f = record.get("functions", {})
    if "restrict" not in f or "prolong" not in f:
        return None
    return f["restrict"] + f["prolong"]
