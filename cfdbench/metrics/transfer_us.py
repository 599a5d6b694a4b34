"""transfer_us: device microseconds a cycle of the multigrid transfers,
restrict plus prolong summed over the levels (the port's
measure_production over cycles of run)."""


def read(record):
    f = record.get("functions", {})
    if "restrict" not in f or "prolong" not in f:
        return None
    return f["restrict"] + f["prolong"]
