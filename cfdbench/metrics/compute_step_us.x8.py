"""compute_step_us.x8: compute_step_us in the -m 8 cells, where it
moves cycle_ms.x8."""


def read(record):
    return record.get("functions", {}).get("compute_step")
