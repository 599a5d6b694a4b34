"""compute_step_us: device microseconds a cycle of the step factor, the
compute_step function summed over the levels (the port's
measure_production over cycles of run)."""


def read(record):
    return record.get("functions", {}).get("compute_step")
