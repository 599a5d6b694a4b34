"""prep_s: host seconds from MGCFDSolver's construction to the end of
warm-up (plans through the plan cache, upload, the checked call with the
graph's capture, the warm-up calls), the benchmark's own span."""


def read(record):
    return record.get("spans", {}).get("prep_s")
