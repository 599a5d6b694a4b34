"""rw_roofline: the least time of a cycle's indirect_rw calls (counts.py)
over the indirect_rw function's measured device time a cycle, in %."""


def read(record):
    us = record.get("functions", {}).get("indirect_rw")
    least = record.get("least", {}).get("indirect_rw")
    if not us or least is None:
        return None
    return 100.0 * least["seconds"] / (us * 1e-6)
