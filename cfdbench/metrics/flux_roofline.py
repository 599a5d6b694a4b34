"""flux_roofline: the least time of a cycle's flux calls (counts.py: the
larger of bytes over the card's bandwidth and operations over its peak,
per call) over the flux function's measured device time a cycle, in %.
The fused stage's time step lands on the flux function too, so the share
is conservative."""


def read(record):
    us = record.get("functions", {}).get("flux")
    least = record.get("least", {}).get("flux")
    if not us or least is None:
        return None
    return 100.0 * least["seconds"] / (us * 1e-6)
