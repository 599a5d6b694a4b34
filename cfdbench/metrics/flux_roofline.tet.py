"""flux_roofline.tet: flux_roofline in the tetrahedral cells, where it
moves cycle_ms: counts.py's least time of a cycle's flux calls over the
flux function's measured device time a cycle, in %, on the fused stage's
long-row shapes."""


def read(record):
    us = record.get("functions", {}).get("flux")
    least = record.get("least", {}).get("flux")
    if not us or least is None:
        return None
    return 100.0 * least["seconds"] / (us * 1e-6)
