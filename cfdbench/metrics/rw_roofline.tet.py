"""rw_roofline.tet: rw_roofline in the tetrahedral cells, where it moves
cycle_ms: counts.py's least time of a cycle's indirect_rw calls over the
indirect_rw function's measured device time a cycle, in %, on edge_csr
rw's long-row shapes (tile, row, group8x2)."""


def read(record):
    us = record.get("functions", {}).get("indirect_rw")
    least = record.get("least", {}).get("indirect_rw")
    if not us or least is None:
        return None
    return 100.0 * least["seconds"] / (us * 1e-6)
