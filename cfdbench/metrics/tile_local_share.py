"""tile_local_share: the share of the window path's owner-CSR entries
whose neighbour lies in its owner row's tile of 128 rows, in %: the fused
stage completes a tile's own nodes once, in shared memory, and every other
neighbour again from device memory. The program's counters
window.entries.local of window.entries.all (mgcfd_tpu_torch.utils.spans),
summed over the levels when the solver uploads its CSRs. A program without
the counters (one older than them) reads 0."""


def read(record):
    try:
        from mgcfd_tpu_torch.utils import spans
    except ImportError:
        return 0.0
    counts = spans.counters("window.entries.")
    if not counts.get("all"):
        return 0.0
    return 100.0 * counts.get("local", 0) / counts["all"]
