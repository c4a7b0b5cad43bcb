"""The 95th percentile (nearest rank) over every output segment of the
window of its device time: from the end of the previous segment to its
own, CUDA events at the boundaries read after the window."""

from harness.cell import percentile


def read(run):
    seg = run["segment_ms"]
    return percentile(seg, 95) if seg else None
