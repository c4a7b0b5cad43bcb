"""Host milliseconds per sample written inside the harness's ``bench.write``
spans (each ``write_outputs`` and ``checkpoint.save_native`` call of the
traced group), less the host's waits for the card there: what the tree
writer costs the host a sample."""

from harness import spans


def read(run):
    ms = spans.host_ms(run, spans.WRITE)
    return None if ms is None else ms / run["traced_segments"]
