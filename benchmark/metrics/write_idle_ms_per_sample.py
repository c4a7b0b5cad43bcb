"""Milliseconds per sample written in which the card is idle under the
harness's ``bench.write`` spans: the card's wait for the tree writer."""

from harness import spans


def read(run):
    ms = spans.idle_ms(run, spans.WRITE)
    return None if ms is None else ms / run["traced_segments"]
