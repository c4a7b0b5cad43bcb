"""Host milliseconds per MD step inside the program's ``mdqt.md_step``
spans, less the host's waits for the card there: the host's enqueue cost
of an MD step."""

from harness import spans


def read(run):
    return spans.host_ms_per_step(run, spans.STEP)
