"""Host milliseconds per MD step inside the program's ``mdqt.sample`` spans,
less the host's waits for the card there: what the fold's sample loop costs
the host to issue."""

from harness import spans


def read(run):
    return spans.host_ms_per_step(run, spans.SAMPLE)
