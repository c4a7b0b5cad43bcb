"""The host's waits for the card (``trace.HOST_WAITS``) inside the
program's ``mdqt.sample`` spans, per sample span and member."""

from harness import spans


def read(run):
    return spans.per_member(run, spans.waits)
