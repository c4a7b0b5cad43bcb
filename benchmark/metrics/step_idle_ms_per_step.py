"""Milliseconds per MD step of the traced window in which the card is idle
under the program's ``mdqt.md_step`` spans (the force and tick launches
and their arguments), outside every sample span."""

from harness import spans


def read(run):
    return spans.idle_ms_per_step(run, spans.STEP)
