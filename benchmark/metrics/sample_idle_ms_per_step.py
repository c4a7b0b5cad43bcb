"""Milliseconds per MD step of the traced window in which the card is idle
under the program's ``mdqt.sample`` spans (a fold's sample loop)."""

from harness import spans


def read(run):
    return spans.idle_ms_per_step(run, spans.SAMPLE)
