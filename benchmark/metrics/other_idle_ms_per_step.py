"""Milliseconds per MD step of the traced window in which the card is idle
under neither of the program's spans: the fold's way in and out of the
lane layout, the outputs' stack, the group's fetch.  With the sample and
step parts it adds up to ``device_idle_pct``'s idle time."""

from harness import spans


def read(run):
    return spans.idle_ms_per_step(run, None)
