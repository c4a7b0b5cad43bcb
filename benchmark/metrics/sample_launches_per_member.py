"""Kernels launched inside the program's ``mdqt.sample`` spans, matched to
their launches by ``correlation``, per sample span and member."""

from harness import spans


def read(run):
    return spans.per_member(run, spans.launches)
