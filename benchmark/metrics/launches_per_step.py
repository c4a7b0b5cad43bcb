"""CUDA kernels per MD step of the traced window, every kernel counted."""

from harness import trace


def read(run):
    _, n = trace.kernel_ms(run["trace"], lambda k: True)
    return n / run["traced_md_steps"] if n else None
