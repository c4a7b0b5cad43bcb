"""Device milliseconds per MD step of every CUDA kernel of the traced
window that is neither a pair kernel, a tick kernel nor an NCCL kernel:
the sample loop's operations, the member sums and the step's torch
operations."""

from harness import trace


def read(run):
    ms, n = trace.kernel_ms(
        run["trace"], lambda k: not ("yukawa" in k or "fused_ticks" in k
                                     or "nccl" in k.lower()))
    return ms / run["traced_md_steps"] if n else None
