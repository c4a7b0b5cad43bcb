"""``glue_ms_per_step`` on rank 0's card, the rank that samples every
member of a rank mesh."""

from harness import trace


def read(run):
    ms, n = trace.kernel_ms(
        run["trace"], lambda k: not ("yukawa" in k or "fused_ticks" in k
                                     or "nccl" in k.lower()), device=0)
    return ms / run["traced_md_steps"] if n else None
