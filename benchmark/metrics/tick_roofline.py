"""The tick kernel's share of its roofline, in %: the least time of the
traced segments' quantum ticks (the frozen operations of a tick of every
real ion) over the device time of the kernels of csrc/fused_ticks.cu."""

from harness import roofline, trace


def read(run):
    ms, n = trace.kernel_ms(run["trace"], lambda k: "fused_ticks" in k)
    if not n:
        return None
    steps = run["config"]["physics"]["sample_freq"]
    least = run["traced_segments"] * roofline.segment_tick_bound_s(
        run["config"], run["members"], steps)
    return 100.0 * least / (ms / 1e3)
