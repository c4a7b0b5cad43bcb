"""The pair kernels' share of their roofline, in %: the least time of the
traced segments' pair work (a force evaluation each MD step and a
potential evaluation each sample, counted from the real ions) over the
device time of the kernels of csrc/yukawa_forces.cu."""

from harness import roofline, trace


def read(run):
    ms, n = trace.kernel_ms(run["trace"], lambda k: "yukawa" in k)
    if not n:
        return None
    steps = run["config"]["physics"]["sample_freq"]
    least = run["traced_segments"] * roofline.segment_pair_bound_s(
        run["config"], run["members"], steps)
    return 100.0 * least / (ms / 1e3)
