"""The card's idle share of the traced window, in %: the window less the
union of its kernels, copies and sets, from the profiler's trace."""


def read(run):
    b = run["breakdown"]
    if not b["window_ms"]:
        return None
    return 100.0 * (1.0 - b["busy_ms"] / b["window_ms"])
