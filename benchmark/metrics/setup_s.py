"""Set-up seconds by the host's clock: from the start of the process's
script to the window, with the kernels' build or load, the start and
the warm-up group."""


def read(run):
    return run["setup_s"]
