"""Ion-QT-updates per second of the window: every real ion of every
member times the quantum ticks of the window's MD steps, over the window's
wall time from a synced card to the synced end of its last group
(bench.py:3-9; the rate of tools/torch_campaign99.py:64-81)."""


def read(run):
    d = run["config"]["derived"]
    ions = run["members"] * run["config"]["physics"]["n0"]
    return ions * d["ratio"] * run["md_steps"] / run["wall_s"]
