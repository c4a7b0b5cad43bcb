"""Quicklook plots for a job directory's .dat output tree.

The reference leaves post-processing entirely to the user (its README
describes the output schema, README.md:103-142, and stops there); this
module renders the standard one-glance summary of whatever a job
directory contains — energies per axis, the energy-audit column,
velocity distributions, S/P/D populations vs velocity, VAF / interval
VAF, temperatures, anisotropy relaxation, g(r), tagged moments — one
panel per observable, skipping files that aren't present.  Works on any
family's output (cooling, tagging, transport, three-state).

CLI: ``mdqt-torch plot <job_dir> [-o out.png]`` (or ``python -m
mdqtplasmasims_torch.quicklook``).  matplotlib is imported lazily, in
:func:`render` only, so the simulation paths never pay for it and
:func:`collect_panels` runs where matplotlib is not installed.

The port's own copy of ``mdqtplasmasims_tpu/quicklook.py``: the same
panels from the same files.
"""

from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np

# categorical palette (validated light-mode slots; X/Y/Z and S/P/D use
# the first three, which pass all-pairs CVD checks)
C = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4"]
INK, MUTED = "#0b0b0b", "#52514e"


def _style(ax, xlabel="", ylabel=""):
    ax.grid(True, alpha=0.25, linewidth=0.6)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    ax.set_xlabel(xlabel, color=MUTED, fontsize=9)
    ax.set_ylabel(ylabel, color=MUTED, fontsize=9)
    ax.tick_params(labelsize=8, colors=MUTED)


def _load(path, time_indexed: bool = False):
    try:
        a = np.loadtxt(path, ndmin=2)
    except Exception:
        return None
    if not a.size:
        return None
    if time_indexed and a.shape[0] > 1:
        # .dat streams are append-mode (reference convention); when a
        # directory holds several appended runs, quicklook shows the
        # most recent one — the last segment with monotone time
        restarts = np.flatnonzero(np.diff(a[:, 0]) < 0)
        if restarts.size:
            a = a[restarts[-1] + 1:]
    return a


def _latest(directory, pattern):
    """Newest snapshot file by the %06d counter in its name."""
    hits = []
    for p in glob.glob(os.path.join(directory, pattern)):
        m = re.search(r"(\d+)\.dat$", p)
        if m:
            hits.append((int(m.group(1)), p))
    return max(hits)[1] if hits else None


def _earliest(directory, pattern):
    """First snapshot by the same numeric-counter key as :func:`_latest`
    (a lexicographic sort would mislabel unpadded/mixed-width counters,
    e.g. 900 vs 1000)."""
    hits = []
    for p in glob.glob(os.path.join(directory, pattern)):
        m = re.search(r"(\d+)\.dat$", p)
        if m:
            hits.append((int(m.group(1)), p))
    return min(hits)[1] if hits else None


def collect_panels(d: str):
    """[(title, plot_fn)] for every recognized observable present."""
    panels = []

    e = _load(os.path.join(d, "energies.dat"), time_indexed=True)
    if e is not None and e.shape[1] >= 4:
        def ekin(ax, e=e):
            for k, lab in enumerate("xyz"):
                ax.plot(e[:, 0], e[:, 1 + k], color=C[k], lw=1.4,
                        label=f"Ekin {lab}")
            ax.legend(frameon=False, fontsize=8)
            _style(ax, "t [1/omega_E]", "Ekin per axis [E_c]")
        panels.append(("Kinetic energies", ekin))
        if e.shape[1] >= 6:
            def audit(ax, e=e):
                ax.plot(e[:, 0], e[:, 5], color=C[0], lw=1.4)
                ax.axhline(0.0, color=MUTED, lw=0.8, ls=":")
                _style(ax, "t [1/omega_E]", "E(t) - E(0) [E_c]")
            panels.append(("Energy audit (cooling removes energy)",
                           audit))
    elif e is not None:        # three-state layout: t, Ekin
        def ekin1(ax, e=e):
            ax.plot(e[:, 0], e[:, 1], color=C[0], lw=1.4)
            _style(ax, "t [1/gamma]", "Ekin x")
        panels.append(("Kinetic energy", ekin1))

    vp = _latest(d, "vel_distX_time*.dat")
    if vp:
        first = _earliest(d, "vel_distX_time*.dat")
        series = [(vp, C[0], "last sample")]
        if first != vp:
            series.insert(0, (first, C[2], "first sample"))
        def veldist(ax, series=series):
            for p, c, lab in series:
                a = _load(p)
                if a is None:
                    continue
                ax.plot(a[:, 0], a[:, 1], color=c, lw=1.4, label=lab)
            ax.legend(frameon=False, fontsize=8)
            _style(ax, "v_x [a omega_E]", "P(v_x)")
        panels.append(("Velocity distribution (x)", veldist))

    sp = _latest(d, "statePopulationsVsVTime*.dat")
    spa = _load(sp) if sp else None
    if spa is not None and spa.shape[1] >= 2:
        def pops(ax, a=spa):
            o = np.argsort(a[:, 0])
            for k, lab in enumerate(("S", "P", "D")[:a.shape[1] - 1]):
                ax.plot(a[o, 0], a[o, 1 + k], ".", color=C[k], ms=2,
                        alpha=0.5, label=lab)
            leg = ax.legend(frameon=False, fontsize=8, markerscale=4)
            for h in leg.legend_handles:
                h.set_alpha(1.0)
            _style(ax, "v_x [a omega_E]", "population")
        panels.append(("State populations vs velocity (last sample)",
                       pops))

    # numeric-counter order, not lexicographic — interval10 must not
    # sort between interval1 and interval2 (same pitfall as _earliest);
    # names without a trailing counter (e.g. VAF_interval_old.dat) are
    # dropped rather than crashing the render
    vaf_hits = [(p, re.search(r"(\d+)\.dat$", p))
                for p in glob.glob(os.path.join(d, "VAF_interval*.dat"))]
    vafs = sorted((p for p, m in vaf_hits if m),
                  key=lambda p: int(re.search(r"(\d+)\.dat$", p).group(1)))[:4]
    if not vafs and os.path.exists(os.path.join(d, "VAF.dat")):
        vafs = [os.path.join(d, "VAF.dat")]
    if vafs:
        def vaf(ax, vafs=vafs):
            for k, p in enumerate(vafs):
                a = _load(p)
                if a is None:
                    continue
                lab = (re.search(r"(interval\d+)", p).group(1)
                       if "interval" in p else "VAF")
                ax.plot(a[:, 0], a[:, 1], color=C[k % len(C)], lw=1.4,
                        label=lab)
            if len(vafs) > 1:
                ax.legend(frameon=False, fontsize=8)
            _style(ax, "t [1/omega_E]", "<v(t0).v(t)>")
        panels.append(("Velocity autocorrelation", vaf))

    ta = _load(os.path.join(d, "TemperaturesAlongAxesInstantaneous.dat"),
               time_indexed=True)
    if ta is not None and ta.shape[1] >= 4:
        def aniso(ax, ta=ta):
            for k, lab in enumerate("xyz"):
                ax.plot(ta[:, 0], ta[:, 1 + k], color=C[k], lw=1.4,
                        label=f"T{lab}")
            ax.legend(frameon=False, fontsize=8)
            _style(ax, "t [1/omega_E]", "T per axis [1/Gamma]")
        panels.append(("Temperature-anisotropy relaxation", aniso))
    else:
        tmp = _load(os.path.join(d, "temperature.dat"))
        if tmp is not None:
            def temp(ax, a=tmp):
                ax.plot(np.arange(a.shape[0]), a[:, 0], color=C[0],
                        lw=1.4)
                _style(ax, "recording sample", "T [1/Gamma]")
            panels.append(("Temperature", temp))

    gr = _latest(d, "pairPairCorrStepNum*.dat")
    gra = _load(gr) if gr else None
    if gra is not None and gra.shape[1] >= 2:
        def grp(ax, a=gra):
            ax.plot(a[:, 0], a[:, 1], color=C[0], lw=1.4)
            ax.axhline(1.0, color=MUTED, lw=0.8, ls=":")
            _style(ax, "r [a]", "g(r)")
        panels.append(("Pair correlation (last record)", grp))

    tm = _load(os.path.join(d, "taggedMoments.dat"), time_indexed=True)
    if tm is not None and tm.shape[1] >= 3:
        def tagged(ax, tm=tm):
            ax.plot(tm[:, 0], tm[:, 1], color=C[0], lw=1.4,
                    label="tagged <v>")
            ax.plot(tm[:, 0], tm[:, 2], color=C[1], lw=1.4,
                    label="tagged <v^2>")
            ax.legend(frameon=False, fontsize=8)
            _style(ax, "t [1/omega_E]", "tagged moments")
        panels.append(("Tagged-subset moments", tagged))

    return panels


def render(job_dir: str, out: str | None = None) -> str:
    """Render the quicklook PNG for ``job_dir``; returns the output path.

    Raises ``ValueError`` if the directory holds no recognized
    observable files."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = job_dir.rstrip("/")
    panels = collect_panels(d)
    if not panels:
        raise ValueError(f"no recognized .dat observables under {d}")
    ncols = 2
    nrows = -(-len(panels) // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(5.2 * ncols, 3.2 * nrows))
    axes = np.atleast_1d(axes).ravel()
    for ax in axes[len(panels):]:
        ax.set_visible(False)
    for (title, fn), ax in zip(panels, axes):
        fn(ax)
        ax.set_title(title, fontsize=10, color=INK, loc="left")
    fig.suptitle(os.path.relpath(d), fontsize=9, color=MUTED, y=0.995)
    fig.tight_layout()
    out = out or os.path.join(d, "quicklook.png")
    fig.savefig(out, dpi=150, facecolor="#fcfcfb")
    plt.close(fig)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("job_dir")
    ap.add_argument("-o", "--out", default=None,
                    help="output PNG (default <job_dir>/quicklook.png)")
    args = ap.parse_args(argv)
    try:
        print(render(args.job_dir, args.out))
    except ValueError as e:
        raise SystemExit(str(e))


if __name__ == "__main__":
    main()
