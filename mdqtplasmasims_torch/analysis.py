"""Offline ensemble aggregation.

The reference's statistics are aggregated across SLURM job directories
offline (README.md:61-67: "average the quantities recorded in each job
subfolder").  These helpers do that over the parameter-encoded directory
tree written by the experiments (same layout as the reference).

The port's own copy of ``mdqtplasmasims_tpu/analysis.py``.  It stays numpy
on the host: offline analysis never dispatches to a device, so reading a
tree needs neither torch's CUDA nor a card.  It reads through the port's
``io.datfiles.read_rows`` and ``io.checkpoint``; ``mdqt-torch analyze``
runs :func:`analyze_job` (or :func:`analyze_ensemble` on a directory of
``job*`` subdirectories).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .io.datfiles import read_rows


def job_dirs(param_dir: str) -> List[str]:
    """All job subdirectories of one parameter directory, sorted by job."""
    dirs = glob.glob(os.path.join(param_dir, "job*"))
    return sorted(dirs, key=lambda d: int(d.rsplit("job", 1)[-1] or 0))


def average_dat(param_dir: str, name: str,
                jobs: Optional[Sequence[str]] = None) -> np.ndarray:
    """Row-wise ensemble average of one .dat file across jobs.

    The first column (time) is taken from the first job; remaining columns
    are averaged.  Jobs with mismatched row counts are truncated to the
    shortest (a job killed by walltime produces fewer rows)."""
    dirs = list(jobs) if jobs is not None else job_dirs(param_dir)
    tables = [read_rows(os.path.join(d, name)) for d in dirs
              if os.path.exists(os.path.join(d, name))]
    if not tables:
        raise FileNotFoundError(f"{name} not found under {param_dir}")
    n = min(t.shape[0] for t in tables)
    stack = np.stack([t[:n] for t in tables])
    out = stack.mean(axis=0)
    out[:, 0] = stack[0, :, 0]
    return out


def stack_dat(param_dir: str, name: str) -> np.ndarray:
    """[n_jobs, rows, cols] stack of one .dat file across jobs."""
    dirs = job_dirs(param_dir)
    tables = [read_rows(os.path.join(d, name)) for d in dirs
              if os.path.exists(os.path.join(d, name))]
    n = min(t.shape[0] for t in tables)
    return np.stack([t[:n] for t in tables])


def ensemble_energies(param_dir: str) -> Dict[str, np.ndarray]:
    """Averaged energies.dat with named columns (cooling-family schema:
    t, EkinX, EkinY, EkinZ, Epot, dE, vxAvg — README.md:103-110)."""
    avg = average_dat(param_dir, "energies.dat")
    cols = ["t", "ekin_x", "ekin_y", "ekin_z", "epot", "de", "vx_avg"]
    return {c: avg[:, i] for i, c in enumerate(cols[:avg.shape[1]])}


def ensemble_temperature_curve(param_dir: str) -> np.ndarray:
    """[T, 2] (t, T_total) from averaged energies: T = 2/3 sum Ekin per
    axis (plasma units, T in units of E_c/k_B)."""
    e = ensemble_energies(param_dir)
    t_total = (2.0 / 3.0) * (e["ekin_x"] + e["ekin_y"] + e["ekin_z"])
    return np.stack([e["t"], t_total], axis=-1)


# ------------------------------------------------------- pooled statistics
# Shared by the tools/cross_validate_* harnesses (and usable for any
# job-pool comparison): the reference's production runs are ensembles of
# independent SLURM jobs, so statistical parity claims are made on pooled
# per-job observables with two-sample z-scores.

def two_sample_z(a, b) -> float:
    """Two-sample z-statistic for the difference of means of two
    equal-purpose job pools (per-job observables; unequal sizes fine).
    Scalar inputs of shape [k]; ~N(0,1) under the null for k >= ~8."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    return float((a.mean() - b.mean()) / max(se, 1e-12))


def two_sample_z_columns(a, b) -> np.ndarray:
    """Column-wise two-sample z for [k, m] pools (e.g. a per-time-bin
    observable across jobs)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    se = np.sqrt(a.var(0, ddof=1) / a.shape[0]
                 + b.var(0, ddof=1) / b.shape[0])
    return (a.mean(0) - b.mean(0)) / np.maximum(se, 1e-12)


def weighted_pooled_mean(values, weights) -> float:
    """Pool per-job means with per-job weights (e.g. tagged-ion moments
    weighted by each job's tagged count, so jobs that tagged more ions
    count proportionally — the estimator of the all-ions-pooled mean)."""
    v = np.asarray(values, np.float64)
    w = np.asarray(weights, np.float64)
    return float((w * v).sum() / w.sum())


def compare_job_pools(refs: Sequence[dict], fws: Sequence[dict],
                      keys: Sequence[str], z_max: float = 3.0,
                      indent: str = "  ") -> bool:
    """Print the per-observable pooled comparison table the validation
    harnesses share and return whether every |z| < ``z_max``.  ``refs``/
    ``fws`` are per-job observable dicts."""
    ok = True
    print(f"{indent}{'observable':10s} {'ref (mean+-sd)':>22s} "
          f"{'framework':>22s} {'z':>6s}")
    for key in keys:
        a = np.array([r[key] for r in refs], np.float64)
        b = np.array([f[key] for f in fws], np.float64)
        z = two_sample_z(a, b)
        print(f"{indent}{key:10s} {a.mean():+11.4f} +- "
              f"{a.std(ddof=1):6.4f} {b.mean():+11.4f} +- "
              f"{b.std(ddof=1):6.4f} {z:+6.2f}")
        ok &= abs(z) < z_max
    return bool(ok)


def sweep_table(member_cfgs: Sequence, values: Sequence[float],
                keys: Sequence[str]) -> List[dict]:
    """Pool a per-member scalar observable of a ``run_sweep`` over its
    ``jobs_per_point`` replicas.

    ``member_cfgs`` is the config list every run_sweep returns (point-
    major), ``values`` one scalar per member (same order), ``keys`` the
    swept config fields to group by (e.g. ``("detuning",)`` or
    ``("gamma", "kappa")``).  Returns one dict per sweep point, in first-
    appearance order: the key fields plus ``mean``/``sd``/``n`` — the
    curve a parameter study plots (tag fraction vs detuning, VAF decay
    vs Gamma, ...)."""
    groups: Dict[tuple, List[float]] = {}
    order: List[tuple] = []
    for mcfg, val in zip(member_cfgs, values):
        pt = tuple(getattr(mcfg, k) for k in keys)
        if pt not in groups:
            groups[pt] = []
            order.append(pt)
        groups[pt].append(float(val))
    out = []
    for pt in order:
        vals = np.asarray(groups[pt], np.float64)
        row = dict(zip(keys, pt))
        row.update(mean=float(vals.mean()),
                   sd=float(vals.std(ddof=1)) if len(vals) > 1 else 0.0,
                   n=len(vals))
        out.append(row)
    return out


def state_population_profile(job_dir: str, vel_scale: float = 1.0,
                             vmax: float = 3.0, nbins: int = 30,
                             last_k: int = 5, state_col: int = 2,
                             min_count: int = 10):
    """Bin one state population against folded ion speed from the
    emitted ``statePopulationsVsVTime*.dat`` snapshots of a job
    directory (columns per reference README.md:110-118: 1 velocity,
    2 S, 3 P, 4 D; ``state_col`` is the 0-based column, default P).

    ``vel_scale`` converts the file's plasma-unit velocities (multiply
    by ``QTEngine.plas_to_quant_vel`` for gamma/k units).  Pools the
    last ``last_k`` snapshots.  Returns ``(bin_centers, profile)`` with
    NaN where a bin has fewer than ``min_count`` ions.  Dips in the P
    profile mark dark states (thesis 4.5); the two-photon resonance
    sits at v = (detDP - detSP)/(1 + kRat)."""
    files = sorted(glob.glob(os.path.join(
        job_dir, "statePopulationsVsVTime*.dat")))[-last_k:]
    if not files:
        raise FileNotFoundError(
            f"no statePopulationsVsVTime*.dat under {job_dir}")
    rows = np.concatenate([np.atleast_2d(np.loadtxt(f)) for f in files])
    v = np.abs(rows[:, 0]) * vel_scale
    pop = rows[:, state_col]
    bins = np.linspace(0.0, vmax, nbins + 1)
    which = np.digitize(v, bins)
    prof = np.array([pop[which == i].mean()
                     if (which == i).sum() >= min_count else np.nan
                     for i in range(1, len(bins))])
    return 0.5 * (bins[1:] + bins[:-1]), prof


def lccf_spectrum(job_dir: str, timestep: float = 0.002,
                  max_shell: Optional[int] = None, skip: int = 0):
    """Longitudinal AND transverse current power spectra and dispersion
    from the emitted ``J_interval0.dat``.

    The reference computes and stores the Fourier-space ion current
    J(k, t) on an integer-k grid (``LCCF``/``printJ``,
    laserCoolingPlusExpansionMDQTSpeedUp.cpp:1040-1092; active call
    sites in the pre-SpeedUp program,
    LaserCoolingPlusExpansionMDQT.cpp:1252-1254) and leaves the spectral
    analysis to the user.  This completes the pipeline: the Hann-windowed
    FFT power of the longitudinal projection J_L(k,t) = k_hat . J(k,t),
    shell-averaged over equal integer |k|^2, whose peak frequency per
    shell is the plasma's longitudinal collective-mode dispersion
    omega_L(k) (the k -> 0 limit is the plasmon at omega_pl = sqrt(3)
    omega_E in Einstein-frequency units; screening bends it down at
    finite k) — plus the same analysis of the transverse residual
    J_T = J - (k_hat.J) k_hat, whose peak is the shear-wave dispersion
    omega_T(k).  Transverse sound only propagates in the strongly
    coupled regime (Gamma >~ 5; below that the shear spectrum peaks at
    omega = 0), so the two branches together diagnose where a run sits
    relative to the liquid/gas crossover from one recorded file.

    ``timestep`` is the MD step in omega_E^-1 (the file's first column
    counts MD steps, so the sample spacing is read off the data).
    Returns a dict with ``k_int2`` [n_shells] integer |k|^2 per shell,
    ``k`` [n_shells] the integer-k magnitude |n| = L*|k|/(2*pi),
    ``omega`` [n_freq] the positive angular-frequency grid in omega_E,
    ``spectrum``/``spectrum_t`` [n_shells, n_freq] (transverse is the
    per-polarization mean over the two shear polarizations), and
    ``omega_peak``/``omega_peak_t`` [n_shells].  ``omega_peak_t`` is 0
    where the shear spectrum's maximum sits in the FIRST nonzero bin:
    an overdamped (Lorentzian-at-0) spectrum is monotone in omega, and
    after mean subtraction + windowing its power lands exactly there,
    so "peak at bin 1" and "no propagating mode" are indistinguishable
    at the window's resolution — 0 is the honest report."""
    rows = read_rows(os.path.join(job_dir, "J_interval0.dat"))
    # append-mode files can hold several runs (the reference's fopen
    # "a" convention); the step counter resets at each restart.  Keep
    # the newest run only — averaging dt across the reset and FFTing a
    # discontinuous two-trajectory series would be silently wrong.
    resets = np.flatnonzero(np.diff(rows[:, 0]) < 0)
    if resets.size:
        rows = rows[resets[-1] + 1:]
    steps = rows[:, 0]
    # the file is written as one fixed-order k-block per sample
    changes = np.flatnonzero(np.diff(steps) != 0)
    K = int(changes[0] + 1) if changes.size else rows.shape[0]
    if rows.shape[0] % K:
        raise ValueError(f"J_interval0.dat rows {rows.shape[0]} not a "
                         f"multiple of the k-block size {K}")
    S = rows.shape[0] // K
    blocks = rows.reshape(S, K, rows.shape[1])
    # restart boundaries that do NOT reset the counter: a resumed run can
    # replay the checkpointed sample (duplicate step at the splice) or
    # continue at a different cadence.  Drop exact-duplicate blocks, then
    # require a uniform step delta — FFTing a mixed-cadence series would
    # be silently wrong.
    deltas = np.diff(blocks[:, 0, 0])
    if np.any(deltas == 0):
        blocks = blocks[np.concatenate(([True], deltas != 0))]
        S = blocks.shape[0]
        deltas = np.diff(blocks[:, 0, 0])
    if deltas.size and not np.all(deltas == deltas[0]):
        bad = int(np.flatnonzero(deltas != deltas[0])[0])
        raise ValueError(
            f"J_interval0.dat sample cadence changes at sample {bad + 1} "
            f"(step delta {deltas[bad]:g} vs {deltas[0]:g}) — looks like a "
            "resumed run with a different sample frequency; analyze the "
            "segments separately")
    if skip:                       # drop an initial transient (e.g. DIH)
        blocks = blocks[skip:]
        S -= skip
    if S < 8:
        raise ValueError(f"only {S} samples — too few for a spectrum")
    kint = blocks[0, :, 1:4]
    dt = float(deltas[0] if deltas.size else 1.0) * timestep
    J = (blocks[:, :, 4:10:2] + 1j * blocks[:, :, 5:10:2])   # [S, K, 3]

    k2 = (kint ** 2).sum(axis=1).astype(int)
    sel = k2 > 0                                   # k=0 has no k_hat
    if max_shell is not None:
        sel &= k2 <= max_shell
    khat = kint[sel] / np.sqrt(k2[sel])[:, None]
    JL = np.einsum("ska,ka->sk", J[:, sel], khat)       # [S, K']
    JT = J[:, sel] - JL[..., None] * khat[None]         # [S, K', 3]

    omega = 2.0 * np.pi * np.fft.rfftfreq(S, d=dt)
    win = np.hanning(S)

    def folded_power(x):
        # x [S, ...]: J(k,t) is complex per k; fold the two-sided
        # spectrum onto positive omega (statistically symmetric for a
        # stationary current)
        xw = (x - x.mean(axis=0)) * win.reshape(
            (S,) + (1,) * (x.ndim - 1))
        full = np.abs(np.fft.fft(xw, axis=0)) ** 2      # [S, ...]
        power = full[:omega.size].copy()
        pos = np.arange(1, omega.size)
        neg = S - pos
        keep = neg != pos               # even-S Nyquist bin is its own pair
        power[pos[keep]] += full[neg[keep]]
        return power

    power_l = folded_power(JL)                          # [F, K']
    # two shear polarizations: sum component powers (the residual's
    # basis-free invariant), then report the per-polarization mean
    power_t = folded_power(JT).sum(axis=2) / 2.0        # [F, K']

    shells = np.unique(k2[sel])
    shell_avg = lambda p: np.stack(
        [p[:, k2[sel] == s].mean(axis=1) for s in shells])
    spec = shell_avg(power_l)
    spec_t = shell_avg(power_t)
    # longitudinal peak above omega=0 (the DC/hydrodynamic bin is
    # excluded: the plasmon branch never sits at 0); transverse: a max
    # in the first nonzero bin is overdamped relaxation, reported as 0
    omega_peak = omega[1 + spec[:, 1:].argmax(axis=1)]
    idx_t = 1 + spec_t[:, 1:].argmax(axis=1)
    omega_peak_t = np.where(idx_t > 1, omega[idx_t], 0.0)
    return dict(k_int2=shells, k=np.sqrt(shells.astype(float)),
                omega=omega, spectrum=spec, omega_peak=omega_peak,
                spectrum_t=spec_t, omega_peak_t=omega_peak_t)


def green_kubo_diffusion(vaf, *, plateau_frac: float = 0.25) -> dict:
    """Self-diffusion coefficient from the VAF via Green-Kubo:
    D(t) = (1/3) int_0^t <v(0).v(t')> dt'.

    The reference's transport program records the VAF
    (recordVAF, MonteCarloFollowedByMDAndTempAnisotropy.cpp:655-693 —
    the 3-axis sum per ion, so VAF(0) = 3/Gamma in plasma units) and
    leaves the transport coefficient to the user; this completes the
    pipeline.  ``vaf`` is the VAF.dat content — an [T, 2] array of
    (t, VAF) rows, or a path to the file.

    Interval-VAF files hold several appended segments (the reference
    restarts the correlation window per interval and appends, each
    segment's time axis starting at its interval's absolute start —
    frozen-tag VAF.dat, VAF_interval*.dat across restarts).  Segments
    are split at time-axis resets, rebased to lag tau = t - t0, and
    C(tau) is averaged across them before integrating — the pooled
    Green-Kubo estimator.

    Returns ``t`` [T] (lag), the running integral ``d_of_t`` [T] (units
    a^2 omega_E), the plateau estimate ``d`` (mean of the trailing
    ``plateau_frac`` of the window), ``n_segments``, ``vaf0`` (the
    segment-pooled C(0)), and ``drift`` —
    the relative change of D(t) across that trailing window
    (|last-first|/|d|), a convergence diagnostic: a large drift means
    the VAF has not decayed within the recorded window and ``d`` is
    still truncated."""
    if isinstance(vaf, (str, os.PathLike)):
        vaf = read_rows(os.fspath(vaf), expect_cols=2)
    vaf = np.asarray(vaf, dtype=float)
    if vaf.ndim != 2 or vaf.shape[1] < 2 or vaf.shape[0] < 4:
        raise ValueError("expected [T>=4, 2] rows of (t, VAF)")
    resets = np.flatnonzero(np.diff(vaf[:, 0]) < 0)
    segs = np.split(vaf, resets + 1)
    n = min(s.shape[0] for s in segs)
    if n < 4:
        raise ValueError(f"VAF segments as short as {n} rows — need >= 4")
    lag = segs[0][:n, 0] - segs[0][0, 0]
    # interval starts need not sit on the sampling grid (the window
    # opens mid-step), so per-segment lags can differ by a sub-spacing
    # offset; only a genuinely different cadence (which diverges past a
    # spacing fraction) is unpoolable
    tol = 0.26 * float(np.median(np.diff(lag))) if n > 1 else 0.0
    for s in segs[1:]:
        if not np.allclose(s[:n, 0] - s[0, 0], lag, rtol=0.0, atol=tol):
            raise ValueError(
                "appended VAF segments have mismatched lag grids — "
                "analyze the segments separately")
    dt = np.diff(lag)
    if np.any(dt <= 0):
        raise ValueError("VAF lag axis is not strictly increasing "
                         "within a segment")
    c = np.mean([s[:n, 1] for s in segs], axis=0)
    d_of_t = np.concatenate(
        [[0.0], np.cumsum(0.5 * (c[1:] + c[:-1]) * dt)]) / 3.0
    k0 = int(round((1.0 - plateau_frac) * (n - 1)))
    window = d_of_t[k0:]
    d = float(window.mean())
    drift = float(abs(window[-1] - window[0]) / (abs(d) or 1.0))
    return dict(t=lag, d_of_t=d_of_t, d=d, drift=drift,
                n_segments=len(segs), vaf0=float(c[0]))


def structure_factor_shells(R, L: float, *, lambda_frac: int = 12,
                            max_shell: Optional[int] = None) -> dict:
    """Static structure factor S(k) on the LCCF's integer-k grid,
    shell-averaged over equal |n|^2.

    Host-side numpy twin of :func:`ops.structure.static_structure_factor`
    so offline analysis never dispatches to a device.  ``R`` is [N, 3]
    positions in units of a; ``L`` the cubic box edge
    (``units.PlasmaUnits.box_length``).  Returns ``k_int2``
    [n_shells] integer |n|^2 per shell, ``k`` [n_shells] = 2 pi |n| / L
    in 1/a, and ``s`` [n_shells]; the k = 0 forward term is dropped."""
    from .ops.structure import k_grid
    R = np.asarray(R, dtype=float)
    kvecs = k_grid(L, lambda_frac)                   # [K, 3]
    n_int = np.rint(kvecs * (L / (2.0 * np.pi))).astype(int)
    k2 = (n_int ** 2).sum(axis=1)
    sel = k2 > 0
    if max_shell is not None:
        sel &= k2 <= max_shell
    rho = np.exp(1j * (R @ kvecs[sel].T)).sum(axis=0)     # [K']
    s = (rho * rho.conj()).real / R.shape[0]
    shells = np.unique(k2[sel])
    s_avg = np.array([s[k2[sel] == q].mean() for q in shells])
    return dict(k_int2=shells,
                k=2.0 * np.pi * np.sqrt(shells.astype(float)) / L,
                s=s_avg)


def structure_factor_from_checkpoint(job_dir: str, *,
                                     n0: Optional[int] = None,
                                     lambda_frac: int = 12,
                                     max_shell: Optional[int] = None
                                     ) -> dict:
    """S(k) shells from a job directory's newest checkpoint positions —
    ASCII (``conditions_timestepXXXXXX.dat``) or native
    (``checkpoint_XXXXXX.npz``), whichever is later (the same
    newest-wins cross-format rule the resume paths use).

    ``n0`` sets the box via ``PlasmaUnits.box_length(n0)`` when the
    configured ion count differs from the realized one (Poissonian-N
    runs sample N around N0 but the cell is sized by N0,
    laserCooling...SpeedUp.cpp:297); by default the row count is used
    (exact for ``exact_n`` runs and the whole transport family)."""
    from .io.checkpoint import (latest_ascii_checkpoint,
                                latest_native_checkpoint, load_native,
                                read_conditions)
    from .units import PlasmaUnits
    ca = latest_ascii_checkpoint(job_dir)
    cn = latest_native_checkpoint(job_dir)
    if ca is None and cn is None:
        raise ValueError(f"{job_dir}: no ions_timestep*.dat or "
                         "checkpoint_*.npz checkpoint to read positions "
                         "from")
    if cn is not None and (ca is None or cn >= ca):
        R, c0 = load_native(job_dir, cn)["R"], cn
    else:
        (R, _), c0 = read_conditions(job_dir, ca), ca
    out = structure_factor_shells(
        R, PlasmaUnits.box_length(n0 if n0 is not None else R.shape[0]),
        lambda_frac=lambda_frac, max_shell=max_shell)
    out["c0"] = c0
    return out


def analyze_job(job_dir: str, *, timestep: float = 0.002,
                max_shell: Optional[int] = None, skip: int = 0) -> dict:
    """One-call numeric summary of everything a job directory's .dat
    output tree supports: energies/audit, per-axis temperatures,
    Green-Kubo diffusion from the VAF, longitudinal + transverse
    collective-mode dispersion from J_interval0.dat, static structure
    from the newest checkpoint, g(r) first peak, tagged moments.

    The reference leaves all post-processing to the user (README.md:
    61-67 stops at "average the quantities recorded in each job
    subfolder"); this is the companion the quicklook plots
    (:mod:`quicklook`) draw from, as numbers.  Every section is gated
    on its file being present and parseable — a partial tree yields a
    partial report plus a ``notes`` list naming what was skipped and
    why, never an exception.  Exposed as ``mdqt-torch analyze``."""
    from .quicklook import _latest, _load

    report: dict = {"job_dir": job_dir, "notes": []}
    if not os.path.isdir(job_dir):
        raise ValueError(f"{job_dir}: not a directory")

    e = _load(os.path.join(job_dir, "energies.dat"), time_indexed=True)
    if e is not None:
        sec = {"n_samples": int(e.shape[0]),
               "t_first": float(e[0, 0]), "t_last": float(e[-1, 0])}
        if e.shape[1] >= 4:
            sec["ekin_final"] = [float(v) for v in e[-1, 1:4]]
            if e.shape[1] >= 6:
                # col 5 is E(t) - E(0): 0 for closed MD, monotone
                # negative while lasers cool (laser_cooling.py writer)
                sec["audit_final"] = float(e[-1, 5])
                sec["audit_max_abs"] = float(np.abs(e[:, 5]).max())
        else:                        # three-state layout: t, EkinX
            sec["ekin_final"] = [float(e[-1, 1])]
        report["energies"] = sec

    ta = _load(os.path.join(job_dir,
                            "TemperaturesAlongAxesInstantaneous.dat"),
               time_indexed=True)
    if ta is not None and ta.shape[1] >= 4:
        tf = ta[-1, 1:4]
        report["temperature"] = {
            "t_final": [float(v) for v in tf],
            "anisotropy_final": float(
                (tf.max() - tf.min()) / (tf.mean() or 1.0)),
            "n_samples": int(ta.shape[0])}
    else:
        tmp = _load(os.path.join(job_dir, "temperature.dat"))
        if tmp is not None:
            report["temperature"] = {"t_final": [float(tmp[-1, 0])],
                                     "n_samples": int(tmp.shape[0])}

    vaf_path = os.path.join(job_dir, "VAF.dat")
    if not os.path.exists(vaf_path):
        vaf_path = _latest(job_dir, "VAF_interval*.dat")
    if vaf_path:
        try:
            gk = green_kubo_diffusion(vaf_path)
            report["diffusion"] = {
                "d": gk["d"], "drift": gk["drift"],
                "n_segments": gk["n_segments"],
                "vaf0": gk["vaf0"],
                "source": os.path.basename(vaf_path)}
        except ValueError as err:
            report["notes"].append(f"diffusion skipped: {err}")

    if os.path.exists(os.path.join(job_dir, "J_interval0.dat")):
        try:
            sp = lccf_spectrum(job_dir, timestep=timestep,
                               max_shell=max_shell, skip=skip)
            report["dispersion"] = {
                "k_int2": [int(q) for q in sp["k_int2"]],
                "omega_peak": [float(v) for v in sp["omega_peak"]],
                "omega_peak_t": [float(v) for v in sp["omega_peak_t"]],
                "d_omega": float(sp["omega"][1] - sp["omega"][0])}
        except ValueError as err:
            report["notes"].append(f"dispersion skipped: {err}")

    try:
        sf = structure_factor_from_checkpoint(job_dir,
                                              max_shell=max_shell)
        i = int(np.argmax(sf["s"]))
        report["structure"] = {
            "s_peak": float(sf["s"][i]), "k_peak": float(sf["k"][i]),
            "checkpoint": int(sf["c0"])}
    except ValueError:
        pass                      # no checkpoint in the tree — common
    except OSError as err:        # half-written checkpoint set (e.g. a
        report["notes"].append(   # crash between write_ions and
            f"structure skipped: {err}")  # write_conditions)

    gr = _latest(job_dir, "pairPairCorrStepNum*.dat")
    gra = _load(gr) if gr else None
    if gra is not None and gra.shape[1] >= 2:
        i = int(np.argmax(gra[:, 1]))
        report["gofr"] = {"peak_g": float(gra[i, 1]),
                          "peak_r": float(gra[i, 0]),
                          "source": os.path.basename(gr)}

    tm = _load(os.path.join(job_dir, "taggedMoments.dat"),
               time_indexed=True)
    if tm is not None and tm.shape[1] >= 3:
        report["tagged"] = {
            "n_samples": int(tm.shape[0]),
            "first": [float(v) for v in tm[0, 1:]],
            "final": [float(v) for v in tm[-1, 1:]]}

    if len(report) == 2:          # only job_dir + notes
        raise ValueError(f"{job_dir}: no recognized .dat output found")
    return report


def format_job_report(report: dict) -> str:
    """Render :func:`analyze_job`'s dict as an aligned text report."""
    L = [f"job: {report['job_dir']}"]
    if "energies" in report:
        s = report["energies"]
        ek = "  ".join(f"{v:.4g}" for v in s["ekin_final"])
        L.append(f"energies     {s['n_samples']} samples, "
                 f"t = {s['t_first']:g} .. {s['t_last']:g};  "
                 f"Ekin final [{ek}]")
        if "audit_final" in s:
            L.append(f"  audit      E(t)-E(0) final {s['audit_final']:+.4g}"
                     f"  (max |.| {s['audit_max_abs']:.4g})")
    if "temperature" in report:
        s = report["temperature"]
        tf = "  ".join(f"{v:.4g}" for v in s["t_final"])
        extra = (f"  anisotropy {s['anisotropy_final']:+.3f}"
                 if "anisotropy_final" in s else "")
        L.append(f"temperature  final [{tf}]{extra}")
    if "diffusion" in report:
        s = report["diffusion"]
        nseg = (f", {s['n_segments']} intervals pooled"
                if s.get("n_segments", 1) > 1 else "")
        L.append(f"diffusion    D = {s['d']:.4g} a^2 omega_E  "
                 f"(plateau drift {100 * s['drift']:.1f}%, "
                 f"VAF(0) = {s['vaf0']:.4g}, {s['source']}{nseg})")
    if "dispersion" in report:
        s = report["dispersion"]
        L.append(f"dispersion   {len(s['k_int2'])} shells, "
                 f"d_omega = {s['d_omega']:.3f} omega_E   "
                 "(omega_T = 0: no propagating shear)")
        L.append("  |n|^2  omega_L  omega_T")
        for q, wl, wt in zip(s["k_int2"], s["omega_peak"],
                             s["omega_peak_t"]):
            L.append(f"  {q:5d}  {wl:7.3f}  {wt:7.3f}")
    if "structure" in report:
        s = report["structure"]
        L.append(f"structure    S(k) peak {s['s_peak']:.3f} at "
                 f"k = {s['k_peak']:.3f}/a  "
                 f"(checkpoint {s['checkpoint']})")
    if "gofr" in report:
        s = report["gofr"]
        L.append(f"g(r)         peak {s['peak_g']:.3f} at "
                 f"r = {s['peak_r']:.3f} a  ({s['source']})")
    if "tagged" in report:
        s = report["tagged"]
        fin = "  ".join(f"{v:.4g}" for v in s["final"])
        L.append(f"tagged       {s['n_samples']} samples, final [{fin}]")
    for n in report.get("notes", []):
        L.append(f"note: {n}")
    return "\n".join(L)


def analyze_ensemble(param_dir: str, **kw) -> dict:
    """:func:`analyze_job` over every ``job*`` subdirectory of one
    parameter directory, plus pooled mean +- sd of the scalar
    observables across jobs (the reference README's "average the
    quantities recorded in each job subfolder", README.md:61-67, as one
    call).  ``kw`` is forwarded to :func:`analyze_job`.

    Returns ``jobs`` (per-job reports, job order) and ``pooled``:
    {section.key: {mean, sd, n}} for every numeric scalar that at least
    two jobs report."""
    dirs = job_dirs(param_dir)
    if not dirs:
        raise ValueError(f"{param_dir}: no job* subdirectories")
    jobs = []
    for d in dirs:
        try:
            jobs.append(analyze_job(d, **kw))
        except ValueError as err:
            jobs.append({"job_dir": d, "notes": [f"skipped: {err}"]})
    pooled: Dict[str, dict] = {}
    scalar_keys = [("diffusion", "d"), ("diffusion", "vaf0"),
                   ("structure", "s_peak"), ("structure", "k_peak"),
                   ("gofr", "peak_g"), ("gofr", "peak_r"),
                   ("energies", "audit_final")]
    for sec, key in scalar_keys:
        vals = np.array([j[sec][key] for j in jobs
                         if sec in j and key in j[sec]], np.float64)
        if len(vals) >= 2:
            pooled[f"{sec}.{key}"] = {
                "mean": float(vals.mean()),
                "sd": float(vals.std(ddof=1)), "n": int(len(vals))}
    return {"param_dir": param_dir, "jobs": jobs, "pooled": pooled}


def format_ensemble_report(report: dict) -> str:
    """Render :func:`analyze_ensemble` as text: the pooled table, then
    each job's report."""
    L = [f"ensemble: {report['param_dir']} "
         f"({len(report['jobs'])} jobs)"]
    if report["pooled"]:
        L.append(f"  {'observable':22s} {'mean':>10s} {'sd':>10s}  n")
        for k, s in report["pooled"].items():
            L.append(f"  {k:22s} {s['mean']:10.4g} {s['sd']:10.4g}  "
                     f"{s['n']}")
    for j in report["jobs"]:
        L.append("")
        L.append(format_job_report(j))
    return "\n".join(L)
