#!/usr/bin/env python3
"""Physics validation of the analysis layer on the PyTorch + CUDA port's
own trajectories: the port's counterpart of ``tools/validate_analysis.py``.

    python tools/torch_validate_analysis.py [--fast] [--out DIR]

The same five sections, with the same sizes, seeds and gates, checked
against independent physics on MD trajectories that the port makes on
one NVIDIA GPU:

A. Green-Kubo D (``analysis.green_kubo_diffusion`` on the VAF of
   ``ops.correlations.power_autocorr``) against the Einstein MSD of the
   same trajectory (:func:`fft_msd`): |ratio - 1| < 0.15.
B. D at kappa = 0.1 against the Hansen-McDonald-Pollock OCP fit
   (:func:`hmp_d`): mid-range ratios in (0.7, 1.4), the exponent over
   Gamma in {5, 10, 20} in (-1.7, -1.0), D(kappa=0.5) > 0.95 D(kappa=0.1)
   at Gamma = 3.
C. S(k) from positions (``analysis.structure_factor_shells``) against the
   Fourier transform of g(r) (``ops.structure.pair_correlation``,
   :func:`sinc_transform_of_g`): binned |dS| < 0.05 over k a in [1.2, 6].
D. The dispersion through a J_interval0.dat file and
   ``analysis.lccf_spectrum``: the lowest four shells' longitudinal peak
   within (0.72, 1.25) of screened Bohm-Gross, no shear peak at Gamma = 3
   and a propagating shear branch at Gamma = 50.
E. Green-Kubo D pooled over a 16-member transport fold
   (``experiments.mc_md_anisotropy.run_ensemble``, seed 21) against the
   compiled reference's pool: |z| < 2.  The reference pool is read from
   ``--xval-workdir`` when it holds one; otherwise its summary statistics
   come from the JAX package's archived run
   (``artifacts/validate_analysis/report.json``), and z from them.

The trajectories (:func:`md_trajectory`) come from a host loop of MD
steps on the device: a cubic lattice, the Metropolis chain, ``equil_steps`` of
velocity Verlet with collisions at frequency 0.25, then ``record_steps``
of NVE recording; every force call is kernel A (``best_forces_fn``).  On
the card R, V and A are float32 (the force kernel is float32); the
recorded V, drifts and R stay on the device in preallocated buffers and
come to the host once.  The analysis (:func:`analyze`) runs in float64
on the host, whatever the trajectories' dtype.

Writes ``report.json`` (the JAX tool's keys, plus the card's name and
power limit, the dtype, each section's wall and the kernels' launches);
exit 0 when every section passes.  Runs on CUDA (exit 2 without a card)
unless ``--device cpu`` is given.  Imports torch, numpy and
``mdqtplasmasims_torch`` (and ``tools/torch_soak.py``'s build, metadata
and launch counters) only.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import torch_soak  # noqa: E402  (puts the repository root on sys.path)

REPO = torch_soak.ROOT
JAX_REPORT = os.path.join(REPO, "artifacts", "validate_analysis",
                          "report.json")

HMP_PREFACTOR = 2.95          # D* = 2.95 Gamma^-1.34, a^2 omega_p units
HMP_EXPONENT = -1.34

DT = 0.005
GAMMA_A, KAPPA_A, SEED_A = 3.0, 0.5, 11      # the soak point: A, C, D, B
GAMMA_SHEAR, SEED_SHEAR = 50.0, 13           # D's transverse branch
KAPPA_B = 0.1                                # B's near-OCP points
B_POINTS = ((3.0, 12), (5.0, 14), (10.0, 15), (20.0, 16))
J_EVERY = 4


def hmp_d(gamma: float) -> float:
    """HMP OCP self-diffusion in this framework's a^2 omega_E units."""
    return math.sqrt(3.0) * HMP_PREFACTOR * gamma ** HMP_EXPONENT


def fft_msd(dr: np.ndarray, dt: float):
    """Multi-origin Einstein MSD via the standard S1 - 2 S2 FFT
    algorithm, summed over the 3 axes.  dr is [T, N, 3] unwrapped
    displacement from t=0; returns (lags, msd[T])."""
    T = dr.shape[0]
    x = dr.reshape(T, -1)                       # [T, N*3]
    # S2(tau) = sum_t x(t) x(t+tau), via rFFT (zero-padded to 2T)
    f = np.fft.rfft(x, n=2 * T, axis=0)
    s2 = np.fft.irfft(f * f.conj(), n=2 * T, axis=0)[:T].real
    sq = (x ** 2)
    css = np.concatenate([np.zeros((1, x.shape[1])),
                          np.cumsum(sq, axis=0)])
    # S1(tau) = sum_{t=0}^{T-1-tau} x(t)^2 + sum_{t=tau}^{T-1} x(t)^2
    tau = np.arange(T)
    head = css[T - tau] - css[0]                # sum_{t<T-tau} x^2
    tail = css[T] - css[tau]                    # sum_{t>=tau} x^2
    s1 = head + tail
    counts = (T - tau)[:, None]
    msd = (s1 - 2.0 * s2) / counts              # per series
    msd = msd.reshape(T, dr.shape[1], 3).sum(axis=2).mean(axis=1)
    return tau * dt, msd


def sinc_transform_of_g(g_quirk: np.ndarray, k: np.ndarray, *,
                        dr: float = 0.05,
                        density: float = 3.0 / (4.0 * np.pi)):
    """S_g(k) = 1 + 4 pi n int r^2 (g-1) sin(kr)/(kr) dr from the
    EMITTED g(r) histogram, undoing the reference's integer-shell
    normalization first: bin i >= 1 divides its count by 3 i^2 dr^3
    instead of the exact shell volume ((i+1)^3 - i^3) dr^3
    (MonteCarlo...cpp:626-635; ops.structure.pair_correlation reproduces
    the quirk bit-for-bit), a (1 + 1/i)^2-level multiplicative bias that
    matters at this check's accuracy.  Each bin contributes its exact
    shell integral with the sinc kernel evaluated at the bin's
    volume-centroid radius."""
    i = np.arange(1, g_quirk.shape[0])           # bin 0 is exact & g~0
    shell = ((i + 1) ** 3 - i ** 3) * dr ** 3    # exact /(4 pi / 3)
    g_true = g_quirk[1:] * (3.0 * i ** 2) / ((i + 1) ** 3 - i ** 3)
    r_c = 0.75 * ((i + 1) ** 4 - i ** 4) / ((i + 1) ** 3 - i ** 3) * dr
    h = g_true - 1.0
    out = np.empty_like(k)
    vol = (4.0 * np.pi / 3.0) * shell            # exact shell volumes
    for j, kk in enumerate(k):
        kern = np.sin(kk * r_c) / (kk * r_c)
        out[j] = 1.0 + density * np.sum(vol * h * kern)
    return out


def summary_z(m_ref: float, s_ref: float, k_ref: int, m_fw: float,
              s_fw: float, k_fw: int) -> float:
    """``analysis.two_sample_z`` from the two pools' means, sample standard
    deviations (ddof 1) and sizes."""
    se = math.sqrt(s_ref ** 2 / k_ref + s_fw ** 2 / k_fw)
    return float((m_ref - m_fw) / max(se, 1e-12))


# ---- the trajectories

def md_trajectory(n: int, gamma: float, kappa: float, *, mc_steps: int,
                  equil_steps: int, record_steps: int, seed: int,
                  dt: float = DT, device="cuda", dtype=torch.float32,
                  cache_dir=None):
    """Equilibrated NVE Yukawa trajectory on ``device`` in ``dtype``:
    :func:`chain_start` then :func:`md_record`, every draw from one
    generator on ``device`` seeded with ``seed``.  Returns what
    :func:`md_record` returns.  ``cache_dir`` keeps each trajectory in an
    ``.npz`` keyed by its parameters, the device type and the dtype."""
    from mdqtplasmasims_torch.core.draws import MemberDraws

    device = torch.device(device)
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(
            cache_dir, f"traj_n{n}_g{gamma:g}_k{kappa:g}_mc{mc_steps}_"
                       f"eq{equil_steps}_r{record_steps}_s{seed}_"
                       f"dt{dt:g}_{device.type}_"
                       f"{str(dtype).split('.')[-1]}.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                return (z["vs"], z["dr"], z["rs"], float(z["L"]),
                        float(z["t"]))
    draws = MemberDraws([torch.Generator(device=device).manual_seed(seed)])
    R, V = chain_start(n, gamma, kappa, mc_steps, draws, device, dtype)
    out = md_record(R, V, gamma, kappa, equil_steps=equil_steps,
                    record_steps=record_steps, draws=draws, dt=dt)
    if cache:
        tmp = cache + ".tmp.npz"
        vs, dr, rs, L, t_rec = out
        np.savez(tmp, vs=vs, dr=dr, rs=rs, L=L, t=t_rec)
        os.replace(tmp, cache)
    return out


def chain_start(n: int, gamma: float, kappa: float, mc_steps: int, draws,
                device, dtype):
    """The start of a trajectory: a cubic lattice with MB velocities, then
    ``mc_steps`` Metropolis moves at (L, 1/kappa, Gamma).  ``draws`` gives
    the velocities' normals and the chain's draws (``core/draws.
    MemberDraws``' ``start_v`` and ``mc``, a member axis of one).
    Returns ``(R, V)`` ``[n, 3]`` on ``device``."""
    from mdqtplasmasims_torch.core.init import lattice_init
    from mdqtplasmasims_torch.core.mc import MetropolisMC
    from mdqtplasmasims_torch.units import PlasmaUnits
    L = PlasmaUnits.box_length(n)
    R, V = lattice_init(None, n, gamma, L, dtype=dtype, device=device,
                        V=draws.start_v(n, dtype)[0])
    mc = MetropolisMC(L=L, ldeb=1.0 / kappa, gamma=gamma)
    R, _ = mc.run(R, draws=draws.mc(mc_steps, n, dtype))
    return R, V


def md_record(R: torch.Tensor, V: torch.Tensor, gamma: float, kappa: float,
              *, equil_steps: int, record_steps: int, draws,
              dt: float = DT):
    """``equil_steps`` of velocity Verlet with collisions at frequency 0.25,
    then ``record_steps`` of collisionless recording, from ``(R, V)
    [n, 3]`` on their device and in their dtype; every force call is
    ``best_forces_fn``'s (kernel A on the card).  ``draws.md_step`` gives
    each step's collision draws (none while recording; a replay of
    another implementation's key chain advances it every step).  The
    recorded V, drifts and R stay on the device until the end.

    Returns host arrays vstore [T, N, 3], unwrapped displacements
    dr [T, N, 3] (the float64 running sum of the exact velocity-Verlet
    drifts, for the Einstein MSD), wrapped positions R [T, N, 3], the box
    length and the realized recording temperature (float64)."""
    from mdqtplasmasims_torch.core.md import wrap_pbc
    from mdqtplasmasims_torch.core.thermostat import collide_and_kick
    from mdqtplasmasims_torch.ops.yukawa import best_forces_fn
    from mdqtplasmasims_torch.units import PlasmaUnits
    n = R.shape[0]
    L = PlasmaUnits.box_length(n)
    forces = best_forces_fn(n, L, 1.0 / kappa)
    A = forces(R)[0]
    vs, drifts, rs = (torch.empty((record_steps, n, 3), dtype=R.dtype,
                                  device=R.device) for _ in range(3))
    for k in range(equil_steps + record_steps):
        collide = k < equil_steps
        kicks = draws.md_step(n, R.dtype, collide)
        drift = dt * V + 0.5 * dt * dt * A
        R = wrap_pbc(R + drift, L)
        A_new = forces(R)[0]
        V = V + 0.5 * dt * (A + A_new)
        if collide:
            V = collide_and_kick(V, (kicks[0][0], kicks[1][0]), dt=dt,
                                 collision_freq=0.25, gamma=gamma)
        else:
            t = k - equil_steps
            vs[t].copy_(V)
            drifts[t].copy_(drift)
            rs[t].copy_(R)
        A = A_new
    vs, drifts, rs = (x.cpu().numpy() for x in (vs, drifts, rs))
    dr = np.cumsum(drifts, axis=0, dtype=np.float64)   # exact VV displacement
    t_rec = float((vs.astype(np.float64) ** 2).mean())  # <v_axis^2> = T
    return vs, dr, rs, L, t_rec


def sizes(args) -> dict:
    """The trajectories' sizes: the recorded validation's, or
    ``--fast``'s."""
    fast = args.fast
    return dict(n=216 if fast else 512,
                record_steps=1200 if fast else args.record_steps,
                mc_steps=6_000 if fast else 30_000,
                mc_steps_shear=6_000 if fast else 60_000)


def trajectory_plan(args) -> dict:
    """``(Gamma, kappa, seed) -> md_trajectory`` keywords of every
    trajectory the sections in ``args.sections`` read (B also reads A's)."""
    s = sizes(args)
    rec, mc = s["record_steps"], s["mc_steps"]
    plan = {(GAMMA_A, KAPPA_A, SEED_A): dict(mc_steps=mc, equil_steps=400,
                                             record_steps=rec)}
    if "D" in args.sections:
        plan[(GAMMA_SHEAR, KAPPA_A, SEED_SHEAR)] = dict(
            mc_steps=s["mc_steps_shear"], equil_steps=800,
            record_steps=2 * rec)
    if "B" in args.sections:
        for g, seed in B_POINTS:
            plan[(g, KAPPA_B, seed)] = dict(mc_steps=mc, equil_steps=400,
                                            record_steps=rec)
    return plan


def make_trajectories(args, device, dtype, cache_dir=None):
    """Every trajectory of :func:`trajectory_plan`: ``(trajs, info)``,
    ``trajs`` mapping ``(Gamma, kappa, seed)`` to ``md_trajectory``'s
    tuple, ``info`` one dict a trajectory (its sizes, realized
    temperature and host-clock wall from a synced card)."""
    n = sizes(args)["n"]
    trajs, info = {}, []
    for (g, kappa, seed), kw in trajectory_plan(args).items():
        _sync(device)
        t0 = time.perf_counter()
        trajs[(g, kappa, seed)] = md_trajectory(
            n, g, kappa, seed=seed, dt=DT, device=device, dtype=dtype,
            cache_dir=cache_dir, **kw)
        t_rec = trajs[(g, kappa, seed)][4]
        info.append(dict(gamma=g, kappa=kappa, seed=seed, n=n, **kw,
                         t_rec=t_rec, wall_s=time.perf_counter() - t0))
        print(f"[md] N={n} Gamma={g} kappa={kappa} seed={seed}: "
              f"{kw['record_steps']} recording steps, T_rec={t_rec:.4f} "
              f"(nominal {1 / g:.4f}), {info[-1]['wall_s']:.1f}s",
              flush=True)
    return trajs, info


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---- the analysis (float64 on the host)

def _f64(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float64))


def vaf_of(vs: np.ndarray, gamma: float) -> np.ndarray:
    """The VAF (``power_autocorr`` of power 1) of ``vs [T, N, 3]``."""
    from mdqtplasmasims_torch.ops.correlations import power_autocorr
    return power_autocorr(_f64(vs), 1, gamma).numpy()


def write_j_file(job: str, rs: np.ndarray, vs: np.ndarray, L: float,
                 j_every: int = J_EVERY) -> None:
    """J(k, t) of every ``j_every``-th frame on the 12^3 integer-k grid,
    written as ``job/J_interval0.dat`` in the reference's row layout
    (step, kx, ky, kz, then Re/Im of J_x, J_y, J_z; ``%.8g``, tabs)."""
    from mdqtplasmasims_torch.ops.structure import current_fourier, k_grid
    shutil.rmtree(job, ignore_errors=True)
    os.makedirs(job)
    kv = _f64(k_grid(L, 12))
    ks = np.stack(np.meshgrid(np.arange(12), np.arange(12),
                              np.arange(12), indexing="ij"),
                  -1).reshape(-1, 3)
    rows = []
    for j in range(0, rs.shape[0], j_every):
        J = current_fourier(_f64(rs[j]), _f64(vs[j]), kv).numpy()
        rows.append(np.concatenate([
            np.full((kv.shape[0], 1), j), ks,
            np.stack([J[0].real, J[0].imag, J[1].real, J[1].imag,
                      J[2].real, J[2].imag], -1)], axis=1))
    np.savetxt(os.path.join(job, "J_interval0.dat"),
               np.concatenate(rows), fmt="%.8g", delimiter="\t")


def section_a(traj, gamma: float) -> tuple:
    """A: Green-Kubo D against the Einstein MSD of the same trajectory.
    Returns ``(report entry, gk dict)``."""
    from mdqtplasmasims_torch.analysis import green_kubo_diffusion
    vs, dr, _, _, t_rec = traj
    rec = vs.shape[0]
    vaf = vaf_of(vs, gamma)
    lags = np.arange(rec) * DT
    # integrate only to the converged window (VAF decayed; the tail of
    # the FFT estimator is noise-dominated) — use the first half
    w = rec // 2
    gk = green_kubo_diffusion(np.stack([lags[:w], vaf[:w]], -1),
                              plateau_frac=0.3)
    t_m, msd = fft_msd(dr, DT)
    # ballistic -> diffusive crossover: fit the slope over the same
    # trailing window the GK plateau uses
    i0, i1 = int(0.5 * w), w
    slope = np.polyfit(t_m[i0:i1], msd[i0:i1], 1)[0]
    d_msd = slope / 6.0
    ratio = gk["d"] / d_msd
    ok = abs(ratio - 1.0) < 0.15
    print(f"[A] D_GK = {gk['d']:.4f} (drift {gk['drift']*100:.1f}%)  "
          f"D_MSD = {d_msd:.4f}  ratio = {ratio:.3f}  "
          f"{'PASS' if ok else 'FAIL'} (band |ratio-1| < 0.15)")
    return dict(d_gk=gk["d"], d_msd=d_msd, ratio=ratio,
                gk_drift=gk["drift"], t_rec=t_rec, n=vs.shape[1],
                record_steps=rec, ok=bool(ok)), gk


def section_c(traj) -> dict:
    """C: S(k) from positions against the Fourier transform of g(r).
    Individual shells average only a handful of k-vectors over ~15
    structurally independent configurations, so per-shell S_pos carries
    ~0.05-0.1 statistical scatter while the g(r) transform is smooth; a
    normalization/units error is SYSTEMATIC, so the gate compares
    k-binned means, where the scatter averages down."""
    from mdqtplasmasims_torch.analysis import structure_factor_shells
    from mdqtplasmasims_torch.ops.structure import pair_correlation
    _, _, rs, L, _ = traj
    rec = rs.shape[0]
    snaps = rs[:: max(1, rec // 400)]
    s_shells = None
    for R in snaps:
        s = structure_factor_shells(R, L)
        s_shells = (s["s"] if s_shells is None else s_shells + s["s"])
    s_shells /= len(snaps)
    kk = s["k"]
    g_acc = None
    for R in snaps:
        g1 = pair_correlation(_f64(R), L).numpy()
        g_acc = g1 if g_acc is None else g_acc + g1
    g_acc /= len(snaps)
    n_gr = int((L / 2.0) / 0.05)
    s_from_g = sinc_transform_of_g(g_acc[:n_gr], kk)
    # below k ~ 1.2/a the r < L/2 truncation of the (g-1) tail bites;
    # above k ~ 6/a the dr = 0.05 histogram undersamples the sinc
    edges = np.arange(1.2, 6.01, 0.4)
    bins = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (kk >= lo) & (kk < hi)
        if m.sum() >= 2:
            bins.append(dict(k_lo=float(lo), k_hi=float(hi),
                             n=int(m.sum()),
                             ds_mean=float((s_shells[m]
                                            - s_from_g[m]).mean()),
                             s_pos=float(s_shells[m].mean()),
                             s_g=float(s_from_g[m].mean())))
    err = max(abs(b["ds_mean"]) for b in bins)
    rms = float(np.sqrt(np.mean([(b["ds_mean"]) ** 2 for b in bins])))
    ok = err < 0.05
    print(f"[C] S(k) vs FT[g(r)], {len(bins)} k-bins over "
          f"[1.2, 6.0]/a: max |binned dS| = {err:.4f} (rms {rms:.4f})  "
          f"{'PASS' if ok else 'FAIL'} (band < 0.05)")
    return dict(max_abs_err=float(err), rms=rms, bins=bins, ok=bool(ok))


def section_d(traj, traj50, kappa: float, work_dir: str) -> dict:
    """D: the dispersion through the real J_interval0.dat pipeline, and
    the shear branch at Gamma = 50 (a 2x window: the shear mode sits at
    omega ~ 0.3 omega_E, so the frequency bin must be fine enough to
    resolve it above the overdamped-noise floor)."""
    from mdqtplasmasims_torch.analysis import lccf_spectrum
    vs, _, rs, L, t_rec = traj
    job = os.path.join(work_dir, "dispersion_job")
    write_j_file(job, rs, vs, L)
    spec = lccf_spectrum(job, timestep=DT, max_shell=9)
    d_om = float(spec["omega"][1] - spec["omega"][0])
    ok = True
    rows = []
    print("[D] longitudinal dispersion vs screened Bohm-Gross "
          "(lowest 4 shells):")
    for q, kn, pk, pt in list(zip(spec["k_int2"], spec["k"],
                                  spec["omega_peak"],
                                  spec["omega_peak_t"]))[:4]:
        k_phys = 2.0 * np.pi * kn / L
        th = math.sqrt(3.0 * k_phys ** 2 / (k_phys ** 2 + kappa ** 2)
                       + 3.0 * t_rec * k_phys ** 2)
        ratio = pk / th
        ok &= 0.72 < ratio < 1.25
        # transverse at Gamma = 3: no shear peak clear of the first few
        # frequency bins
        ok &= pt <= 2.5 * d_om
        rows.append(dict(n2=int(q), k=float(k_phys), omega_peak=float(pk),
                         omega_theory=float(th), ratio=float(ratio),
                         omega_t=float(pt)))
        print(f"    |n|^2={q:2d}  k={k_phys:.3f}  omega={pk:.3f}  "
              f"theory={th:.3f}  ratio={ratio:.3f}  omega_T={pt:.3f}")
    vs50, _, rs50, L50, t50 = traj50
    print(f"    Gamma=50 run: realized T = {t50:.5f} "
          f"(Gamma_eff {1.0 / t50:.1f})")
    job50 = os.path.join(work_dir, "dispersion_job_g50")
    write_j_file(job50, rs50, vs50, L50)
    spec50 = lccf_spectrum(job50, timestep=DT, max_shell=16)
    d_om50 = float(spec50["omega"][1] - spec50["omega"][0])
    k50 = 2.0 * np.pi * spec50["k"] / L50
    shear = spec50["omega_peak_t"][(k50 > 0.6) & (k50 < 2.5)]
    has_shear = bool((shear > 2.5 * d_om50).any())
    ok &= has_shear
    print(f"    Gamma=50 transverse branch at k~1/a: "
          f"omega_T={[round(float(x), 3) for x in shear[:6]]} -> "
          f"propagating shear {'PASS' if has_shear else 'FAIL'}")
    print(f"[D] dispersion {'PASS' if ok else 'FAIL'} "
          f"(L band [0.72, 1.25]; omega_T = 0 at Gamma=3, > 0 at "
          f"Gamma=50)")
    return dict(rows=rows, gamma50_shear=has_shear,
                gamma50_omega_t=[float(x) for x in shear], ok=bool(ok))


def section_b(trajs, gk_a: dict) -> dict:
    """B: the literature anchor at near-OCP screening (kappa = 0.1)."""
    from mdqtplasmasims_torch.analysis import green_kubo_diffusion
    pts = []
    for g_run, seed in B_POINTS:
        vs1, _, _, _, t1 = trajs[(g_run, KAPPA_B, seed)]
        rec = vs1.shape[0]
        w = rec // 2
        lags = np.arange(rec) * DT
        gk1 = green_kubo_diffusion(
            np.stack([lags[:w], vaf_of(vs1, g_run)[:w]], -1),
            plateau_frac=0.3)
        g_eff = 1.0 / t1
        pts.append(dict(gamma=g_run, gamma_eff=float(g_eff),
                        d=float(gk1["d"]), d_hmp=hmp_d(g_eff),
                        ratio=float(gk1["d"] / hmp_d(g_eff)),
                        drift=float(gk1["drift"])))
        print(f"[B] Gamma={g_run:4.1f} (eff {g_eff:5.2f})  "
              f"D = {gk1['d']:.4f}  HMP = {hmp_d(g_eff):.4f}  "
              f"ratio = {pts[-1]['ratio']:.3f}  "
              f"(drift {gk1['drift']*100:.0f}%)")
    # gate 1: absolute level at the fit's reliable mid-range
    mid = [p for p in pts if p["gamma"] >= 10.0]
    ok = all(0.7 < p["ratio"] < 1.4 for p in mid)
    # gate 2: measured exponent over Gamma_eff in {5,10,20}
    fitpts = [p for p in pts if p["gamma"] >= 5.0]
    lg = np.log([p["gamma_eff"] for p in fitpts])
    ld = np.log([p["d"] for p in fitpts])
    expo = float(np.polyfit(lg, ld, 1)[0])
    ok &= -1.7 < expo < -1.0
    # gate 3: screening direction at fixed Gamma = 3
    screening = gk_a["d"] / pts[0]["d"]
    ok &= screening > 0.95
    print(f"[B] exponent (Gamma_eff >= 5) = {expo:.3f} (HMP -1.34); "
          f"D(kappa=0.5)/D(kappa=0.1) at Gamma=3 = {screening:.3f}; "
          f"mid-range ratios {[round(p['ratio'], 2) for p in mid]}  "
          f"{'PASS' if ok else 'FAIL'}")
    return dict(points=pts, exponent=expo, screening_ratio=float(screening),
                d_kappa05=gk_a["d"], ok=bool(ok))


def analyze(trajs: dict, args) -> dict:
    """Sections A-D (those in ``args.sections``, in the JAX tool's order A,
    C, D, B) on the trajectories ``trajs``: ``(Gamma, kappa, seed) ->
    (vs, dr, rs, L, t_rec)`` numpy, as :func:`md_trajectory` returns them.
    Float64 on the host; the J(k) files go under ``args.work_dir``.
    Returns the report's section entries and ``section_walls_s``."""
    report, walls = {}, {}
    traj = trajs[(GAMMA_A, KAPPA_A, SEED_A)]
    t0 = time.perf_counter()
    report["A_gk_vs_msd"], gk = section_a(traj, GAMMA_A)
    walls["A"] = time.perf_counter() - t0
    if "C" in args.sections:
        t0 = time.perf_counter()
        report["C_sk_gofr"] = section_c(traj)
        walls["C"] = time.perf_counter() - t0
    if "D" in args.sections:
        t0 = time.perf_counter()
        report["D_dispersion"] = section_d(
            traj, trajs[(GAMMA_SHEAR, KAPPA_A, SEED_SHEAR)], KAPPA_A,
            args.work_dir)
        walls["D"] = time.perf_counter() - t0
    if "B" in args.sections:
        t0 = time.perf_counter()
        report["B_hmp_anchor"] = section_b(trajs, gk)
        walls["B"] = time.perf_counter() - t0
    report["section_walls_s"] = walls
    return report


# ---- E: the cross-code Green-Kubo pool

def transport_config(dtype: str, **over):
    """The JAX tool's transport configuration of section E (``over``:
    overrides, for tests at a tiny size)."""
    from mdqtplasmasims_torch.experiments.mc_md_anisotropy import (
        MCTransportConfig)
    return MCTransportConfig(**dict(dict(
        n=512, kappa=0.5, gamma=3.0, density=0.4, mc_steps=30_000,
        gr_every_mc=10_000, pre_record_md_steps=200, record_steps=600,
        gr_every_record=100, instant_aniso_steps=8,
        reequil_steps=8, aniso_time_us=0.1, aniso_relax_steps=8,
        dtype=dtype), **over))


def reference_pool(xval_workdir: str):
    """The reference's pool: ``(k, mean, sd, source)`` from the VAF.dat
    files under ``xval_workdir`` (Green-Kubo on each, at most 16), or from
    the JAX package's archived section E when there are none."""
    from mdqtplasmasims_torch.analysis import green_kubo_diffusion
    ref_glob = os.path.join(xval_workdir, "refdata", "*", "job*", "VAF.dat")
    ref_files = sorted(glob.glob(ref_glob))[:16]
    if ref_files:
        d_ref = []
        for f in ref_files:
            rows = np.loadtxt(f)
            w = rows.shape[0] // 2
            d_ref.append(green_kubo_diffusion(rows[:w],
                                              plateau_frac=0.3)["d"])
        return (len(d_ref), float(np.mean(d_ref)),
                float(np.std(d_ref, ddof=1)), ref_glob)
    with open(JAX_REPORT) as f:
        e = json.load(f)["E_cross_code"]
    return (e["k"], e["d_ref_mean"], e["d_ref_sd"],
            os.path.relpath(JAX_REPORT, REPO) + " E_cross_code")


def section_e(args, device, dtype: str, **over) -> dict:
    """E: the same Green-Kubo estimator on the reference's VAF pool and on
    a fold of k transport jobs of the port (seed 21; ``over``: overrides
    of :func:`transport_config`)."""
    from mdqtplasmasims_torch.analysis import green_kubo_diffusion
    from mdqtplasmasims_torch.experiments.mc_md_anisotropy import (
        run_ensemble)
    k, m_ref, s_ref, source = reference_pool(args.xval_workdir)
    cfg = transport_config(dtype, **over)
    res = run_ensemble(cfg, k, seed=21, device=device)
    w = cfg.record_steps // 2
    lags = np.arange(cfg.record_steps) * cfg.timestep
    d_fw = [green_kubo_diffusion(
        np.stack([lags[:w], np.asarray(r["vaf"], np.float64)[:w]], -1),
        plateau_frac=0.3)["d"] for r in res]
    m_fw, s_fw = float(np.mean(d_fw)), float(np.std(d_fw, ddof=1))
    z = summary_z(m_ref, s_ref, k, m_fw, s_fw, k)
    ok = abs(z) < 2.0
    print(f"[E] D_GK pooled ({k}v{k}): ref {m_ref:.4f} +- {s_ref:.4f} vs "
          f"fw {m_fw:.4f} +- {s_fw:.4f}  z = {z:+.2f}  "
          f"{'PASS' if ok else 'FAIL'} (|z| < 2; same estimator both "
          f"sides; reference pool: {source})")
    return dict(k=k, d_ref_mean=m_ref, d_ref_sd=s_ref, d_fw_mean=m_fw,
                d_fw_sd=s_fw, z=z, ok=bool(ok), ref_source=source,
                dtype=dtype)


# ---- the tool

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="shrunken smoke run (not the recorded bands)")
    ap.add_argument("--record-steps", type=int, default=8000)
    ap.add_argument("--out", default=os.path.join(
        REPO, "artifacts", "validate_analysis_torch"))
    ap.add_argument("--xval-workdir", default=os.path.join(
        tempfile.gettempdir(), "xval_transport_pooled"))
    ap.add_argument("--skip-e", action="store_true")
    ap.add_argument("--sections", default="ABCD",
                    help="which of sections A-D to run (A always runs)")
    ap.add_argument("--work-dir", default=os.path.join(
        tempfile.gettempdir(), "validate_analysis_torch"),
        help="trajectory cache and J(k) files (default: %(default)s)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (float64 twins, for tests)")
    args = ap.parse_args(argv)
    if not set(args.sections) <= set("ABCD"):
        ap.error(f"--sections takes letters of ABCD, got {args.sections}")
    return args


def run(args) -> dict:
    """The whole validation on ``args.device``: the report (every section
    asked for, the card, the dtype, the walls and the launches)."""
    device = torch.device(args.device)
    dtype = "float32" if device.type == "cuda" else "float64"
    reset, read = torch_soak._launch_counters()
    report = dict(fast=args.fast, record_steps=args.record_steps,
                  device=torch_soak.run_meta(device), dtype=dtype)
    t0 = time.perf_counter()
    reset()
    trajs, info = make_trajectories(
        args, device, getattr(torch, dtype),
        cache_dir=os.path.join(args.work_dir, "cache"))
    report["launches"] = dict(
        trajectories={k: v for k, v in read().items() if v})
    report["trajectories"] = info
    ad = analyze(trajs, args)
    walls = dict(trajectories=sum(i["wall_s"] for i in info),
                 **ad.pop("section_walls_s"))
    report.update(ad)
    ok = all(v["ok"] for v in ad.values())
    if not args.skip_e:
        _sync(device)
        t1 = time.perf_counter()
        reset()
        report["E_cross_code"] = section_e(args, device, dtype)
        _sync(device)
        walls["E"] = time.perf_counter() - t1
        report["launches"]["E"] = {k: v for k, v in read().items() if v}
        ok &= report["E_cross_code"]["ok"]
    report["section_walls_s"] = walls
    report["wall_s"] = time.perf_counter() - t0
    report["ok"] = bool(ok)
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("torch_validate_analysis: no CUDA device; the validation "
                  "runs on an NVIDIA GPU (--device cpu for the float64 "
                  "twins)", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"libraries built in {torch_soak.build_libraries():.1f} s",
              flush=True)
    report = run(args)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {path}  ({report['wall_s']:.0f}s, "
          f"{report['device']['card']}, {report['dtype']})")
    print("ANALYSIS VALIDATION", "PASS" if report["ok"] else "FAIL")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
