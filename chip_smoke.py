#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is skipped or passed over):
  1. versions and the card (``nvidia-smi`` name and power limit); no CUDA
     device -> exit 2 before printing any result;
  2. build both hand-written kernel libraries from
     mdqtplasmasims_torch/csrc, one nvcc each, in parallel;
  3. the force kernel against its plain torch twin at the flagship shape
     (3500 ions in 3584 lanes), timed with CUDA events;
  4. the fused tick kernel (explicit rolls) against its twin at the
     flagship shape (ratio 25, the sr12 scheme of CoolingConfig()), from
     the ground-state start and from an excited start where jumps fire,
     plus the expansion detuning with renormalization; timed;
  5. the in-kernel RNG form of the tick kernel against its twin (which
     draws the same Threefry stream in plain torch) at Np=3584, ratio 25,
     from the ground and the excited start and late in a flagship run's
     clock, and its per-lane forms on a 4-member fold; timed;
  6. the potential kernels against their twin: D (one member, with and
     without a mask) and G (an 8-member Poissonian fold with per-member
     masks, and a shared mask), ``best_forces_fn`` in every mode, the
     fold's sample-time potential with and without G; timed;
  7. the main path: ``laser_cooling.run`` of CoolingConfig(n0=3500,
     tmax=1.0) on CUDA (500 MD steps: 12 samples + 20 trailing steps)
     through the in-kernel RNG, with the kernels' launch counts and
     physics checks;
  8. the batched force kernel against its twin: an 8-member fold of 3584
     lanes with per-member Poissonian masks, a shared mask, and
     per-member 1/lambda; run-to-run determinism, exact-zero padded
     lanes, and an E=1 launch bitwise equal to the single-member kernel;
  9. the per-lane (sweep) variants of the tick kernel (explicit rolls)
     against their twin on a 4-member fold at the flagship shapes, each
     member with its own e0 and (om, om_dp), from the ground and the
     excited start;
 10. the ensemble path: ``run_ensemble`` of 8 Poissonian members
     (n0=3500, tmax=1.0, periodic checkpoints) with launch counts,
     per-member physics and files, then a 2-member fold run to tmax=0.5
     and resumed to 1.0, bitwise equal to an uninterrupted run;
 11. the sweep path: ``run_sweep`` over 2 detunings x 2 Rabi frequencies
     (one 4-member fold) through the per-lane RNG kernel's e0+om form,
     and short 2-point detuning-only and Rabi-only sweeps through its e0
     and om forms;
 12. explicit rolls on the card: a short flagship-width ``run`` and
     2-point detuning, Rabi and detuning+Rabi ``run_sweep``s with a
     caller's ``rolls_fn``, so every explicit form of the tick kernel
     keeps a driven path;
 13. the in-kernel stream's contract (tools/verify_seed_streams.py's for
     the JAX package): the same seed gives bitwise-equal runs, another
     seed diverges, jumps fire, folded members are independent;
 14. the interval diagnostics: a flagship-width ``run`` to tmax=1.0 with
     ``vaf_intervals`` and ``record_lccf``, checking its VAF, J(k) (against
     a float64 direct sum of the sampled R and V) and VZERO files and the
     checkpoint's vholder.

Phases 7, 10, 11 and 12 each set the launch counts to 0 just before they
drive their path and read them just after.  The line before the last is
a JSON object with one entry per kernel and form; the last line is
``{"ok": true, "device": {...}}``.  Uses no JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# tolerances (see tests/test_torch_yukawa.py and tests/test_torch_fused.py)
FORCE_TOL = 2e-5          # of the largest |F|: pair sums in another order
TICK_ATOL = {"R": 2e-5, "V": 2e-5, "tp": 2e-5, "psi_re": 5e-5,
             "psi_im": 5e-5}  # tests/test_fused.py:91-101
TICK_RTOL = 1e-4
# lanes allowed to diverge because one jump test r0 < dp0 fell within float
# rounding of dp0 and was decided differently (expected ~0 of 3500)
MAX_DIVERGED_LANES = 3
# the potential: 1e-5 of the largest per-ion sum (f32 sums of 3500
# positive terms in another order; the twin's 1/r is a division, the
# kernel's an rsqrt)
POTENTIAL_TOL = 1e-5
# |<S+P+D> - 1|, the ion average per sample.  Without renormalization
# (the reference's default) single ions' norms drift by O(h^2) per tick
# between jumps and can stray far from 1 (the JAX package's runs do too),
# so the check is on the ensemble mean; the per-ion maximum is printed
POP_TOL = 0.05
# J(k) of a sample against a float64 direct sum over the same sampled R
# and V: the .dat file's 6 significant digits bound the agreement
LCCF_TOL = 1e-4
N_TIMED = 30              # CUDA-event repetitions (median reported)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = N_TIMED) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_force_kernel(torch, L, ldeb):
    from mdqtplasmasims_torch.ops import yukawa as ty
    dev = torch.device("cuda")
    n, npad = 3500, 3584
    g = torch.Generator(device=dev).manual_seed(11)
    Rp = torch.zeros((3, npad), device=dev)
    Rp[:, :n] = torch.rand((3, n), generator=g, device=dev) * L
    mask = torch.zeros((1, npad), device=dev)
    mask[0, :n] = 1.0
    F = ty.yukawa_forces_n3l_soa(Rp, mask, L, ldeb)
    F2 = ty.yukawa_forces_n3l_soa(Rp, mask, L, ldeb)
    ref = ty.yukawa_forces_n3l_soa_reference(Rp, mask, L, ldeb)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((F - ref).abs().max())
    log(f"[force] Rp [3,{npad}], {n} real lanes, L={L:.6f}, "
        f"lambda_D={ldeb:.6f}: max|F|={scale:.6g} max abs err={err:.3g} "
        f"(rel {err / scale:.3g}, tol {FORCE_TOL:g} of max|F|)")
    if not err <= FORCE_TOL * scale:
        raise SystemExit("force kernel disagrees with its twin")
    if not torch.equal(F, F2):
        raise SystemExit("force kernel is not deterministic run to run")
    if float(F[:, n:].abs().max()) != 0.0:
        raise SystemExit("force kernel: padded lanes are not exactly zero")
    ms = cuda_ms(torch, lambda: ty.yukawa_forces_n3l_soa(Rp, mask, L, ldeb))
    plain = cuda_ms(torch, lambda: ty.yukawa_forces_n3l_soa_reference(
        Rp, mask, L, ldeb))
    log(f"[force] kernel {ms:.4f} ms, plain torch {plain:.4f} ms "
        f"(median of {N_TIMED})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain)


def compare_ticks(torch, spec, out, ref, on, allowed, what):
    """Tick kernel outputs against the twin's: a lane diverges when any
    plane leaves its bar there (a jump test within rounding of dp0,
    decided the other way); at most ``allowed`` may.  Elsewhere the worst
    error per plane; pad rows and padded lanes exactly 0.  Returns the
    worst error."""
    bad = torch.zeros(on.shape[0], dtype=torch.bool, device=on.device)
    for key, x, y in zip(TICK_ATOL, out, ref):
        bad |= ((x - y).abs() > TICK_ATOL[key] + TICK_RTOL * y.abs()).any(0)
    bad &= on
    errs = {k: float((x - y)[:, ~bad].abs().max())
            for k, x, y in zip(TICK_ATOL, out, ref)}
    pads = max(max(float(x[spec.S:].abs().max()) for x in out[3:]),
               max(float(x[:, ~on].abs().max()) for x in out[3:]))
    jumps = [int((o[2][0][on] < spec.ratio * spec.qdt).sum())
             for o in (out, ref)]
    log(f"{what}: ions that jumped {jumps[0]} (twin {jumps[1]}) of "
        f"{int(on.sum())}, diverged lanes {int(bad.sum())} (allowed "
        f"{allowed}), max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; max |pad row/lane| {pads:g}")
    if int(bad.sum()) > allowed:
        raise SystemExit(f"{what}: the tick kernel disagrees with its twin")
    if pads != 0.0:
        raise SystemExit(f"{what}: pad rows/lanes are not exactly 0")
    return max(errs.values())


def excite(torch, carry, on, g):
    """A start with the P manifold populated (jumps fire on most ticks,
    tests/test_fused.py:61-65), random velocities and clocks."""
    dev = carry.R.device
    pre = torch.zeros_like(carry.psi_re)
    pim = torch.zeros_like(carry.psi_im)
    m = on.to(pre.dtype)
    pre[2], pre[0], pim[4] = 0.7 * m, 0.51 * m, 0.5 * m
    return carry._replace(
        V=carry.V + 0.3 * torch.randn(carry.V.shape, generator=g,
                                      device=dev) * m,
        tp=torch.rand(carry.tp.shape, generator=g, device=dev) * m,
        psi_re=pre, psi_im=pim)


def check_tick_kernel(torch, cfg, L, ldeb):
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.core.scheduler import uniform_rolls
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        build_scheduler, initial_state)
    from mdqtplasmasims_torch.ops.yukawa import yukawa_forces_n3l_soa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    # a rolls_fn selects the explicit-rolls form; the rolls are drawn here
    sched = build_scheduler(cfg, dev, uniform_rolls(g))
    n, npad = cfg.n0, sched._npad(cfg.n0)
    ground = sched.soa_init(initial_state(cfg, g))
    on = torch.arange(npad, device=dev) < n
    F = yukawa_forces_n3l_soa(ground.R, on[None].float(), L, ldeb)
    excited = excite(torch, ground, on, g)
    sched_exp = build_scheduler(
        dataclasses.replace(cfg, frac_of_sig=0.5, renormalize=True), dev,
        uniform_rolls(g))
    worst = 0.0
    for name, sc, c, first, tick0 in (
            ("ground start", sched, ground, True, 0),
            ("excited start", sched, excited, False, 1000),
            ("excited, expansion + renormalize", sched_exp, excited, False,
             12000)):
        spec, tables = sc.fused_spec, sc.tables
        rolls = torch.rand((spec.ratio * 5, npad), generator=g, device=dev)
        args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im, rolls)
        out = tf.fused_md_substeps(spec, first, *args, tick0=tick0,
                                   tables=tables)
        ref = tf.fused_md_substeps_reference(spec, first, *args, tables,
                                             tick0=tick0)
        torch.cuda.synchronize()
        worst = max(worst, compare_ticks(torch, spec, out, ref, on,
                                         MAX_DIVERGED_LANES,
                                         f"[ticks] {name}"))
    spec, c = sched.fused_spec, excited
    rolls = torch.rand((spec.ratio * 5, npad), generator=g, device=dev)
    args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im, rolls)
    ms = cuda_ms(torch, lambda: tf.fused_md_substeps(
        spec, False, *args, tick0=1000, tables=sched.tables))
    plain = cuda_ms(torch, lambda: tf.fused_md_substeps_reference(
        spec, False, *args, sched.tables, tick0=1000), reps=20)
    log(f"[ticks] kernel {ms:.4f} ms, plain torch {plain:.4f} ms per "
        f"{spec.ratio}-tick MD step (median of {N_TIMED}/20)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain)


def check_rng_tick_kernels(torch, cfg, L, ldeb):
    """The in-kernel RNG form against its twin (the same Threefry stream
    in plain torch), alone at Np=3584 and in its per-lane forms on a
    4-member fold.  Agreement to the bars with the same jumps on all but
    a few lanes means the kernel drew the twin's bits."""
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    from mdqtplasmasims_torch.ops.yukawa import yukawa_forces_n3l_soa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    seed = torch.tensor([987654321], dtype=torch.int32, device=dev)
    n = cfg.n0
    out = {}
    sched = lc.build_scheduler(cfg, dev)               # the CUDA default
    if not sched.fused_spec.internal_rng:
        raise SystemExit("build_scheduler on CUDA did not pick the "
                         "in-kernel RNG")
    npad = sched._npad(n)
    on = torch.arange(npad, device=dev) < n
    ground = sched.soa_init(lc.initial_state(cfg, g))
    F = yukawa_forces_n3l_soa(ground.R, on[None].float(), L, ldeb)
    excited = excite(torch, ground, on, g)
    sched_exp = lc.build_scheduler(
        dataclasses.replace(cfg, frac_of_sig=0.5, renormalize=True), dev)
    worst = 0.0
    # the last case sits late in a flagship run (375,000 ticks)
    for name, sc, c, first, tick0 in (
            ("ground start", sched, ground, True, 0),
            ("excited start", sched, excited, False, 4321),
            ("excited, expansion + renormalize, tick 374975", sched_exp,
             excited, False, 374975)):
        spec = sc.fused_spec
        args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im)
        res = tf.fused_md_substeps(spec, first, *args, tick0=tick0,
                                   tables=sc.tables, seed=seed)
        ref = tf.fused_md_substeps_reference(spec, first, *args, None,
                                             sc.tables, tick0=tick0,
                                             seed=seed)
        torch.cuda.synchronize()
        worst = max(worst, compare_ticks(torch, spec, res, ref, on,
                                         MAX_DIVERGED_LANES,
                                         f"[ticks-rng] {name}"))
    spec, c = sched.fused_spec, excited
    args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im)
    ms = cuda_ms(torch, lambda: tf.fused_md_substeps(
        spec, False, *args, tick0=4321, tables=sched.tables, seed=seed))
    plain = cuda_ms(torch, lambda: tf.fused_md_substeps_reference(
        spec, False, *args, None, sched.tables, tick0=4321, seed=seed),
        reps=20)
    log(f"[ticks-rng] kernel {ms:.4f} ms, plain torch {plain:.4f} ms per "
        f"{spec.ratio}-tick MD step (median of {N_TIMED}/20)")
    out["fused_ticks_rng"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain)

    E = 4
    dets = [(-1.0, 1.0), (-0.5, 1.0), (-1.5, 0.6), (-0.8, 1.4)]
    oms = [(1.0, 1.0), (0.8, 1.2), (1.2, 0.7), (0.5, 1.5)]
    sweep_e0 = [lc.build_engine(dataclasses.replace(
        cfg, detuning=a, detuning_dp=b)).scheme.e0 for a, b in dets]
    for key, pe0, pom in (("fused_ticks_rng_per_lane_e0", True, False),
                          ("fused_ticks_rng_per_lane_om", False, True),
                          ("fused_ticks_rng_per_lane_e0_om", True, True)):
        sc = lc.build_scheduler(cfg, dev, per_lane_e0=pe0, per_lane_om=pom)
        spec = sc.fused_spec
        fold = sc.soa_ens_init(lc.member_states(cfg, E, 3, dev))
        onE = (torch.arange(E * npad, device=dev) % npad) < n
        FE = sc.soa_ens_forces_fn(E, n)(fold.R)
        exc = excite(torch, fold, onE, g)
        e0p, omp = fold_sweep_lanes(spec, npad, sweep_e0 if pe0 else None,
                                    oms if pom else None, dev)
        worst = 0.0
        for name, c, first, tick0 in (("ground", fold, True, 0),
                                      ("excited", exc, False, 4321)):
            args = (c.R, c.V, FE, c.tp, c.psi_re, c.psi_im)
            res = tf.fused_md_substeps(spec, first, *args, tick0=tick0,
                                       tables=sc.tables, e0_lanes=e0p,
                                       om_lanes=omp, seed=seed)
            ref = tf.fused_md_substeps_reference(
                spec, first, *args, None, sc.tables, tick0=tick0,
                e0_lanes=e0p, om_lanes=omp, seed=seed)
            torch.cuda.synchronize()
            worst = max(worst, compare_ticks(
                torch, spec, res, ref, onE, E * MAX_DIVERGED_LANES,
                f"[ticks-rng] {key[12:]}, {name} start, E={E} x {npad}"))
        args = (exc.R, exc.V, FE, exc.tp, exc.psi_re, exc.psi_im)
        ms = cuda_ms(torch, lambda: tf.fused_md_substeps(
            spec, False, *args, tick0=4321, tables=sc.tables, e0_lanes=e0p,
            om_lanes=omp, seed=seed))
        plain = cuda_ms(torch, lambda: tf.fused_md_substeps_reference(
            spec, False, *args, None, sc.tables, tick0=4321, e0_lanes=e0p,
            om_lanes=omp, seed=seed), reps=10)
        log(f"[ticks-rng] {key[12:]}: kernel {ms:.4f} ms, plain torch "
            f"{plain:.4f} ms per {spec.ratio}-tick MD step of the E={E} "
            f"fold (median of {N_TIMED}/10)")
        out[key] = dict(max_abs_err=worst, ms=ms, plain_ms=plain)
    return out


def check_potential_kernels(torch, L, ldeb):
    """Kernels D and G (forces and the per-ion potential) against their
    twin, the plain ``yukawa_forces_potential``, and the fold's
    sample-time potential per member (before G) and in one G launch."""
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    from mdqtplasmasims_torch.ops import yukawa as ty
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(41)

    def held(what, F, pot, Fr, potr, dead):
        sf, sp = float(Fr.abs().max()), float(potr.abs().max())
        ef, ep = float((F - Fr).abs().max()), float((pot - potr).abs().max())
        zero = (max(float(F[dead].abs().max()), float(pot[dead].abs().max()))
                if dead.any() else 0.0)
        log(f"[potential] {what}: max|F| {sf:.6g} err {ef:.3g} (tol "
            f"{FORCE_TOL:g} of it), max pot {sp:.6g} err {ep:.3g} (tol "
            f"{POTENTIAL_TOL:g} of it), max |masked row| {zero:g}")
        if not (ef <= FORCE_TOL * sf and ep <= POTENTIAL_TOL * sp):
            raise SystemExit(f"potential kernel disagrees ({what})")
        if zero != 0.0:
            raise SystemExit(f"potential kernel: masked rows not 0 ({what})")
        return max(ef / sf, ep / sp)

    n = 3500
    R = torch.rand((n, 3), generator=g, device=dev) * L
    mask = torch.ones(n, device=dev)
    mask[::10] = 0.0
    worst_d = 0.0
    for what, mk in (("D, no mask", None), ("D, every 10th ion masked",
                                            mask)):
        F, pot = ty.yukawa_forces_potential_pallas(R, L, ldeb, mk)
        Fr, potr = ty.yukawa_forces_potential(R, L, ldeb, mk)
        e = ty.yukawa_potential_pallas(R, L, ldeb, mk)
        torch.cuda.synchronize()
        dead = (torch.zeros(n, dtype=torch.bool, device=dev) if mk is None
                else mk == 0)
        worst_d = max(worst_d, held(what, F, pot, Fr, potr, dead))
        er = float(0.5 * potr.sum() / (n if mk is None else mk.sum()))
        if abs(float(e) - er) > POTENTIAL_TOL * abs(er):
            raise SystemExit(f"yukawa_potential_pallas {float(e)} vs twin "
                             f"{er} ({what})")
    # best_forces_fn: every mode reaches a kernel on the card (A, or D)
    Fr, potr = ty.yukawa_forces_potential(R, L, ldeb, mask)
    modes = []
    for use_pallas in (None, True, False):
        for n3l in (True, False):
            counters = (ty.yukawa_forces_n3l_soa,
                        ty.yukawa_forces_potential_pallas)
            before = [c.launches for c in counters]
            F, pot = ty.best_forces_fn(n, L, ldeb, mask=mask,
                                       use_pallas=use_pallas, n3l=n3l)(R)
            torch.cuda.synchronize()
            got = [c.launches - b for c, b in zip(counters, before)]
            want = [1, 0] if use_pallas is not False and n3l else [0, 1]
            ef = float((F - Fr).abs().max()) / float(Fr.abs().max())
            ep = (0.0 if pot is None else float((pot - potr).abs().max())
                  / float(potr.abs().max()))
            modes.append((use_pallas, n3l, got, f"{ef:.3g}", f"{ep:.3g}"))
            if (got != want or ef > FORCE_TOL or ep > POTENTIAL_TOL
                    or (pot is None) != (use_pallas is not False)):
                raise SystemExit(f"best_forces_fn(use_pallas={use_pallas}, "
                                 f"n3l={n3l}) launched [A, D] {got} (want "
                                 f"{want}), rel errs F {ef} pot {ep}")
    log(f"[potential] best_forces_fn (use_pallas, n3l, [A, D] launches, rel "
        f"err F, rel err pot): {modes}")
    ms_d = cuda_ms(torch, lambda: ty.yukawa_forces_potential_pallas(
        R, L, ldeb))
    plain_d = cuda_ms(torch, lambda: ty.yukawa_forces_potential(R, L, ldeb),
                      reps=10)
    log(f"[potential] D at N={n}: kernel {ms_d:.4f} ms, plain torch "
        f"{plain_d:.4f} ms (median of {N_TIMED}/10)")

    E = 8
    m, n_js = poisson_member_mask(3500, E, seed=7)
    masks = torch.as_tensor(m, device=dev)
    n_arr = m.shape[1]
    RE = torch.rand((E, n_arr, 3), generator=g, device=dev) * L
    RE = RE * masks[..., None]
    shared = torch.zeros(n_arr, device=dev)
    shared[:min(n_js)] = 1.0
    worst_g = 0.0
    for what, mk in (("G, per-member Poissonian masks", masks),
                     ("G, shared mask", shared)):
        F, pot = ty.yukawa_forces_potential_pallas_batched(RE, L, ldeb,
                                                           mask=mk)
        twin = [ty.yukawa_forces_potential(
            RE[j], L, ldeb, mk[j] if mk.dim() == 2 else mk)
            for j in range(E)]
        Fr = torch.stack([f for f, _ in twin])
        potr = torch.stack([u for _, u in twin])
        torch.cuda.synchronize()
        dead = mk.expand(E, n_arr) == 0
        worst_g = max(worst_g, held(f"{what}, E={E}, N={n_js}", F, pot, Fr,
                                    potr, dead))
    eb = ty.yukawa_potential_pallas_batched(RE, L, ldeb, masks)
    er = torch.stack([ty.yukawa_potential(RE[j], L, ldeb, masks[j])
                      for j in range(E)])
    torch.cuda.synchronize()
    if float(((eb - er) / er).abs().max()) > POTENTIAL_TOL:
        raise SystemExit(f"per-member potentials from G {eb.tolist()} vs twin "
                         f"{er.tolist()}")
    ms_g = cuda_ms(torch, lambda: ty.yukawa_forces_potential_pallas_batched(
        RE, L, ldeb, mask=masks))
    plain_g = cuda_ms(torch, lambda: [ty.yukawa_forces_potential(
        RE[j], L, ldeb, masks[j]) for j in range(E)], reps=10)
    log(f"[potential] G at E={E}: kernel {ms_g:.4f} ms, plain torch "
        f"{plain_g:.4f} ms (median of {N_TIMED}/10)")
    # the fold's sample-time potential: a per-member loop of the
    # plain twin against one G launch (host clock, each ends in a sync)
    walls = {}
    per_member = lambda: [ty.yukawa_potential(RE[j], L, ldeb, masks[j])
                          for j in range(E)]
    one_launch = lambda: ty.yukawa_potential_pallas_batched(RE, L, ldeb,
                                                            masks)
    for key, fn in (("per-member twin", per_member),
                    ("one G launch", one_launch)):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        walls[key] = statistics.median(times)
    log(f"[potential] the {E}-member fold's sample potential: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in walls.items())
        + " (host clock to sync, median of 10)")
    return (dict(max_abs_err=worst_d, ms=ms_d, plain_ms=plain_d),
            dict(max_abs_err=worst_g, ms=ms_g, plain_ms=plain_g))


def main_path(torch, card):
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, run)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CoolingConfig(n0=3500, tmax=1.0, save_directory=tmp)
        n_md = int(round(cfg.tmax / cfg.timestep))
        ticks = n_md * cfg.ratio
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, res = run(cfg, device="cuda")     # ends in a host fetch
        wall = time.perf_counter() - t0
        counts = read_counts()
        log(f"[main] run(CoolingConfig(n0=3500, tmax=1.0), device='cuda'): "
            f"{n_md} MD steps, {ticks} ticks in {wall:.3f} s -> "
            f"{n_md / wall:.1f} MD steps/s, "
            f"{cfg.n0 * ticks / wall:.4g} ion-QT-updates/s ({card})")
        log(f"[main] launches: {counts}")
        want = dict(yukawa_forces=500, fused_ticks_rng=512,
                    yukawa_forces_potential=13, fused_ticks=0)
        if any(counts[k] != v for k, v in want.items()):
            raise SystemExit(f"main path launched {counts}, want {want}")
        outs = res["outs"]
        arrays = [final.R, final.V, final.F, final.psi, final.t_part,
                  *outs.values()]
        if not all(np_isfinite(a) for a in arrays):
            raise SystemExit("non-finite outputs")
        ek = outs["ekin"].sum(-1)
        norms = outs["pops"].sum(-1)                  # [samples, ions]
        pop_err = float(abs(norms.mean(-1) - 1.0).max())
        log(f"[main] Ekin per sample: {ek[0]:.4g} .. {ek[-1]:.4g}; "
            f"max |<S+P+D>-1| = {pop_err:.3g} (tol {POP_TOL:g}), per-ion "
            f"max |S+P+D-1| = {float(abs(norms - 1.0).max()):.3g}; "
            f"samples {outs['t'].shape[0]}, t = {outs['t'][0]:.5g} .. "
            f"{outs['t'][-1]:.5g}")
        if not (ek[0] > 0.0 and ek[-1] > ek[0]):
            raise SystemExit("kinetic energy did not rise from the frozen "
                             "start")
        if pop_err > POP_TOL:
            raise SystemExit("S/P/D populations do not sum to 1")
        job = next(d for d, _, fs in os.walk(tmp) if "energies.dat" in fs)
        with open(os.path.join(job, "energies.dat")) as f:
            rows = [r for r in f.read().splitlines() if r.strip()]
        want = [f"{p}_timestep{n_md - 1:06d}.dat"
                for p in ("ions", "conditions", "wvFns")]
        want.append(f"checkpoint_{n_md - 1:06d}.npz")
        missing = [w for w in want if not os.path.exists(os.path.join(job, w))]
        if len(rows) != 12 or missing:
            raise SystemExit(f"energies.dat rows {len(rows)} (want 12), "
                             f"missing checkpoint files {missing}")
        import numpy as np
        with np.load(os.path.join(job, f"checkpoint_{n_md - 1:06d}.npz")) as z:
            if "torch_rng_seed" not in z.files:
                raise SystemExit("the checkpoint lacks the seed word")
        log(f"[main] energies.dat: {len(rows)} rows; terminal checkpoint "
            f"files present, with the seed word")
    return counts


def check_batched_force_kernel(torch, L, ldeb):
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    from mdqtplasmasims_torch.ops import yukawa as ty
    dev = torch.device("cuda")
    E = 8
    m, n_js = poisson_member_mask(3500, E, seed=7)
    npad = -(-max(3584, m.shape[1]) // 128) * 128
    g = torch.Generator(device=dev).manual_seed(13)
    masks = torch.zeros((E, npad), device=dev)
    masks[:, :m.shape[1]] = torch.as_tensor(m, device=dev)
    Rp = torch.rand((3, E, npad), generator=g, device=dev) * L
    Rp = (Rp * masks).reshape(3, E * npad)
    shared = torch.zeros((1, npad), device=dev)
    shared[0, :min(n_js)] = 1.0
    inv_ldeb = (1.0 / ldeb) * (1.0 + 0.05 * torch.arange(E, device=dev))
    worst = 0.0
    for name, mk, il in (("per-member masks", masks, None),
                         ("shared mask", shared, None),
                         ("per-member masks + 1/lambda", masks, inv_ldeb)):
        F = ty.yukawa_forces_n3l_soa_batched(Rp, mk, E, L, ldeb, il)
        F2 = ty.yukawa_forces_n3l_soa_batched(Rp, mk, E, L, ldeb, il)
        ref = ty.yukawa_forces_n3l_soa_batched_reference(Rp, mk, E, L, ldeb,
                                                         il)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((F - ref).abs().max())
        dead = (mk.expand(E, npad) == 0).reshape(E * npad)
        pads = float(F[:, dead].abs().max())
        log(f"[forces-E] {name}: E={E} x {npad} lanes, counts {n_js}: "
            f"max|F|={scale:.6g} max abs err={err:.3g} (rel "
            f"{err / scale:.3g}, tol {FORCE_TOL:g}); max |F| on masked lanes "
            f"{pads:g}")
        if not err <= FORCE_TOL * scale:
            raise SystemExit(f"batched force kernel disagrees ({name})")
        if not torch.equal(F, F2):
            raise SystemExit("batched force kernel is not deterministic")
        if pads != 0.0:
            raise SystemExit("batched force kernel: masked lanes not 0")
        worst = max(worst, err)
    one = Rp.reshape(3, E, npad)[:, 0].contiguous()
    fa = ty.yukawa_forces_n3l_soa(one, shared, L, ldeb)
    fc = ty.yukawa_forces_n3l_soa_batched(one, shared, 1, L, ldeb)
    torch.cuda.synchronize()
    if not torch.equal(fa, fc):
        raise SystemExit("E=1 batched launch differs from the single-member "
                         "kernel")
    log("[forces-E] E=1 batched launch bitwise equal to the single-member "
        "kernel")
    ms = cuda_ms(torch, lambda: ty.yukawa_forces_n3l_soa_batched(
        Rp, masks, E, L, ldeb))
    plain = cuda_ms(torch, lambda: ty.yukawa_forces_n3l_soa_batched_reference(
        Rp, masks, E, L, ldeb), reps=10)
    log(f"[forces-E] kernel {ms:.4f} ms, plain torch {plain:.4f} ms for "
        f"E={E} (median of {N_TIMED}/10)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain)


def check_lane_kernels(torch, cfg):
    """The per-lane tick variants (explicit rolls) against the twin on a
    4-member fold."""
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.core.scheduler import (fold_sweep_lanes,
                                                     uniform_rolls)
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    dev = torch.device("cuda")
    E = 4
    dets = [(-1.0, 1.0), (-0.5, 1.0), (-1.5, 0.6), (-0.8, 1.4)]
    oms = [(1.0, 1.0), (0.8, 1.2), (1.2, 0.7), (0.5, 1.5)]
    sweep_e0 = [lc.build_engine(dataclasses.replace(
        cfg, detuning=a, detuning_dp=b)).scheme.e0 for a, b in dets]
    g = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for key, pe0, pom in (("per_lane_e0", True, False),
                          ("per_lane_om", False, True),
                          ("per_lane_e0_om", True, True)):
        sched = lc.build_scheduler(cfg, dev, uniform_rolls(g),
                                   per_lane_e0=pe0, per_lane_om=pom)
        spec, n = sched.fused_spec, cfg.n0
        npad = sched._npad(n)
        ground = sched.soa_ens_init(lc.member_states(cfg, E, 3, dev))
        F = sched.soa_ens_forces_fn(E, n)(ground.R)
        on = (torch.arange(E * npad, device=dev) % npad) < n
        excited = excite(torch, ground._replace(V=torch.zeros_like(
            ground.V)), on, g)
        e0p, omp = fold_sweep_lanes(spec, npad, sweep_e0 if pe0 else None,
                                    oms if pom else None, dev)
        worst = 0.0
        for name, c, first, tick0 in (("ground", ground, True, 0),
                                      ("excited", excited, False, 1000)):
            rolls = torch.rand((spec.ratio * 5, E * npad), generator=g,
                               device=dev)
            args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im, rolls)
            res = tf.fused_md_substeps(spec, first, *args, tick0=tick0,
                                       tables=sched.tables, e0_lanes=e0p,
                                       om_lanes=omp)
            ref = tf.fused_md_substeps_reference(
                spec, first, *args, sched.tables, tick0=tick0, e0_lanes=e0p,
                om_lanes=omp)
            torch.cuda.synchronize()
            worst = max(worst, compare_ticks(
                torch, spec, res, ref, on, E * MAX_DIVERGED_LANES,
                f"[ticks-lane] {key}, {name} start, E={E} x {npad}"))
        c = excited
        rolls = torch.rand((spec.ratio * 5, E * npad), generator=g, device=dev)
        args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im, rolls)
        ms = cuda_ms(torch, lambda: tf.fused_md_substeps(
            spec, False, *args, tick0=1000, tables=sched.tables, e0_lanes=e0p,
            om_lanes=omp))
        plain = cuda_ms(torch, lambda: tf.fused_md_substeps_reference(
            spec, False, *args, sched.tables, tick0=1000, e0_lanes=e0p,
            om_lanes=omp), reps=10)
        log(f"[ticks-lane] {key}: kernel {ms:.4f} ms, plain torch "
            f"{plain:.4f} ms per {spec.ratio}-tick MD step of the E={E} fold "
            f"(median of {N_TIMED}/10)")
        out[key] = dict(max_abs_err=worst, ms=ms, plain_ms=plain)
    return out


def counters() -> dict:
    """Every kernel form's launch counter: name -> (object, attribute)."""
    from mdqtplasmasims_torch.core.qt_fused import (LAUNCH_COUNTERS,
                                                    fused_md_substeps)
    from mdqtplasmasims_torch.ops import yukawa as ty
    out = dict(
        yukawa_forces=(ty.yukawa_forces_n3l_soa, "launches"),
        yukawa_forces_batched=(ty.yukawa_forces_n3l_soa_batched, "launches"),
        yukawa_forces_potential=(ty.yukawa_forces_potential_pallas,
                                 "launches"),
        yukawa_forces_potential_batched=(
            ty.yukawa_forces_potential_pallas_batched, "launches"))
    for attr in LAUNCH_COUNTERS:           # launches[_rng][_per_lane_..]
        out["fused_ticks" + attr[len("launches"):]] = (fused_md_substeps,
                                                        attr)
    return out


def reset_counts():
    for obj, attr in counters().values():
        setattr(obj, attr, 0)


def read_counts() -> dict:
    return {k: getattr(obj, attr) for k, (obj, attr) in counters().items()}


def check_members(name, final, outs, n_js, dirs, n_md, rows_want=12):
    """Per member: finite values, Ekin rising from the frozen start, the
    ion-mean S+P+D norm, the energies.dat rows and an ions_ file of the
    member's N."""
    from mdqtplasmasims_tpu.io import checkpoint as ckpt
    for j, (nj, d) in enumerate(zip(n_js, dirs)):
        arrays = [final.R[j][:nj], final.V[j][:nj], final.psi[j][:nj],
                  *(v[j] for v in outs.values())]
        if not all(np_isfinite(a) for a in arrays):
            raise SystemExit(f"{name}: member {j} has non-finite outputs")
        ek = outs["ekin"][j].sum(-1)
        norms = outs["pops"][j][:, :nj].sum(-1)
        pop_err = float(abs(norms.mean(-1) - 1.0).max())
        with open(os.path.join(d, "energies.dat")) as f:
            rows = [r for r in f.read().splitlines() if r.strip()]
        n_file, _ = ckpt.read_ions(d, n_md - 1)
        log(f"[{name}] member {j}: N={nj}, Ekin {ek[0]:.4g} .. {ek[-1]:.4g}, "
            f"max |<S+P+D>-1| {pop_err:.3g}, energies.dat {len(rows)} rows, "
            f"ions_ N {n_file}")
        if not (ek[0] > 0.0 and ek[-1] > ek[0]):
            raise SystemExit(f"{name}: member {j} Ekin did not rise")
        if pop_err > POP_TOL:
            raise SystemExit(f"{name}: member {j} S/P/D do not sum to 1")
        if len(rows) != rows_want or n_file != nj:
            raise SystemExit(f"{name}: member {j} wrote {len(rows)} rows and "
                             f"N={n_file} (want {rows_want} and {nj})")


def ensemble_path(torch, card):
    import numpy as np
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, run_ensemble)
    E = 8
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CoolingConfig(n0=3500, tmax=1.0, exact_n=False,
                            checkpoint_every_segments=6, save_directory=tmp)
        n_md = int(round(cfg.tmax / cfg.timestep))
        _, n_js = poisson_member_mask(cfg.n0, E, 0)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, outs = run_ensemble(cfg, E, device="cuda")
        wall = time.perf_counter() - t0
        counts = read_counts()
        ticks = n_md * cfg.ratio
        log(f"[ensemble] run_ensemble(n0=3500, tmax=1.0, exact_n=False, "
            f"checkpoint_every_segments=6), {E} members, N={n_js}: {n_md} MD "
            f"steps in {wall:.3f} s -> {sum(n_js) * ticks / wall:.4g} "
            f"aggregate ion-QT-updates/s ({card})")
        log(f"[ensemble] launches: {counts}")
        want = dict(yukawa_forces_batched=500, fused_ticks_rng=512,
                    yukawa_forces_potential_batched=13, fused_ticks=0,
                    yukawa_forces_potential=0)
        if any(counts[k] != v for k, v in want.items()):
            raise SystemExit(f"ensemble path launched {counts}, want {want}")
        dirs = sorted(os.path.dirname(p) for p in glob_all(tmp,
                                                           "energies.dat"))
        if len(dirs) != E:
            raise SystemExit(f"ensemble wrote {len(dirs)} job trees")
        check_members("ensemble", final, outs, n_js, dirs, n_md)
    # resume: tmax=0.5 then resume to 1.0 == uninterrupted 1.0, bitwise,
    # on the in-kernel RNG (the seed word rides the checkpoints)
    finals = []
    with tempfile.TemporaryDirectory() as tmp:
        for tmax, resume, sub in ((0.5, False, "a"), (1.0, True, "a"),
                                  (1.0, False, "b")):
            c = CoolingConfig(n0=3500, tmax=tmax, exact_n=False,
                              checkpoint_every_segments=6,
                              save_directory=os.path.join(tmp, sub))
            fin, _ = run_ensemble(c, 2, seed=4, resume=resume, device="cuda")
            finals.append(fin)
    # real lanes: a padded lane's clock ticks on and is not checkpointed
    _, n2 = poisson_member_mask(3500, 2, 4)
    same = np.array_equal(finals[1].tick, finals[2].tick) and all(
        np.array_equal(getattr(finals[1], k)[j][:nj],
                       getattr(finals[2], k)[j][:nj])
        for k in ("R", "V", "psi", "t_part") for j, nj in enumerate(n2))
    log(f"[ensemble] E=2 fold (N={n2}), in-kernel RNG, tmax 0.5 then resume "
        f"to 1.0 vs one run to 1.0: final R/V/psi/t_part bitwise equal: "
        f"{same}")
    if not same:
        raise SystemExit("resumed ensemble differs from the uninterrupted "
                         "run")
    return counts


def sweep_path(torch, card):
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, _save_dir, run_sweep)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CoolingConfig(n0=3500, tmax=1.0, save_directory=tmp)
        n_md = int(round(cfg.tmax / cfg.timestep))
        points = [{"detuning": d, "om": o} for d in (-1.0, -0.5)
                  for o in (0.8, 1.2)]
        # the e0-only and om-only forms: 2-point sweeps to tmax=0.2
        short = dataclasses.replace(cfg, tmax=0.2)
        n_short = int(round(short.tmax / short.timestep))
        singles = ([{"detuning": -1.0}, {"detuning": -0.5}],
                   [{"om": 0.8}, {"om": 1.2}])
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, outs, mcfgs = run_sweep(cfg, points, device="cuda")
        wall = time.perf_counter() - t0
        for k, pts in enumerate(singles):
            sub_cfg = dataclasses.replace(
                short, save_directory=os.path.join(tmp, f"single{k}"))
            fs, os_, mc = run_sweep(sub_cfg, pts, device="cuda")
            check_members(f"sweep-{'e0' if k == 0 else 'om'}", fs, os_,
                          [cfg.n0] * 2, [_save_dir(c) for c in mc], n_short,
                          rows_want=2)
        counts = read_counts()
        E = len(points)
        log(f"[sweep] run_sweep(n0=3500, tmax=1.0) over {points}: {E} "
            f"members in one fold, {n_md} MD steps in {wall:.3f} s -> "
            f"{E * cfg.n0 * n_md * cfg.ratio / wall:.4g} aggregate "
            f"ion-QT-updates/s ({card}); then tmax=0.2 sweeps over "
            f"{list(singles)}")
        log(f"[sweep] launches: {counts}")
        want = dict(yukawa_forces_batched=700,
                    fused_ticks_rng_per_lane_e0_om=512,
                    fused_ticks_rng_per_lane_e0=102,
                    fused_ticks_rng_per_lane_om=102,
                    yukawa_forces_potential_batched=19, fused_ticks_rng=0,
                    fused_ticks_per_lane_e0_om=0)
        if any(counts[k] != v for k, v in want.items()):
            raise SystemExit(f"sweep path launched {counts}, want {want}")
        dirs = [_save_dir(c) for c in mcfgs]
        if len(set(dirs)) != E:
            raise SystemExit("sweep points share a directory")
        check_members("sweep", final, outs, [cfg.n0] * E, dirs, n_md)
    return counts


def explicit_rolls_path(torch, card):
    """A short flagship-width run and 2-point detuning, Rabi and
    detuning+Rabi sweeps with a caller's ``rolls_fn``: every explicit-rolls
    form of the tick kernel."""
    from mdqtplasmasims_torch.core.scheduler import uniform_rolls
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, run, run_sweep)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CoolingConfig(n0=3500, tmax=0.2, save_directory=tmp)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, res = run(cfg, device="cuda", rolls_fn=uniform_rolls(
            torch.Generator(device=dev).manual_seed(1)))
        sweeps = []
        for k, points in enumerate((
                [{"detuning": -1.0}, {"detuning": -0.5}],
                [{"om": 0.8}, {"om": 1.2}],
                [{"detuning": -1.0, "om": 0.8},
                 {"detuning": -0.5, "om": 1.2}])):
            fs, outs, _ = run_sweep(
                dataclasses.replace(cfg, save_directory=os.path.join(
                    tmp, f"sweep{k}")), points, device="cuda",
                rolls_fn=uniform_rolls(torch.Generator(
                    device=dev).manual_seed(2 + k)))
            sweeps.append((f"sweep {points}", outs, fs.psi))
        wall = time.perf_counter() - t0
        counts = read_counts()
    log(f"[explicit] run + three 2-point run_sweeps (n0=3500, tmax=0.2) "
        f"with a rolls_fn in {wall:.3f} s; launches: {counts}")
    want = dict(yukawa_forces=100, fused_ticks=102, yukawa_forces_batched=300,
                fused_ticks_per_lane_e0=102, fused_ticks_per_lane_om=102,
                fused_ticks_per_lane_e0_om=102, fused_ticks_rng=0,
                fused_ticks_rng_per_lane_e0=0, fused_ticks_rng_per_lane_om=0,
                fused_ticks_rng_per_lane_e0_om=0)
    if any(counts[k] != v for k, v in want.items()):
        raise SystemExit(f"explicit-rolls paths launched {counts}, want "
                         f"{want}")
    for what, o, psi in [("run", res["outs"], final.psi), *sweeps]:
        norm = float(abs(o["pops"].sum(-1).mean() - 1.0))
        if not (np_isfinite(psi) and norm < POP_TOL):
            raise SystemExit(f"explicit-rolls {what}: non-finite or S+P+D "
                             f"off by {norm}")
    return counts


def stream_contract(torch):
    """tools/verify_seed_streams.py's checks, on the port's stream."""
    import numpy as np
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, build_scheduler, run, run_ensemble)
    cfg = CoolingConfig(n0=256, tmax=2.0)
    if not build_scheduler(cfg, "cuda").fused_spec.internal_rng:
        raise SystemExit("the stream contract must run the in-kernel RNG")
    f1, _ = run(cfg, seed=3, device="cuda")
    f2, _ = run(cfg, seed=3, device="cuda")
    f3, _ = run(cfg, seed=4, device="cuda")
    same = all(np.array_equal(getattr(f1, k), getattr(f2, k))
               for k in ("R", "V", "psi", "t_part"))
    diverged = not np.allclose(f1.R, f3.R)
    # an ion whose clock is below 90 % of the run time jumped after t/10
    frac = float((f1.t_part < 0.9 * f1.t).mean())
    fe, oe = run_ensemble(CoolingConfig(n0=256, tmax=1.0), 4, seed=5,
                          device="cuda")
    distinct = all(not np.allclose(fe.R[0], fe.R[i]) for i in range(1, 4))
    last = np.asarray(oe["ekin"], np.float64)[:, -1, 0]
    spread = float(last.std() / last.mean())
    log(f"[streams] n0=256 tmax=2.0: seed 3 twice bitwise equal {same}; "
        f"seed 4 diverges {diverged}; ions that jumped after t/10 "
        f"{frac:.3f}; 4-member fold distinct {distinct}, EkinX at t=1 "
        f"{last.round(6).tolist()} (rel spread {spread:.4f})")
    if not (same and diverged and frac > 0.5 and distinct
            and spread > 1e-3):
        raise SystemExit("the in-kernel stream breaks its contract")


def interval_path(torch, card, L):
    """A flagship-width run with the interval diagnostics (``L`` is the
    box length of its 3500 ions)."""
    import numpy as np
    from mdqtplasmasims_tpu.io.datfiles import read_rows
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, run)
    iv = (0.2, 0.5)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CoolingConfig(n0=3500, tmax=1.0, vaf_intervals=iv,
                            record_lccf=True, save_directory=tmp)
        n_md = int(round(cfg.tmax / cfg.timestep))
        t0 = time.perf_counter()
        final, res = run(cfg, device="cuda")
        wall = time.perf_counter() - t0
        outs = res["outs"]
        t = np.asarray(outs["t"], np.float64)
        job = next(d for d, _, fs in os.walk(tmp) if "energies.dat" in fs)
        got = []
        for k, ts in enumerate(iv):
            vaf = read_rows(os.path.join(job, f"VAF_interval{k}.dat"), 2)
            start = int(np.argmin(np.abs(t - ts)))
            v0 = np.asarray(outs["V"][start], np.float64)
            ok = (vaf.shape[0] == len(t) - start
                  and np.allclose(vaf[:, 0], t[start:], rtol=1e-5)
                  and abs(vaf[0, 1] - np.mean(np.sum(v0 * v0, -1)))
                  <= 1e-5 * vaf[0, 1] and np.isfinite(vaf).all())
            vz = read_rows(os.path.join(
                job, f"VZERO_timestep{n_md - 1:06d}_interval{k}.dat"), 3)
            ok = ok and np.allclose(vz, v0, rtol=1e-5, atol=1e-7)
            got.append((vaf.shape[0], ok))
        J = read_rows(os.path.join(job, "J_interval0.dat"), 10)
        j_ok = (J.shape[0] == len(t) * 12 ** 3 and np.isfinite(J).all()
                and np.array_equal(np.unique(J[:, 0]),
                                   np.arange(len(t)) * cfg.sample_freq))
        # the first and last samples' J(k), taken on the card, against a
        # float64 direct sum over the sampled R and V on the host
        K = 12 ** 3
        kv = (2.0 * np.pi / L) * J[:K, 1:4]
        j_err = 0.0
        for s in (0, len(t) - 1):
            R = np.asarray(outs["R"][s], np.float64)
            V = np.asarray(outs["V"][s], np.float64)
            ref = V.T @ np.exp(1j * (R @ kv.T))                 # [3, K]
            cols = J[s * K:(s + 1) * K, 4:].T                   # [6, K]
            jk = cols[0::2] + 1j * cols[1::2]
            j_err = max(j_err, float(np.abs(jk - ref).max()
                                     / np.abs(ref).max()))
        j_ok = j_ok and j_err <= LCCF_TOL
        with np.load(os.path.join(job, f"checkpoint_{n_md - 1:06d}.npz")) as z:
            vh = z["vholder"]
        vh_ok = vh.shape == (13, cfg.n0, 3) and not vh[2:].any()
    log(f"[intervals] run(n0=3500, tmax=1.0, vaf_intervals={iv}, "
        f"record_lccf=True) in {wall:.3f} s ({card}): VAF rows and checks "
        f"{got}; J_interval0.dat {J.shape}, max err vs float64 direct sum "
        f"{j_err:.3g} of max|J| (tol {LCCF_TOL:g}), ok {j_ok}; checkpoint "
        f"vholder "
        f"{vh.shape} ok {vh_ok}")
    if not (all(ok for _, ok in got) and j_ok and vh_ok):
        raise SystemExit("the interval diagnostics' files are wrong")


def glob_all(root, name):
    return [os.path.join(d, name) for d, _, fs in os.walk(root) if name in fs]


def np_isfinite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(np.asarray(a)).all())


def build_kernels(torch):
    """Both kernel libraries, one nvcc each, started together."""
    from mdqtplasmasims_torch import _build
    from mdqtplasmasims_torch.core import qt_fused
    from mdqtplasmasims_torch.ops import yukawa
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(yukawa._lib), pool.submit(qt_fused._lib)]:
            fut.result()
    log(f"[build] both kernel libraries loaded in "
        f"{time.perf_counter() - t0:.1f} s (nvcc: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in _build.build_seconds.items())
        + ")")
    for name in ("yukawa_forces", "fused_ticks"):
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"[build] {name}: {line.strip()}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    from mdqtplasmasims_tpu.units import PlasmaUnits

    # IEEE float32 for the plain versions too (the kernels use no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"[env] card: {smi}")
    build_kernels(torch)

    cfg = lc.CoolingConfig()
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    log(f"[config] N0={cfg.n0} L={L:.6f} lambda_D={pu.debye_length:.6f} "
        f"ratio={cfg.ratio} qdt={cfg.qdt:g}")
    force = check_force_kernel(torch, L, pu.debye_length)
    ticks = check_tick_kernel(torch, cfg, L, pu.debye_length)
    rng = check_rng_tick_kernels(torch, cfg, L, pu.debye_length)
    pot_d, pot_g = check_potential_kernels(torch, L, pu.debye_length)
    counts = main_path(torch, smi)
    force_e = check_batched_force_kernel(torch, L, pu.debye_length)
    lanes = check_lane_kernels(torch, cfg)
    ens_counts = ensemble_path(torch, smi)
    sweep_counts = sweep_path(torch, smi)
    expl_counts = explicit_rolls_path(torch, smi)
    stream_contract(torch)
    interval_path(torch, smi, L)

    log(f"[env] card: {smi}")
    src_f = "mdqtplasmasims_torch/csrc/yukawa_forces.cu"
    src_t = "mdqtplasmasims_torch/csrc/fused_ticks.cu"
    tpu_t = "mdqtplasmasims_tpu/core/qt_fused.py:93"
    tpu_rng = "mdqtplasmasims_tpu/core/qt_fused.py:111"
    kernels = [
        dict(name="yukawa_forces", route="cuda", source=src_f,
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:302",
             launches=counts["yukawa_forces"], **force),
        dict(name="yukawa_forces_batched", route="cuda", source=src_f,
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:411",
             launches=ens_counts["yukawa_forces_batched"], **force_e),
        dict(name="yukawa_forces_potential", route="cuda", source=src_f,
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:147",
             launches=counts["yukawa_forces_potential"], **pot_d),
        dict(name="yukawa_forces_potential_batched", route="cuda",
             source=src_f, replaces="mdqtplasmasims_tpu/ops/yukawa.py:166",
             launches=ens_counts["yukawa_forces_potential_batched"],
             **pot_g),
        dict(name="fused_ticks_rng", route="cuda", source=src_t,
             replaces=tpu_rng, launches=counts["fused_ticks_rng"],
             **rng["fused_ticks_rng"]),
        dict(name="fused_ticks_rng_per_lane_e0", route="cuda", source=src_t,
             replaces=tpu_rng,
             launches=sweep_counts["fused_ticks_rng_per_lane_e0"],
             **rng["fused_ticks_rng_per_lane_e0"]),
        dict(name="fused_ticks_rng_per_lane_om", route="cuda", source=src_t,
             replaces=tpu_rng,
             launches=sweep_counts["fused_ticks_rng_per_lane_om"],
             **rng["fused_ticks_rng_per_lane_om"]),
        dict(name="fused_ticks_rng_per_lane_e0_om", route="cuda",
             source=src_t, replaces=tpu_rng,
             launches=sweep_counts["fused_ticks_rng_per_lane_e0_om"],
             **rng["fused_ticks_rng_per_lane_e0_om"]),
        dict(name="fused_ticks", route="cuda", source=src_t, replaces=tpu_t,
             launches=expl_counts["fused_ticks"], **ticks),
        dict(name="fused_ticks_per_lane_e0", route="cuda", source=src_t,
             replaces=tpu_t,
             launches=expl_counts["fused_ticks_per_lane_e0"],
             **lanes["per_lane_e0"]),
        dict(name="fused_ticks_per_lane_om", route="cuda", source=src_t,
             replaces=tpu_t,
             launches=expl_counts["fused_ticks_per_lane_om"],
             **lanes["per_lane_om"]),
        dict(name="fused_ticks_per_lane_e0_om", route="cuda", source=src_t,
             replaces=tpu_t,
             launches=expl_counts["fused_ticks_per_lane_e0_om"],
             **lanes["per_lane_e0_om"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
