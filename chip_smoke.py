#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is skipped or passed over):
  1. versions and the card (``nvidia-smi`` name and power limit); no CUDA
     device -> exit 2 before printing any result;
  2. build both hand-written kernels from mdqtplasmasims_torch/csrc;
  3. the force kernel against its plain torch twin at the flagship shape
     (3500 ions in 3584 lanes), timed with CUDA events;
  4. the fused tick kernel against its twin at the flagship shape (ratio
     25, the sr12 scheme of CoolingConfig()), from the ground-state start
     and from an excited start where jumps fire, plus the expansion
     detuning with renormalization; timed with CUDA events;
  5. the main path: ``laser_cooling.run`` of CoolingConfig(n0=3500,
     tmax=1.0) on CUDA (500 MD steps: 12 samples + 20 trailing steps),
     with the kernels' launch counts and physics checks;
  6. the batched force kernel against its twin: an 8-member fold of 3584
     lanes with per-member Poissonian masks, a shared mask, and
     per-member 1/lambda; run-to-run determinism, exact-zero padded
     lanes, and an E=1 launch bitwise equal to the single-member kernel;
  7. the per-lane (sweep) variants of the tick kernel against their twin
     on a 4-member fold at the flagship shapes, each member with its own
     e0 and (om, om_dp), from the ground and the excited start;
  8. the ensemble path: ``run_ensemble`` of 8 Poissonian members
     (n0=3500, tmax=1.0, periodic checkpoints) with launch counts,
     per-member physics and files, then a 2-member fold run to tmax=0.5
     and resumed to 1.0, bitwise equal to an uninterrupted run;
  9. the sweep path: ``run_sweep`` over 2 detunings x 2 Rabi frequencies
     (one 4-member fold) through the per-lane kernel.

Phases 5, 8 and 9 each set the launch counts to 0 just before they drive
their path and read them just after.  The line before the last is a JSON
object with one entry per kernel; the last line is ``{"ok": true,
"device": {...}}``.  Uses no JAX.
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
# |<S+P+D> - 1|, the ion average per sample.  Without renormalization
# (the reference's default) single ions' norms drift by O(h^2) per tick
# between jumps and can stray far from 1 (the JAX package's runs do too),
# so the check is on the ensemble mean; the per-ion maximum is printed
POP_TOL = 0.05
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


def check_tick_kernel(torch, cfg, L, ldeb):
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        build_scheduler, initial_state)
    from mdqtplasmasims_torch.ops.yukawa import yukawa_forces_n3l_soa
    dev = torch.device("cuda")
    # the uniforms are drawn here, so the schedulers need no rolls_fn
    sched = build_scheduler(cfg, dev, rolls_fn=None)
    n, npad, SP = cfg.n0, sched._npad(cfg.n0), sched.fused_spec.SP
    g = torch.Generator(device=dev).manual_seed(12)
    ground = sched.soa_init(initial_state(cfg, g))
    mask = torch.zeros((1, npad), device=dev)
    mask[0, :n] = 1.0
    F = yukawa_forces_n3l_soa(ground.R, mask, L, ldeb)
    excited = ground._replace(
        V=ground.V + 0.3 * torch.randn((3, npad), generator=g, device=dev)
        * mask,
        tp=torch.rand((1, npad), generator=g, device=dev) * mask,
        psi_re=torch.zeros((SP, npad), device=dev),
        psi_im=torch.zeros((SP, npad), device=dev))
    # populated P manifold: jumps fire (tests/test_fused.py:61-65)
    excited.psi_re[2, :n] = 0.7
    excited.psi_re[0, :n] = 0.51
    excited.psi_im[4, :n] = 0.5
    sched_exp = build_scheduler(
        dataclasses.replace(cfg, frac_of_sig=0.5, renormalize=True), dev,
        rolls_fn=None)
    cases = [("ground start", sched, ground, True, 0),
             ("excited start", sched, excited, False, 1000),
             ("excited, expansion + renormalize", sched_exp, excited, False,
              12000)]
    worst = 0.0
    for name, sc, c, first, tick0 in cases:
        spec, tables = sc.fused_spec, sc.tables
        rolls = torch.rand((spec.ratio * 5, npad), generator=g, device=dev)
        args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im, rolls)
        out = tf.fused_md_substeps(spec, first, *args, tick0=tick0,
                                   tables=tables)
        ref = tf.fused_md_substeps_reference(spec, first, *args, tables,
                                             tick0=tick0)
        torch.cuda.synchronize()
        bad = torch.zeros(npad, dtype=torch.bool, device=dev)
        errs = {}
        for key, x, y in zip(TICK_ATOL, out, ref):
            bad |= ((x - y).abs() > TICK_ATOL[key]
                    + TICK_RTOL * y.abs()).any(0)
        bad[n:] = False
        for key, x, y in zip(TICK_ATOL, out, ref):
            errs[key] = float((x - y)[:, ~bad].abs().max())
        diverged = int(bad.sum())
        jumps = int((out[2][0, :n] < spec.ratio * spec.qdt).sum())
        pads = max(float(x[spec.S:].abs().max()) for x in out[3:])
        pads = max(pads, max(float(x[:, n:].abs().max()) for x in out[3:]))
        log(f"[ticks] {name}: ions that jumped {jumps}/{n}, diverged lanes "
            f"{diverged} (allowed {MAX_DIVERGED_LANES}), max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; max |pad row/lane| {pads:g}")
        if diverged > MAX_DIVERGED_LANES:
            raise SystemExit(f"tick kernel disagrees with its twin ({name})")
        if pads != 0.0:
            raise SystemExit("tick kernel: pad rows/lanes are not exactly 0")
        worst = max(worst, *errs.values())
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


def main_path(torch, card):
    from mdqtplasmasims_torch.core.qt_fused import fused_md_substeps
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, run)
    from mdqtplasmasims_torch.ops.yukawa import yukawa_forces_n3l_soa
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CoolingConfig(n0=3500, tmax=1.0, save_directory=tmp)
        n_md = int(round(cfg.tmax / cfg.timestep))
        ticks = n_md * cfg.ratio
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, res = run(cfg, device="cuda")     # ends in a host fetch
        wall = time.perf_counter() - t0
        counts = (yukawa_forces_n3l_soa.launches, fused_md_substeps.launches)
        log(f"[main] run(CoolingConfig(n0=3500, tmax=1.0), device='cuda'): "
            f"{n_md} MD steps, {ticks} ticks in {wall:.3f} s -> "
            f"{n_md / wall:.1f} MD steps/s, "
            f"{cfg.n0 * ticks / wall:.4g} ion-QT-updates/s ({card})")
        log(f"[main] launches: force {counts[0]}, ticks {counts[1]}")
        if counts != (500, 512):
            raise SystemExit(f"main path launched {counts}, want (500, 512)")
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
        log(f"[main] energies.dat: {len(rows)} rows; terminal checkpoint "
            f"files present")
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
    """The per-lane tick variants against the twin on a 4-member fold."""
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
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
                          ("per_lane_e0+om", True, True)):
        sched = lc.build_scheduler(cfg, dev, None, per_lane_e0=pe0,
                                   per_lane_om=pom)
        spec, n = sched.fused_spec, cfg.n0
        npad, SP = sched._npad(n), spec.SP
        ground = sched.soa_ens_init(lc.member_states(cfg, E, 3, dev))
        F = sched.soa_ens_forces_fn(E, n)(ground.R)
        on = torch.zeros((1, E, npad), device=dev)
        on[:, :, :n] = 1.0
        on = on.reshape(1, E * npad)
        pre = torch.zeros((SP, E * npad), device=dev)
        pim = torch.zeros((SP, E * npad), device=dev)
        pre[2], pre[0], pim[4] = 0.7 * on[0], 0.51 * on[0], 0.5 * on[0]
        excited = ground._replace(
            V=0.3 * torch.randn((3, E * npad), generator=g, device=dev) * on,
            tp=torch.rand((1, E * npad), generator=g, device=dev) * on,
            psi_re=pre, psi_im=pim)
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
            bad = torch.zeros(E * npad, dtype=torch.bool, device=dev)
            for k, x, y in zip(TICK_ATOL, res, ref):
                bad |= ((x - y).abs() > TICK_ATOL[k]
                        + TICK_RTOL * y.abs()).any(0)
            bad &= on[0] > 0
            errs = {k: float((x - y)[:, ~bad].abs().max())
                    for k, x, y in zip(TICK_ATOL, res, ref)}
            pads = max(max(float(x[spec.S:].abs().max()) for x in res[3:]),
                       max(float(x[:, on[0] == 0].abs().max())
                           for x in res[3:]))
            jumps = int((res[2][0][on[0] > 0] < spec.ratio * spec.qdt).sum())
            log(f"[ticks-lane] {key}, {name} start: E={E} x {npad} lanes, "
                f"jumped {jumps}/{E * n}, diverged lanes {int(bad.sum())} "
                f"(allowed {E * MAX_DIVERGED_LANES}), max abs err "
                + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                + f"; max |pad row/lane| {pads:g}")
            if int(bad.sum()) > E * MAX_DIVERGED_LANES:
                raise SystemExit(f"tick kernel {key} disagrees ({name})")
            if pads != 0.0:
                raise SystemExit(f"tick kernel {key}: pad rows/lanes not 0")
            worst = max(worst, *errs.values())
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


def reset_counts():
    from mdqtplasmasims_torch.core.qt_fused import fused_md_substeps
    from mdqtplasmasims_torch.ops import yukawa as ty
    ty.yukawa_forces_n3l_soa.launches = 0
    ty.yukawa_forces_n3l_soa_batched.launches = 0
    fused_md_substeps.launches = 0
    fused_md_substeps.launches_per_lane_e0 = 0
    fused_md_substeps.launches_per_lane_om = 0


def read_counts() -> dict:
    from mdqtplasmasims_torch.core.qt_fused import fused_md_substeps
    from mdqtplasmasims_torch.ops import yukawa as ty
    return dict(yukawa_forces=ty.yukawa_forces_n3l_soa.launches,
                yukawa_forces_batched=ty.yukawa_forces_n3l_soa_batched.launches,
                fused_ticks=fused_md_substeps.launches,
                fused_ticks_per_lane_e0=fused_md_substeps.launches_per_lane_e0,
                fused_ticks_per_lane_om=fused_md_substeps.launches_per_lane_om)


def check_members(name, final, outs, n_js, dirs, n_md):
    """Per member: finite values, Ekin rising from the frozen start, the
    ion-mean S+P+D norm, 12 energies.dat rows and an ions_ file of the
    member's N."""
    import numpy as np
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
        if len(rows) != 12 or n_file != nj:
            raise SystemExit(f"{name}: member {j} wrote {len(rows)} rows and "
                             f"N={n_file} (want 12 and {nj})")


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
        if (counts["yukawa_forces_batched"], counts["fused_ticks"]) != (500,
                                                                       512):
            raise SystemExit(f"ensemble path launched {counts}, want 500 "
                             "batched-force and 512 tick launches")
        dirs = sorted(os.path.dirname(p) for p in glob_all(tmp,
                                                           "energies.dat"))
        if len(dirs) != E:
            raise SystemExit(f"ensemble wrote {len(dirs)} job trees")
        check_members("ensemble", final, outs, n_js, dirs, n_md)
    # resume: tmax=0.5 then resume to 1.0 == uninterrupted 1.0, bitwise
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
    log(f"[ensemble] E=2 fold (N={n2}), tmax 0.5 then resume to 1.0 vs one "
        f"run to 1.0: final R/V/psi/t_part bitwise equal: {same}")
    if not same:
        raise SystemExit("resumed ensemble differs from the uninterrupted "
                         "run")
    return counts


def sweep_path(torch, card):
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, run_sweep)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CoolingConfig(n0=3500, tmax=1.0, save_directory=tmp)
        n_md = int(round(cfg.tmax / cfg.timestep))
        points = [{"detuning": d, "om": o} for d in (-1.0, -0.5)
                  for o in (0.8, 1.2)]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, outs, mcfgs = run_sweep(cfg, points, device="cuda")
        wall = time.perf_counter() - t0
        counts = read_counts()
        E = len(points)
        log(f"[sweep] run_sweep(n0=3500, tmax=1.0) over {points}: {E} "
            f"members in one fold, {n_md} MD steps in {wall:.3f} s -> "
            f"{E * cfg.n0 * n_md * cfg.ratio / wall:.4g} aggregate "
            f"ion-QT-updates/s ({card})")
        log(f"[sweep] launches: {counts}")
        if (counts["yukawa_forces_batched"], counts["fused_ticks_per_lane_e0"],
                counts["fused_ticks_per_lane_om"]) != (500, 512, 512):
            raise SystemExit(f"sweep path launched {counts}, want 500 "
                             "batched-force and 512 per-lane tick launches")
        from mdqtplasmasims_torch.experiments.laser_cooling import _save_dir
        dirs = [_save_dir(c) for c in mcfgs]
        if len(set(dirs)) != E:
            raise SystemExit("sweep points share a directory")
        check_members("sweep", final, outs, [cfg.n0] * E, dirs, n_md)
    return counts


def glob_all(root, name):
    return [os.path.join(d, name) for d, _, fs in os.walk(root) if name in fs]


def np_isfinite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(np.asarray(a)).all())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from mdqtplasmasims_torch import _build
    from mdqtplasmasims_torch.core import qt_fused
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    from mdqtplasmasims_torch.ops import yukawa
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

    # one nvcc per source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(yukawa._lib), pool.submit(qt_fused._lib)]:
            fut.result()
    log(f"[build] both kernel libraries loaded in "
        f"{time.perf_counter() - t0:.1f} s (nvcc: " + ", ".join(f"{k} {v:.1f} s"
                               for k, v in _build.build_seconds.items())
        + ")")
    for name in ("yukawa_forces", "fused_ticks"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    cfg = lc.CoolingConfig()
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    log(f"[config] N0={cfg.n0} L={L:.6f} lambda_D={pu.debye_length:.6f} "
        f"ratio={cfg.ratio} qdt={cfg.qdt:g}")
    force = check_force_kernel(torch, L, pu.debye_length)
    ticks = check_tick_kernel(torch, cfg, L, pu.debye_length)
    counts = main_path(torch, smi)
    force_e = check_batched_force_kernel(torch, L, pu.debye_length)
    lanes = check_lane_kernels(torch, cfg)
    ens_counts = ensemble_path(torch, smi)
    sweep_counts = sweep_path(torch, smi)

    log(f"[env] card: {smi}")
    src_f = "mdqtplasmasims_torch/csrc/yukawa_forces.cu"
    src_t = "mdqtplasmasims_torch/csrc/fused_ticks.cu"
    tpu_t = "mdqtplasmasims_tpu/core/qt_fused.py:93"
    kernels = [
        dict(name="yukawa_forces", route="cuda", source=src_f,
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:302",
             launches=counts[0], **force),
        dict(name="yukawa_forces_batched", route="cuda", source=src_f,
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:411",
             launches=ens_counts["yukawa_forces_batched"], **force_e),
        dict(name="fused_ticks", route="cuda", source=src_t, replaces=tpu_t,
             launches=counts[1], **ticks),
        dict(name="fused_ticks_per_lane_e0", route="cuda", source=src_t,
             replaces=tpu_t,
             launches=sweep_counts["fused_ticks_per_lane_e0"],
             **lanes["per_lane_e0"]),
        dict(name="fused_ticks_per_lane_om", route="cuda", source=src_t,
             replaces=tpu_t,
             launches=sweep_counts["fused_ticks_per_lane_om"],
             **lanes["per_lane_om"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
