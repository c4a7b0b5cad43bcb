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
     with the kernels' launch counts and physics checks.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Uses no JAX.
"""

from __future__ import annotations

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
        yukawa_forces_n3l_soa.launches = 0
        fused_md_substeps.launches = 0
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

    t0 = time.perf_counter()
    yukawa._lib()
    qt_fused._lib()
    log(f"[build] both kernels loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc: " + ", ".join(f"{k} {v:.1f} s"
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

    log(f"[env] card: {smi}")
    kernels = [
        dict(name="yukawa_forces", route="cuda",
             source="mdqtplasmasims_torch/csrc/yukawa_forces.cu",
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:302",
             launches=counts[0], **force),
        dict(name="fused_ticks", route="cuda",
             source="mdqtplasmasims_torch/csrc/fused_ticks.cu",
             replaces="mdqtplasmasims_tpu/core/qt_fused.py:93",
             launches=counts[1], **ticks),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
