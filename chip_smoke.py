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
     plus the expansion detuning with renormalization; timed, with the
     form's registers, spills and shared memory from the nvcc log; then
     (:func:`check_tick_shapes`) at a mesh shard's shape (875 ions in 1792
     lanes), at 1 and 24 ticks (the split sampling step) and on an 8-member
     fold, each also bitwise run to run and bitwise equal to the same
     lanes launched in two parts; then (:func:`check_small_tick_kernels`)
     every S = 3, 5, 7 form, plain and per-lane (e0, om, e0+om), at the
     shapes the three-state run and sweep, the frozen-tag pump and the
     MC-tag pump launch them, and the 408 linear pump's (free ions: F =
     0, a dummy R; a pump form leaves V bit for bit; a sweep form's
     members at the base equal the plain form bit for bit; a pump's
     compiled coupling pattern equals the dense pattern's form bit for
     bit), each through the same shapes, timed, and on 32 ions in cycles
     a tick (one thread an ion at every S);
     then (:func:`check_ion_sass`) the S = 3, 5, 7 forms' machine code:
     no shuffle or vote, no register load of a roll in the tick loop, the
     rolls fetched ticks ahead, each pump pattern's tick fewer
     instructions than the dense pattern's;
  5. the in-kernel RNG form of the tick kernel against its twin (which
     draws the same Threefry stream in plain torch) at Np=3584, ratio 25,
     from the ground and the excited start and late in a flagship run's
     clock, and its per-lane forms on a 4-member fold; timed; the shapes
     of phase 4 again (the shard with ``lane0`` 1792, the parts with the
     ``lane0`` of their first lane), the per-lane forms on an 8-member fold;
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
     timed there and at the shape phase 17's ring run launches it (one
     member's shard of 875 ions in 1792 lanes);
  9. the per-lane (sweep) variants of the tick kernel (explicit rolls)
     against their twin on a 4-member fold at the flagship shapes, each
     member with its own e0 and (om, om_dp), from the ground and the
     excited start, and on an 8-member fold;
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
     checkpoint's vholder;
 15. kernel E (rows x gathered columns) against its plain version at the
     shapes and in the form phase 17's gather run launches it (one member
     per slot, rows 1792 lanes of 875 ions with the shard's row mask
     handed to the kernel, columns 4 x 1792), run to run, masked rows
     exactly 0, timed; the same without the row mask; then 2 Poissonian
     members per slot, and a member's own 3584 lanes as its columns,
     bitwise against kernel C on real rows;
 16. kernel F (cross-block half pairs) against its plain version at the
     shapes phase 17's ring run gives it (two 1792-lane shards of 875 ions,
     one member), its rows against E(rows, cols B) and its reactions
     against E(rows B, cols A); F and G bitwise equal run to run; timed;
     then blocks of 2 Poissonian members;
 17. the mesh path: ``run_ensemble(CoolingConfig(n0=3500, tmax=1.0),
     n_jobs=2)`` on ``make_mesh(2, 4, devices=[cuda:0]*8)`` with the
     gather (kernel E) and the ring-N3L (kernels C and F) schedules, each
     with launch counts, per-member physics and files, start-of-step forces
     against kernel C on the unsharded fold, and a tmax=0.5 window resumed
     on the mesh to 1.0 bitwise equal to the uninterrupted run; then an
     ens-only (2, 1) mesh bitwise equal to the unsharded 2-member fold;
 18. the ``[E, N, 3]`` force entry (kernel C) with a holed per-member
     ``[E, N]`` mask against its plain version, and the force and potential
     entries timed at the shapes the frozen-start tagging family gives
     them;
 19. the frozen-start tagging family, one job at full width:
     ``frozen_tagging.run(FrozenTagConfig(tstart=0.3, tmax=1.0))``
     (422linear, N0=3500, 500 MD steps with the pump window inside, 7
     output blocks), with the launch counts (kernel A once per MD step + 1
     for the seed of F, kernel D once per block + the tag block + epot0,
     kernel B's S=5 form once per MD step with a pump tick, nothing else),
     the energy audit, the tag fraction, the files and
     labels of the tree, then ``run(resume=True)`` to tmax=1.2 appending
     rows on the same grid;
 20. its fold: ``run_ensemble(n_jobs=8, exact_n=False)`` at the same cut
     (kernel C once per MD step + 1, kernel G once per block + 2 and the
     S=5 tick form once per pumping MD step for all members, no launch of
     A or D), padded lanes exactly 0 at the end, members that differ,
     trees sized to each member's N; then 2-point ``run_sweep``s over the
     pump's detuning, Rabi frequency and both (the S=5 e0, om and e0+om
     forms) whose member at the config's own (detuning, om) equals the
     2-member ensemble's bit for bit;
 21. the 408quad variant at N0=3500 to tmax=0.4 (the S=7 tick form, the
     full output row at the tag instant, vSquareAutoCorr.dat);
 22. the three-state family at full width through the S=3 tick forms:
     ``three_state.run``, an 8-job ``run_ensemble`` and a 2 x 2
     ``run_sweep`` of ThreeStateConfig() (n0=1000) to tmax=30 (3000
     ticks; the folds to 20) and 2-point detuning and Rabi sweeps, each
     with its exact launches (one per block of ticks), x kinetic energy
     falling, ticks/s and host ms per tick printed; then the 8-job fold
     through ``member_sharded`` over 2 slots on cuda:0, bitwise equal to
     the unsharded fold;
 23. the Metropolis chain at full width (n = 4096, plain torch, no
     kernel): 2000 steps of one job and of an 8-member fold with
     per-member generators from the lattice start, ms per MC step, the
     acceptance band of tests/test_classical.py:187, the correlation hole
     of g(r); 200 float64 steps on the card against the same draws on the
     CPU (accept count exact, R within 1e-12);
 24. the transport family: ``mc_md_anisotropy.run`` at n = 4096 cut to
     2000 MC and 751 MD steps (:data:`TRANSPORT_CUT`), with checkpoints:
     kernel A once per MD step + 1, nothing else; VAF(0), the
     instantaneous anisotropy (x hot by the applied 15 %) relaxing, the
     tree; a crash mid-record resumed bit for bit; host ms per MD step of
     a job and of a fold of 8;
 25. the MC-tagging family: ``mc_qt_tagging.run`` (408quad, n = 4096,
     2000 MC steps, the production pump window of 23 MD steps = 1426
     ticks, 200 recorded steps): kernel A and the S=7 tick form (once per
     pump MD step) counts exact, tag fraction in (0, 1), the tree; an
     8-member fold (kernel C and S=7 counts exact, A none); 2-point
     detuning, Rabi and detuning+Rabi sweeps (the S=7 per-lane forms)
     whose identity member equals the 2-member ensemble's bit for bit;
     host ms per pump MD step, and the production times the measured
     rates imply;
 26. a 2 x 2 (Gamma, kappa) transport sweep through kernel C with a
     per-member ``ldeb [E]``: counts exact, the MD's start forces of each
     member against the plain version at that member's ldeb.

 27. the presets and the ``.dat`` codec at full width:
     ``run(presets.north_star(save_directory=...))`` (CoolingConfig(), N0 =
     3500, tmax=30: 15,000 MD steps, 375 samples) with its tree through
     the codec, timed, and once more without the tree; the same run's
     outputs and final state written again through the codec and through
     the Python ``%g`` path (both timed), each tree equal to the run's
     byte for byte (the ``.npz`` array by array); then
     ``run(presets.pre_speedup(save_directory=...))`` unmodified (N0 =
     3500, tmax=30, physics "pre_speedup", 13 VAF intervals, LCCF) with
     exact launch counts (A once per MD step, B'rng once per MD step +
     once per sample, D once per sample + 1, nothing else), phase 14's
     VAF(0), VZERO and J(k) checks on all 13 intervals, the energy audit
     falling below 0 and the S+P+D norm;
 28. the host tools on the card's trees: ``analysis.analyze_job``,
     ``quicklook.collect_panels`` (the expected panel titles) and ``cli
     analyze --json`` (rc 0, the same report) on both trees of phase 27
     (pre-speedup: Green-Kubo D finite and positive, the dispersion, S(k)
     of the final checkpoint); an 8-member Poissonian ``run_ensemble``
     (n0=3500, tmax=1.0) timed with and without its trees, its member
     trees written again through both formatters (timed, byte for byte
     equal), and ``analyze_ensemble`` on its parameter directory;
 29. a first profiler trace: ``profiling.device_trace`` (torch.profiler,
     CPU + CUDA) around ``run(CoolingConfig(tmax=0.4))`` (200 MD steps);
     the trace must hold kernel A's and kernel B'rng's CUDA symbols once
     per MD step; prints the five device operations that took most time
     and the card's busy share of the traced window, and holds a
     ``PhaseTimer`` with ``block_on`` over the same run to at least the
     card's busy time;
 30. a production job uncut: the frozen-start tagging family at the
     reference's operating point (``FrozenTagConfig()``: 422linear, N0 =
     3500, tstart=15, tmax=25; 12,500 MD steps) through the production
     soak's own function and metric extraction
     (``tools/torch_soak.py::soak_frozen``), held to the frozen soak bands
     of tests/test_physics_targets.py::TestFullScaleSoak and to exact
     launch counts (kernel A once per MD step + 1, D once per block + 2,
     the S=5 tick form once per pumping MD step, nothing else), with its
     tree's files and labels; the wall printed
     with the card's name and power limit, and split against phase 19's
     cut job (the same pump window) into MD steps and the pump's ticks;
 31. the reference's 99-job campaign (``tools/torch_campaign99.py``, the
     flagship as one fold of 99 members) cut to tmax=0.4 (200 MD steps, 5
     samples): kernel C once per MD step, B'rng once per MD step + once
     per sample, G once per sample + 1, nothing else; run twice, bitwise
     equal, every member's final EkinX distinct; then one launch each of
     C, B'rng and G at E=99 on its final state against the plain version
     of the whole launch, timed;
 32. the analysis layer's tools: ``tools/torch_validate_analysis.py`` at
     its ``--fast`` sizes, sections A, C and D (N=216: the Gamma=3
     trajectory and the Gamma=50 one; kernel A once per MD step + once a
     trajectory, nothing else; the JAX record's keys of those sections,
     every number finite, float32), ``tools/torch_lccf_dispersion.py``'s
     laser-free flagship (N0=1024) cut to tmax=12 with the first 4
     omega_E^-1 dropped (the scheme's coupling all zero; A once per MD
     step, B'rng once per MD step + once per sample, D once per sample +
     1; the JAX tool's keys, every number finite), then kernel A at N=216
     and N=512 (a lattice after 2000 Metropolis steps) against its plain
     version, timed with its bound;
 33. the JAX package's remaining physics targets and its examples at
     their full sizes (``tools/torch_physics_targets.py``'s
     ``run_targets``, each target's launches counted from 0): the DIH
     curve (N=512 from the JAX test's start, 2000 steps, kernel A once a
     step), the f32-vs-f64 budget (N=256 x 800 steps through A, and in
     float64 through the plain all-pairs version, the reference: no
     launch), the EIT resonance (600 free ions, 3000 ticks of the S = 12
     explicit form in launches of 1000), the dark-state dip of the written
     population files at (detSP, detDP) = (-1, 1) and (-0.5, 1) (A once
     per MD step, B'rng once per MD step + once per sample, D once per
     sample + 1) and the tagged class (C once per MD step + 1, B's S = 5
     per-lane e0 form once per pump-window step, G once per block + 2),
     each held to its launches and its JAX test's asserts; a miss raises,
     unless it is a dip run that wrote the archived population files
     byte for byte (the archived run, whose misses tier-1's archive test
     reports); then the three examples (``examples/torch_*.py``: the
     dark-state and Rabi sweeps, C, the per-lane e0 or om form of B'rng
     and G; the tag-class sweep, C, B's S = 5 per-lane e0 form and G),
     each held to its exact launches and its physics; the phase's wall
     logged;
 34. the mesh on distinct cards, its slots here all on the one card
     (``mesh_cards_path``): a 4 x 1 frozen-tag fold of 8 cut to tmax=1.0
     through ``member_sharded`` with its blocks in the slots' worker
     processes (the form it takes on several cards) bitwise equal to the
     same fold one block after the other, each launching 4x the
     unsharded fold's kernels (the workers' launches counted here); then
     the 4 x 1 cooling mesh of 8 jobs cut to tmax=0.2 bitwise equal to
     the unsharded fold of 8 (final states and samples: a member's force
     sums do not depend on its fold's width), exact C / B'rng / G
     launches.

Phases 7, 10, 11, 12, 17, 19-27 and 30-34 each set the launch counts to 0
just before they drive their path and read them just after; with them a
count of the plain engine's ticks (``QTEngine.step_sm`` calls,
:class:`PlainTicks`), which every phase wants at 0.  The line before the
last is a JSON object with one entry per kernel and form (26: A, C, D,
G, E, F and B's 20 forms; A, D and B'rng also with their counts from
phase 27's pre-speedup run, ``launches_pre_speedup``, A, D and B's S=5
form with phase 30's, ``launches_frozen_production``, C, B'rng and G with
phase 31's, ``launches_campaign99``, and their E=99 launch's readings and
bound, ``e99``; A, B'rng and D with phase 32's laser-free flagship's,
``launches_lccf``, A with its validation trajectories',
``launches_validate_analysis``, and its readings at N=216 and N=512,
``n216`` and ``n512``; every form phase 33 runs with its targets' and
its examples' counts, ``launches_physics_targets`` and
``launches_examples``, and every form phase 34 runs with its count,
``launches_mesh_cards``), each with its bound
(the larger of its operations over the card's FP32 peak and its bytes
over the memory rate, counted from this run's inputs: :func:`bound`)
and two readings of its time (``ms``: device time; ``idle_card_ms``: from
an idle card, the wrapper's host time included: :func:`cuda_ms`); the
last line is ``{"ok": true, "device": {...}}``.  Uses no JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import glob
import json
import os
import re
import shutil
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
# rounding of dp0 and was decided differently (expected ~0 of 3500), per
# member and per DIVERGE_TICKS ticks of a launch: the chance grows with the
# ticks over which the two roundings drift apart.  The three-state toy's
# launches (838-1000 ticks) are held to LONG_LAUNCH_LANES per member
# instead: 3x the most lanes seen to diverge in a launch of one member on
# the H100 (10, a 875-ion mesh shard at 1000 ticks; 2 in a 1000-ion job;
# 7-14 in all in launches of four 1000-ion members, 29-49 in E=8 folds of
# 3500-ion members)
MAX_DIVERGED_LANES = 3
DIVERGE_TICKS = 25
LONG_LAUNCH_LANES = 30


def allowed_lanes(members: int, ticks: int) -> int:
    """Lanes of a launch allowed to diverge: :data:`MAX_DIVERGED_LANES` per
    member and :data:`DIVERGE_TICKS` ticks, at most
    :data:`LONG_LAUNCH_LANES` per member."""
    return members * min(MAX_DIVERGED_LANES * -(-ticks // DIVERGE_TICKS),
                         LONG_LAUNCH_LANES)
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

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): FP32 outside
# the tensor cores and HBM3 bandwidth; every kernel here is FP32 SIMT
H100_FP32_OPS = 67e12
H100_HBM_BYTES = 3.35e12
# FP32 operations of one pair evaluation of the force kernels, counted on
# csrc/yukawa_forces.cu's pair math: 3 differences, 3 minimum-image
# corrections of 3 operations, r^2 5, 1/r and r 2, the exponent 2 (rsqrt
# and exp counted as one each), the force factor 4, three accumulations 6;
# the potential adds 2, kernel F's column reaction 6 more
PAIR_OPS = 31
POT_OPS = 2
REACTION_OPS = 6


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of ``ops`` FP32
    operations at the FP32 peak and ``nbytes`` at the memory rate; and the
    library yardstick (no single torch call computes any of these
    kernels' functions, so None)."""
    t_ops, t_bytes = ops / H100_FP32_OPS, nbytes / H100_HBM_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None)


def half_pairs(counts) -> int:
    """Unordered pairs of real ions, the work of a force function over one
    member's ions (Newton's third law: each pair once)."""
    return sum(int(n) * (int(n) - 1) // 2 for n in counts)


def tick_ops(spec) -> int:
    """FP32 operations of one ion's tick of ``spec``, counted on
    csrc/fused_ticks.cu over the work the scheme's data needs
    (its coupling is sparse: a dense S x S product would count zeros):
    each of the 4 RK stages 4 per real coupling place (one real multiply-
    add on each of the two planes; the per-lane om forms' coupling is one
    list whose coefficients om * c_sp + om_dp * c_dp the kernel forms once
    a launch) and 8 per place with a beat note (a complex coefficient),
    plus 16 S for the diagonal, decay, dp and slope; 22 S for the stage
    combinations, collapse and merge; 6 per Ehrenfest term; 24 for the
    leapfrog; 180 integer operations for the in-kernel RNG's three
    Threefry calls."""
    import numpy as np
    from mdqtplasmasims_torch.core import qt_fused as tf
    S, SP = spec.S, spec.SP
    plan = tf._kernel_plan(spec)
    tab = plan.lane_table.reshape(SP, len(tf.ROW_PLANES), plan.K)
    coupled = (tab[:, 1] != 0) | (tab[:, 2] != 0)
    beat = tab[:, 3] != 0
    stage = (4 * int(np.sum(coupled & ~beat)) + 8 * int(np.sum(beat))
             + 16 * S)
    return (4 * stage + 22 * S + 6 * len(tf._force_terms(spec)) + 24
            + (180 if spec.internal_rng else 0))


def tick_bound(spec, n_real: int, lanes: int) -> dict:
    """Bound of one launch of the tick kernel of ``spec`` over ``lanes``
    lanes of which ``n_real`` hold ions: :func:`tick_ops` a tick of each
    ion; the bytes of the planes read and written once, plus the explicit
    rolls and the per-lane tables."""
    SP = spec.SP
    rows = ((10 + 2 * SP) + (7 + 2 * SP)
            + (0 if spec.internal_rng else 5 * spec.ratio)
            + (SP if spec.per_lane_e0 else 0)
            + (2 if spec.per_lane_om else 0))
    return bound(n_real * spec.ratio * tick_ops(spec), 4 * rows * lanes)


def log(msg: str) -> None:
    print(msg, flush=True)


# floats of the buffer whose in-place update (1 GiB read, 1 GiB written:
# some 0.7 ms of memory traffic) occupies the card ahead of a timed call
BALLAST_FLOATS = 1 << 28
_ballast = []


def cuda_ms(torch, fn, reps: int = N_TIMED, head_start: bool = True) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls, between two CUDA
    events.  With ``head_start`` a long memory-bound update is queued ahead
    of the start event, so the host has enqueued the whole call before the
    card reaches it: device time, also for a call whose kernels take less
    time than its Python wrapper.  Without it the card is idle when the
    call begins, and the reading holds whatever of the wrapper's host time
    the kernels do not cover (what a path pays for the call when nothing
    else keeps the card busy; the clock of this script's earlier
    versions)."""
    if head_start and not _ballast:
        _ballast.append(torch.zeros(BALLAST_FLOATS, device="cuda"))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if head_start:
            _ballast[0].add_(1.0)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(torch, fn):
    """Both readings of a kernel's wrapper: (device ms, ms from an idle
    card), see :func:`cuda_ms`."""
    return cuda_ms(torch, fn), cuda_ms(torch, fn, head_start=False)


def both(ms: float, idle: float) -> str:
    return f"{ms:.4f} ms ({idle:.4f} from an idle card)"


def check_force_kernel(torch, R, L, ldeb, tag="[force]"):
    """Kernel A on ``n`` ions ``R [n, 3]`` (on the card, in 512 lanes)
    against its plain version: within :data:`FORCE_TOL`, deterministic run
    to run, padded lanes exactly 0; timed with its bound."""
    from mdqtplasmasims_torch.ops import yukawa as ty
    n = R.shape[0]
    Rp, rows, npad = ty._pack_lanes(R[None], None, 512)
    F = ty.yukawa_forces_n3l_soa(Rp, rows, L, ldeb)
    F2 = ty.yukawa_forces_n3l_soa(Rp, rows, L, ldeb)
    ref = ty.yukawa_forces_n3l_soa_reference(Rp, rows, L, ldeb)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((F - ref).abs().max())
    log(f"{tag} Rp [3,{npad}], {n} real lanes, L={L:.6f}, "
        f"lambda_D={ldeb:.6f}: max|F|={scale:.6g} max abs err={err:.3g} "
        f"(rel {err / scale:.3g}, tol {FORCE_TOL:g} of max|F|)")
    if not err <= FORCE_TOL * scale:
        raise SystemExit(f"force kernel at N={n} disagrees with its twin")
    if not torch.equal(F, F2):
        raise SystemExit(f"force kernel at N={n} is not deterministic run "
                         f"to run")
    if bool(F[:, n:].any()):
        raise SystemExit(f"force kernel at N={n}: padded lanes are not "
                         f"exactly zero")
    ms, idle = kernel_ms(torch, lambda: ty.yukawa_forces_n3l_soa(
        Rp, rows, L, ldeb))
    plain = cuda_ms(torch, lambda: ty.yukawa_forces_n3l_soa_reference(
        Rp, rows, L, ldeb))
    log(f"{tag} kernel {both(ms, idle)}, plain torch {plain:.4f} ms "
        f"(median of {N_TIMED})")
    return dict(max_abs_err=err, ms=ms, idle_card_ms=idle, plain_ms=plain,
                **bound(half_pairs([n]) * PAIR_OPS, 4 * 7 * npad))


def random_ions(torch, n: int, L: float, seed: int = 11):
    """``n`` ions uniform in the box, ``[n, 3]`` on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.rand((3, n), generator=g, device="cuda") * L).T


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
    pads = max(max(float(x[spec.S:].abs().max()),     # SP > S always
                   float(torch.where(on, 0.0, x).abs().max()))
               for x in out[3:])
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


def kernel_resources() -> dict:
    """Registers, stack, spill bytes of every instantiation of the tick
    kernel, from the nvcc log (``-Xptxas -v``) of the library in use:
    ``(S, pattern, per_lane_e0, per_lane_om, internal_rng, long_rows) ->
    dict`` (the ion kernel, one thread an ion at S = 3, 5, 7, has neither
    RNG nor long rows and is named by its compiled coupling pattern,
    ``qt_fused.ION_PATTERNS``; the group kernel's pattern is "")."""
    from mdqtplasmasims_torch import _build
    from mdqtplasmasims_torch.core import qt_fused as tf
    names = {(S, m): n for n, S, m in tf.ION_PATTERNS}
    entry = re.compile(r"fused_ticks_kernelILi(\d+)ELi\d+ELb([01])ELb([01])"
                       r"ELb([01])ELb([01])EE")
    ion = re.compile(r"fused_ticks_ion_kernelILi(\d+)EL[my](\d+)ELb([01])"
                     r"ELb([01])EE")
    out, key = {}, None
    for line in _build.build_log("fused_ticks").splitlines():
        m, mi = entry.search(line), ion.search(line)
        if m and "Compiling entry" in line:
            key = (int(m.group(1)), "",
                   *(g == "1" for g in m.groups()[1:]))
            out[key] = {}
        elif mi and "Compiling entry" in line:
            S = int(mi.group(1))
            key = (S, names.get((S, int(mi.group(2))), mi.group(2)),
                   mi.group(3) == "1", mi.group(4) == "1", False, False)
            out[key] = {}
        elif key is not None and "spill stores" in line:
            out[key].update(zip(("stack", "spill_stores", "spill_loads"),
                                map(int, re.findall(r"(\d+) bytes", line))))
        elif key is not None and "registers" in line:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  line).group(1))
    return out


def resources(spec) -> str:
    """The registers, spills and shared memory of ``spec``'s kernel form."""
    from mdqtplasmasims_torch.core import qt_fused as tf
    plan = tf._kernel_plan(spec)
    K = plan.K
    pattern = ({m: n for n, S, m in tf.ION_PATTERNS if S == spec.S}
               [plan.pattern] if plan.ion_table is not None else "")
    res = kernel_resources().get((spec.S, pattern, spec.per_lane_e0,
                                  spec.per_lane_om, spec.internal_rng,
                                  K > tf._KREG))
    if not res:
        raise SystemExit("the nvcc log does not list this form of the tick "
                         "kernel")
    geo = tf.launch_geometry(3584, spec.S, K)
    return (f"{pattern + ' pattern, ' if pattern else ''}"
            f"{res['registers']} registers, {res['spill_stores']} / "
            f"{res['spill_loads']} B spill stores / loads, {res['stack']} B "
            f"stack, {geo.shared_bytes} B shared, {geo.lanes_per_ion} lanes "
            f"per ion")


def excited_rows(spec) -> tuple:
    """The states :func:`excited_planes` populates: ground state 0 and, for
    sr12, P states 2 and 4 (:func:`excite`'s start); for the small schemes
    the first and the last state a jump projects from."""
    src = spec.scheme.jump_src
    return (0, 2, 4) if spec.S == 12 else (0, src[0], src[-1])


def excited_planes(torch, g, SP, members, npad, n_real, rows=(0, 2, 4)):
    """``(on, (R, V, F, tp, psi_re, psi_im))`` of ``members`` blocks of
    ``npad`` lanes with ``n_real`` ions each, the excited states ``rows[1:]``
    populated so that jumps fire (the start of :func:`excite`, without a
    scheduler; :func:`excited_rows`)."""
    dev = g.device
    lanes = members * npad
    on = (torch.arange(lanes, device=dev) % npad) < n_real
    m = on.float()
    rand = lambda rows: torch.rand((rows, lanes), generator=g, device=dev)
    pre = torch.zeros((SP, lanes), device=dev)
    pim = torch.zeros((SP, lanes), device=dev)
    ground, up, down = rows
    pre[up], pre[ground], pim[down] = 0.7 * m, 0.51 * m, 0.5 * m
    return on, (rand(3) * 5.0 * m, (rand(3) - 0.5) * m, (rand(3) - 0.5) * m,
                rand(1) * m, pre, pim)


def check_tick_shapes(torch, spec, tables, g, what, folds=(1, 8),
                      sweep=(None, None), free=False):
    """The tick kernel of ``spec`` against its twin away from the flagship
    launch: a mesh shard's shape (875 ions in 1792 lanes; the RNG form with
    ``lane0`` 1792), 1 and 24 ticks, and a fold of ``folds[-1]`` members.
    Each launch twice (bitwise equal) and as two launches of half the lanes
    (the RNG form with the ``lane0`` of each part's first lane; bitwise
    equal to the whole).  ``sweep`` holds the per-member e0 rows and (om,
    om_dp) pairs of a per-lane form; ``free`` gives the launches F = 0, as
    the free-ion paths do.  Returns the worst error."""
    import itertools
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    dev = torch.device("cuda")
    seed = torch.tensor([192837465], dtype=torch.int32, device=dev)
    cases = []
    if 1 in folds:
        cases += [("a mesh shard", 1, MESH_NPAD, 3500 // MESH_I, spec.ratio),
                  ("1 tick", 1, 3584, 3500, 1),
                  ("24 ticks", 1, 3584, 3500, 24)]
    if folds[-1] > 1:
        cases.append((f"an E={folds[-1]} fold", folds[-1], 3584, 3500,
                      spec.ratio))
    worst = 0.0
    for name, members, npad, n_real, ticks in cases:
        sp = dataclasses.replace(spec, ratio=ticks)
        lanes = members * npad
        on, args = excited_planes(torch, g, sp.SP, members, npad, n_real,
                                  excited_rows(sp))
        if free:
            args = args[:2] + (torch.zeros_like(args[2]),) + args[3:]
        e0p, omp = fold_sweep_lanes(
            sp, npad, *(None if x is None else list(itertools.islice(
                itertools.cycle(x), members)) for x in sweep), dev)
        rolls = (None if sp.internal_rng
                 else torch.rand((ticks * 5, lanes), generator=g, device=dev))
        lane0 = MESH_NPAD if sp.internal_rng and npad == MESH_NPAD else 0

        def launch(lo, hi, fn=tf.fused_md_substeps):
            cut = lambda x: None if x is None else x[:, lo:hi].contiguous()
            kw = dict(tick0=4321, e0_lanes=cut(e0p), om_lanes=cut(omp))
            if sp.internal_rng:
                kw.update(seed=seed, lane0=lane0 + lo)
            if fn is tf.fused_md_substeps:
                return fn(sp, False, *map(cut, args), cut(rolls),
                          tables=tables, **kw)
            return fn(sp, False, *map(cut, args), cut(rolls), tables, **kw)

        out, again = launch(0, lanes), launch(0, lanes)
        ref = launch(0, lanes, tf.fused_md_substeps_reference)
        parts = [launch(0, lanes // 2), launch(lanes // 2, lanes)]
        torch.cuda.synchronize()
        worst = max(worst, compare_ticks(
            torch, sp, out, ref, on, allowed_lanes(members, ticks),
            f"{what} {name} ({n_real} ions in {npad} lanes x {members}, "
            f"{ticks} ticks, lane0 {lane0})"))
        if not all(torch.equal(x, y) for x, y in zip(out, again)):
            raise SystemExit(f"{what} {name}: not bitwise equal run to run")
        if not all(torch.equal(x, torch.cat([a, b], 1))
                   for x, a, b in zip(out, *parts)):
            raise SystemExit(f"{what} {name}: a whole launch differs from the "
                             "same lanes launched in two parts")
    log(f"{what}: every shape bitwise equal run to run and to its two-part "
        f"launch")
    return worst


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
    worst = max(worst, check_tick_shapes(torch, spec, sched.tables, g,
                                         "[ticks]"))
    rolls = torch.rand((spec.ratio * 5, npad), generator=g, device=dev)
    args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im, rolls)
    ms, idle = kernel_ms(torch, lambda: tf.fused_md_substeps(
        spec, False, *args, tick0=1000, tables=sched.tables))
    plain = cuda_ms(torch, lambda: tf.fused_md_substeps_reference(
        spec, False, *args, sched.tables, tick0=1000), reps=20)
    log(f"[ticks] kernel {both(ms, idle)}, plain torch {plain:.4f} ms per "
        f"{spec.ratio}-tick MD step (median of {N_TIMED}/20); "
        f"{resources(spec)}")
    return dict(max_abs_err=worst, ms=ms, idle_card_ms=idle, plain_ms=plain,
                **tick_bound(spec, n, npad))


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
    worst = max(worst, check_tick_shapes(torch, spec, sched.tables, g,
                                         "[ticks-rng]"))
    args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im)
    ms, idle = kernel_ms(torch, lambda: tf.fused_md_substeps(
        spec, False, *args, tick0=4321, tables=sched.tables, seed=seed))
    plain = cuda_ms(torch, lambda: tf.fused_md_substeps_reference(
        spec, False, *args, None, sched.tables, tick0=4321, seed=seed),
        reps=20)
    log(f"[ticks-rng] kernel {both(ms, idle)}, plain torch {plain:.4f} ms per "
        f"{spec.ratio}-tick MD step (median of {N_TIMED}/20); "
        f"{resources(spec)}")
    out["fused_ticks_rng"] = dict(max_abs_err=worst, ms=ms,
                                  idle_card_ms=idle, plain_ms=plain,
                                  **tick_bound(spec, n, npad))

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
        worst = max(worst, check_tick_shapes(
            torch, spec, sc.tables, g, f"[ticks-rng] {key[12:]}", folds=(8,),
            sweep=(sweep_e0 if pe0 else None, oms if pom else None)))
        args = (exc.R, exc.V, FE, exc.tp, exc.psi_re, exc.psi_im)
        ms, idle = kernel_ms(torch, lambda: tf.fused_md_substeps(
            spec, False, *args, tick0=4321, tables=sc.tables, e0_lanes=e0p,
            om_lanes=omp, seed=seed))
        plain = cuda_ms(torch, lambda: tf.fused_md_substeps_reference(
            spec, False, *args, None, sc.tables, tick0=4321, e0_lanes=e0p,
            om_lanes=omp, seed=seed), reps=10)
        log(f"[ticks-rng] {key[12:]}: kernel {both(ms, idle)}, plain torch "
            f"{plain:.4f} ms per {spec.ratio}-tick MD step of the E={E} "
            f"fold (median of {N_TIMED}/10); {resources(spec)}")
        out[key] = dict(max_abs_err=worst, ms=ms, idle_card_ms=idle,
                        plain_ms=plain,
                        **tick_bound(spec, E * n, E * npad))
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
    ms_d, idle_d = kernel_ms(torch, lambda: ty.yukawa_forces_potential_pallas(
        R, L, ldeb))
    plain_d = cuda_ms(torch, lambda: ty.yukawa_forces_potential(R, L, ldeb),
                      reps=10)
    log(f"[potential] D at N={n}: kernel {both(ms_d, idle_d)}, plain torch "
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
    ms_g, idle_g = kernel_ms(
        torch, lambda: ty.yukawa_forces_potential_pallas_batched(
            RE, L, ldeb, mask=masks))
    plain_g = cuda_ms(torch, lambda: [ty.yukawa_forces_potential(
        RE[j], L, ldeb, masks[j]) for j in range(E)], reps=10)
    log(f"[potential] G at E={E}: kernel {both(ms_g, idle_g)}, plain torch "
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
    npad_d = -(-n // 512) * 512
    npad_g = -(-n_arr // 512) * 512
    return (dict(max_abs_err=worst_d, ms=ms_d, idle_card_ms=idle_d,
                 plain_ms=plain_d,
                 **bound(half_pairs([n]) * (PAIR_OPS + POT_OPS),
                         4 * 8 * npad_d)),
            dict(max_abs_err=worst_g, ms=ms_g, idle_card_ms=idle_g,
                 plain_ms=plain_g,
                 **bound(half_pairs(n_js) * (PAIR_OPS + POT_OPS),
                         4 * 8 * E * npad_g)))


def small_tick_forms():
    """The S = 3, 5 and 7 forms of the tick kernel as the families' main
    paths launch them (free ions: F = 0, a dummy R; core/scheduler.
    free_ion_spec): ``name -> (spec, members, n_real, npad, e0 rows, (om,
    om_dp) pairs)``.  Three-state: one job of ThreeStateConfig() (n0 =
    1000 in 1024 lanes, 1000 ticks a launch) and the 2 x 2 (detuning, om)
    sweep of phase 22 (4 members, 838 ticks a launch); the 422linear pump
    window of FrozenTagConfig() (3500 ions in 3584 lanes, 22 ticks a
    launch) and phase 20's 2-point sweeps; the 408quad pump of
    MCTagConfig() (4096 ions, 62 ticks a launch) and phase 25's sweeps."""
    from mdqtplasmasims_torch.core.scheduler import free_ion_spec
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    from mdqtplasmasims_torch.experiments import mc_qt_tagging as mt
    from mdqtplasmasims_torch.experiments import three_state as ts
    from mdqtplasmasims_torch import levels
    t_cfg, f_cfg = ts.ThreeStateConfig(), ft.FrozenTagConfig()
    m_cfg = mt.MCTagConfig(variant="408quad")
    families = (
        # (S, engine, base om, scheme(detuning, om), job ions, lanes,
        #  ticks, sweep points, sweep ticks)
        (3, ts.build_engine(t_cfg), t_cfg.om,
         lambda d, o: levels.three_state(d, o, t_cfg.vkick), 1000, 1024,
         ts.roll_block(t_cfg, (1000,)),
         [(d, o) for d in (-0.5, -1.0) for o in (0.5, 1.0)],
         ts.roll_block(t_cfg, (4, 1000))),
        (5, ft.build_scheduler(f_cfg).engine, f_cfg.om,
         levels.tag422, 3500, 3584, f_cfg.ratio,
         [(f_cfg.detuning, f_cfg.om), (-4.0, 0.8)], f_cfg.ratio),
        (7, mt.pump_engine(m_cfg), m_cfg.om,
         lambda d, o: levels.tag408(d, o, linear=False), 4096, 4096,
         m_cfg.ratio, [(m_cfg.detuning, m_cfg.om), (-3.0, 1.0)],
         m_cfg.ratio))
    out = {}
    for S, eng, om0, scheme, n, npad, ticks, points, sw_ticks in families:
        out[f"fused_ticks_s{S}"] = (free_ion_spec(eng, ticks), 1, n, npad,
                                    None, None)
        e0 = [scheme(d, o).e0 for d, o in points]
        om = [(o / om0, 0.0) for _, o in points]
        for form, pe0, pom in (("e0", True, False), ("om", False, True),
                               ("e0_om", True, True)):
            out[f"fused_ticks_s{S}_per_lane_{form}"] = (
                free_ion_spec(eng, sw_ticks, pe0, pom), len(points), n, npad,
                e0 if pe0 else None, om if pom else None)
    return out


def linear_pump_forms():
    """The 408-nm linear pump (``MCTagConfig(variant="408linear")``, its own
    compiled coupling pattern) at the 408quad pump's shapes in
    :func:`small_tick_forms`, in the four forms: phase 4b holds them to
    their twin and to the dense pattern's form, untimed."""
    from mdqtplasmasims_torch.core.scheduler import free_ion_spec
    from mdqtplasmasims_torch.experiments import mc_qt_tagging as mt
    from mdqtplasmasims_torch import levels
    cfg = mt.MCTagConfig(variant="408linear")
    eng = mt.pump_engine(cfg)
    points = [(cfg.detuning, cfg.om), (-3.0, 1.0)]
    e0 = [levels.tag408(d, o, linear=True).e0 for d, o in points]
    om = [(o / cfg.om, 0.0) for _, o in points]
    out = {"fused_ticks_s7_linear": (free_ion_spec(eng, cfg.ratio), 1,
                                     cfg.n, cfg.n, None, None)}
    for form, pe0, pom in (("e0", True, False), ("om", False, True),
                           ("e0_om", True, True)):
        out[f"fused_ticks_s7_linear_per_lane_{form}"] = (
            free_ion_spec(eng, cfg.ratio, pe0, pom), len(points), cfg.n,
            cfg.n, e0 if pe0 else None, om if pom else None)
    return out


def check_dense_form(torch, spec, res, args, tables, kw, what):
    """``spec``'s launch ``res`` (its compiled coupling pattern) against the
    dense pattern's form on the same inputs: bit for bit (a zero skipped
    in column order leaves a sum's value)."""
    from mdqtplasmasims_torch.core import qt_fused as tf
    dense = dataclasses.replace(spec, coupling_pattern="dense")
    if tf._kernel_plan(dense).pattern == tf._kernel_plan(spec).pattern:
        raise SystemExit(f"{what}: the spec already takes the dense pattern")
    full = tf.fused_md_substeps(dense, False, *args, tables=tables, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(res, full))
    log(f"{what}: its compiled pattern against the dense pattern's form: "
        f"bitwise equal {same}")
    if not same:
        raise SystemExit(f"{what}: the compiled pattern's form differs from "
                         "the dense form")


def check_small_tick_kernels(torch):
    """Phase 4b: every S = 3, 5, 7 form of the tick kernel against its twin
    at the shapes its family's main path launches it (:func:`small_tick_
    forms`; the 408 linear pump's forms too, :func:`linear_pump_forms`),
    from a start with the excited states populated; a pump form (no
    force) leaves V bit for bit; a per-lane form with its members at the
    base equals the plain form (:func:`check_base_members`); a pump's form
    equals the dense pattern's (:func:`check_dense_form`); then, for the
    main paths' forms, :func:`check_tick_shapes` (a mesh shard, 1 and 24
    ticks, an E=8 fold; each bitwise run to run and equal to its two-part
    launch); timed with its plain version; every form also on 32 ions
    (:func:`chain_probe`)."""
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(41)
    out = {}
    timed = small_tick_forms()
    for name, (spec, E, n, npad, e0, om) in {**timed,
                                             **linear_pump_forms()}.items():
        what = f"[ticks-small] {name}"
        tables = tf.fused_tables(spec, dev)
        lanes = E * npad
        on, (_, V, _, tp, pre, pim) = excited_planes(
            torch, g, spec.SP, E, npad, n, excited_rows(spec))
        V = V * 2.0                     # velocities across the Doppler shift
        zeros = torch.zeros((3, lanes), device=dev)
        e0p, omp = fold_sweep_lanes(spec, npad, e0, om, dev)
        rolls = torch.rand((spec.ratio * 5, lanes), generator=g, device=dev)
        args = (zeros, V, zeros, tp, pre, pim, rolls)
        kw = dict(e0_lanes=e0p, om_lanes=omp)
        res = tf.fused_md_substeps(spec, False, *args, tables=tables, **kw)
        ref = tf.fused_md_substeps_reference(spec, False, *args, tables, **kw)
        torch.cuda.synchronize()
        worst = compare_ticks(
            torch, spec, res, ref, on, allowed_lanes(E, spec.ratio),
            f"{what} ({n} ions in {npad} lanes x {E}, {spec.ratio} ticks, "
            f"apply_force {spec.apply_force})")
        if not spec.apply_force and not torch.equal(res[1], V):
            raise SystemExit(f"{what}: the pump form changed V")
        if spec.per_lane_e0 or spec.per_lane_om:
            check_base_members(torch, spec, E, npad, args, tables, what)
        if spec.S in (5, 7):
            check_dense_form(torch, spec, res, args, tables, kw, what)
        if name not in timed:
            continue
        worst = max(worst, check_tick_shapes(
            torch, spec, tables, g, what, folds=(1, 8) if E == 1 else (8,),
            sweep=(e0, om), free=True))
        ms, idle = kernel_ms(torch, lambda: tf.fused_md_substeps(
            spec, False, *args, tables=tables, **kw))
        reps = 3 if spec.ratio > 100 else 10
        plain = cuda_ms(torch, lambda: tf.fused_md_substeps_reference(
            spec, False, *args, tables, **kw), reps=reps)
        log(f"{what}: kernel {both(ms, idle)}, plain torch {plain:.4f} ms "
            f"per {spec.ratio}-tick launch over {lanes} lanes (median of "
            f"{N_TIMED}/{reps}); {resources(spec)}")
        out[name] = dict(max_abs_err=worst, ms=ms, idle_card_ms=idle,
                         plain_ms=plain, ticks=spec.ratio,
                         **tick_bound(spec, E * n, lanes))
        out[name].update(chain_probe(torch, spec, g, e0, om, ms, what))
    return out


def check_base_members(torch, spec, E, npad, args, tables, what):
    """A per-lane form whose ``E`` members all sit at the base (the
    scheme's own e0; om scale 1.0 with an empty DP pattern) computes what
    the plain form computes on the same lanes, bit for bit."""
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    dev = torch.device("cuda")
    plain = dataclasses.replace(spec, per_lane_e0=False, per_lane_om=False,
                                scheme_sp=None, scheme_dp=None)
    e0p, omp = fold_sweep_lanes(
        spec, npad, [spec.scheme.e0] * E if spec.per_lane_e0 else None,
        [(1.0, 0.0)] * E if spec.per_lane_om else None, dev)
    base = tf.fused_md_substeps(spec, False, *args, tables=tables,
                                e0_lanes=e0p, om_lanes=omp)
    ref = tf.fused_md_substeps(plain, False, *args,
                               tables=tf.fused_tables(plain, dev))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(base, ref))
    log(f"{what}: {E} members at the base against the plain form: bitwise "
        f"equal {same}")
    if not same:
        raise SystemExit(f"{what}: a member at the base differs from the "
                         "plain form")


def busy_sm_clock(torch, fn, calls: int = 1000):
    """The SM clock and its maximum (MHz) as nvidia-smi reads them while
    ``calls`` launches of ``fn`` keep the card busy."""
    for _ in range(calls):
        fn()
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    return tuple(float(x) for x in line.split(","))


def chain_probe(torch, spec, g, e0, om, ms, what):
    """A small scheme's form (S = 3, 5, 7) on 32 ions (one warp, in 128
    lanes; the first sweep member's tables) beside its main-path launch of
    ``ms``: equal times say that one warp's tick after tick sets the
    launch, not the card's width.  Both in cycles a tick at the SM clock
    nvidia-smi reads while the kernel runs."""
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.core.scheduler import fold_sweep_lanes
    dev = torch.device("cuda")
    npad, n = 128, 32
    on, (_, V, _, tp, pre, pim) = excited_planes(
        torch, g, spec.SP, 1, npad, n, excited_rows(spec))
    zeros = torch.zeros((3, npad), device=dev)
    e0p, omp = fold_sweep_lanes(spec, npad, None if e0 is None else e0[:1],
                                None if om is None else om[:1], dev)
    rolls = torch.rand((spec.ratio * 5, npad), generator=g, device=dev)
    tables = tf.fused_tables(spec, dev)
    args = (zeros, V * 2.0, zeros, tp, pre, pim, rolls)
    kw = dict(tables=tables, e0_lanes=e0p, om_lanes=omp)
    res = tf.fused_md_substeps(spec, False, *args, **kw)
    ref = tf.fused_md_substeps_reference(spec, False, *args, tables,
                                         e0_lanes=e0p, om_lanes=omp)
    torch.cuda.synchronize()
    err = compare_ticks(torch, spec, res, ref, on,
                        allowed_lanes(1, spec.ratio), f"{what} on {n} ions")
    ms32 = cuda_ms(torch, lambda: tf.fused_md_substeps(spec, False, *args,
                                                       **kw))
    mhz, max_mhz = busy_sm_clock(torch, lambda: tf.fused_md_substeps(
        spec, False, *args, **kw))
    cycles = lambda t: t * 1e-3 * mhz * 1e6 / spec.ratio
    log(f"{what}: {n} ions in {npad} lanes {ms32:.4f} ms against {ms:.4f} "
        f"ms on the main path's lanes; SM clock {mhz:g} MHz busy (max "
        f"{max_mhz:g}): {cycles(ms):.1f} / {cycles(ms32):.1f} cycles a tick")
    return dict(ms_32_ions=ms32, sm_clock_mhz=mhz, cycles_per_tick=cycles(ms),
                cycles_per_tick_32_ions=cycles(ms32), max_abs_err_32_ions=err)


def ion_sass_faults(sass: str) -> dict:
    """``{function: [fault, ...]}`` for each ion-kernel form
    (``fused_ticks_ion_kernel``, S = 3, 5, 7) in a ``cuobjdump -sass``
    dump: a shuffle
    or vote anywhere in it; in a tick loop (a backward branch whose body
    issues ``cp.async``, LDGSTS) a register load from device memory (LDG)
    outside a loop nested in it without copies (sincosf's table walk), or
    a wait that leaves no copy group in flight (``DEPBAR.LE`` below 1, or
    none); no tick loop at all."""
    fns, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "fused_ticks_ion_kernel" in m.group(1) \
                else None
            if name:
                fns[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?P\w+\s+)?(.*?)\s*;",
                     line)
        if m and name:
            fns[name].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, ins in fns.items():
        ops = [t.split()[0] for _, t in ins]
        at = {a: k for k, (a, _) in enumerate(ins)}
        loops = []                                  # (first, last) indices
        for k, (a, t) in enumerate(ins):
            m = re.match(r"BRA\s+(0x[0-9a-f]+)", t)
            if m and int(m.group(1), 16) < a and int(m.group(1), 16) in at:
                loops.append((at[int(m.group(1), 16)], k))
        copies = lambda lo, hi: any(o.startswith("LDGSTS")
                                    for o in ops[lo:hi + 1])
        ticks = [x for x in loops if copies(*x)]
        inner = [x for x in loops if not copies(*x)]
        faults = [f"{o} at {ins[k][0]:#x}" for k, o in enumerate(ops)
                  if o.split(".")[0] in ("SHFL", "VOTE")]
        if not ticks:
            faults.append("no tick loop with cp.async")
        for lo, hi in ticks:
            faults += [f"LDG in the tick loop at {ins[k][0]:#x}"
                       for k in range(lo, hi + 1)
                       if ops[k].split(".")[0] == "LDG"
                       and not any(a <= k <= b for a, b in inner)]
            waits = [int(m.group(1), 16) for _, t in ins[lo:hi + 1]
                     for m in [re.match(r"DEPBAR\.LE SB\d, (0x[0-9a-f]+)",
                                        t)] if m]
            if not waits or min(waits) < 1:
                faults.append(f"tick loop at {ins[lo][0]:#x}: waits "
                              f"{waits} leave no roll in flight")
        out[name] = faults
    return out


def _sass_tool():
    """``tools/tick_kernel_sass.py`` of this checkout, as a module."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import tick_kernel_sass
    return tick_kernel_sass


def ion_form_key(name: str) -> tuple:
    """``(S, pattern name, e0, om)`` of an ion-kernel function's name."""
    from mdqtplasmasims_torch.core import qt_fused as tf
    S, mask, e0, om = _sass_tool().ion_form(name)
    names = {(s, m): n for n, s, m in tf.ION_PATTERNS}
    return (S, names.get((S, mask), "" if mask is None else f"{mask:#x}"),
            e0, om)


def pattern_issue(sass: str) -> tuple:
    """``(counts, faults)``: the instructions a tick on the no-jump path
    (``tools/tick_kernel_sass.py``'s walk) of every S = 5 / 7 ion-kernel
    form in a dump, ``{"S=7 tag408_quad e0=0 om=0": n, ...}``, and a fault
    for each compiled pump pattern whose form issues no fewer a tick than
    the dense pattern's form of the same S and flags (the masked product
    must skip the coupling's zeros)."""
    tks = _sass_tool()
    counts = {}
    for name, ins in tks.functions(sass).items():
        if not tks.ion_form(name) or tks.ion_form(name)[0] not in (5, 7):
            continue
        path = tks.main_path(ins, tks.tick_loop(ins))
        ticks = max(1, round(sum("MUFU.RSQ" in t for t in path) / 4))
        counts[ion_form_key(name)] = len(path) / ticks
    faults = [f"S={S} {p} e0={e0} om={om}: {n:g} instructions a tick, the "
              f"dense form {counts.get((S, 'dense', e0, om))}"
              for (S, p, e0, om), n in sorted(counts.items())
              if p != "dense" and not n < counts.get((S, "dense", e0, om),
                                                     -1)]
    return ({f"S={S} {p} e0={e0} om={om}": n
             for (S, p, e0, om), n in sorted(counts.items())}, faults)


def check_ion_sass() -> None:
    """Phase 4c: the ion kernel's machine code (S = 3, 5, 7) in this run's
    library (``cuobjdump -sass``) through :func:`ion_sass_faults` and
    :func:`pattern_issue`; fails unless all 24 forms are there, none has a
    fault, and every pump pattern's form issues fewer instructions a tick
    than the dense form.  The chain's and the issue's floors are
    ``tools/tick_kernel_sass.py``'s, recorded in PERF.md."""
    from mdqtplasmasims_torch import _build
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass",
                           _build.library_path("fused_ticks")],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    faults = ion_sass_faults(sass)
    for name, f in sorted(faults.items(), key=lambda x: ion_form_key(x[0])):
        log("[ticks-sass] S={} {} e0={} om={}: ".format(*ion_form_key(name))
            + ("no shuffle/vote, no LDG in the tick loop, rolls in flight"
               if not f else "; ".join(f)))
    counts, issue = pattern_issue(sass)
    log("[ticks-sass] instructions a tick on the no-jump path: " + ", ".join(
        f"{k} {v:g}" for k, v in counts.items()))
    if len(faults) != 24 or any(faults.values()) or issue:
        raise SystemExit(f"phase 4c: {len(faults)} ion-kernel forms in the "
                         "library (want 24), or a shuffle, a vote or an "
                         "unprefetched roll on a tick loop, or a pattern "
                         f"that issues no less than dense: {issue}")


class PlainTicks:
    """Counts ``QTEngine.step_sm`` calls once :func:`count_plain_ticks` is
    installed (main() installs it): a tick of the plain engine.  On the
    card the three-state and tagging families run every tick in the tick
    kernel, so each phase's counts want 0 here."""
    launches = 0
    installed = False


def count_plain_ticks():
    from mdqtplasmasims_torch.core.qt import QTEngine
    if PlainTicks.installed:
        return
    plain = QTEngine.step_sm

    def counted(self, *a, **kw):
        PlainTicks.launches += 1
        return plain(self, *a, **kw)
    QTEngine.step_sm = counted
    PlainTicks.installed = True


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
    ms, idle = kernel_ms(torch, lambda: ty.yukawa_forces_n3l_soa_batched(
        Rp, masks, E, L, ldeb))
    plain = cuda_ms(torch, lambda: ty.yukawa_forces_n3l_soa_batched_reference(
        Rp, masks, E, L, ldeb), reps=10)
    log(f"[forces-E] kernel {both(ms, idle)}, plain torch {plain:.4f} ms for "
        f"E={E} (median of {N_TIMED}/10)")
    # kernel C as the ring schedule of phase 17 launches it: one member's
    # shard of 875 ions in 1792 lanes
    shard = torch.zeros((1, MESH_NPAD), device=dev)
    shard[0, :3500 // MESH_I] = 1.0
    Rs = torch.rand((3, MESH_NPAD), generator=g, device=dev) * L * shard
    ms_ring = cuda_ms(torch, lambda: ty.yukawa_forces_n3l_soa_batched(
        Rs, shard, MESH_E_LOC, L, ldeb))
    log(f"[forces-E] kernel {ms_ring:.4f} ms at the ring run's shape "
        f"(E_loc={MESH_E_LOC}, {int(shard.sum())} ions in {MESH_NPAD} lanes; "
        f"median of {N_TIMED})")
    return dict(max_abs_err=worst, ms=ms, idle_card_ms=idle, plain_ms=plain,
                **bound(half_pairs(n_js) * PAIR_OPS, 4 * 7 * E * npad))


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
        worst = max(worst, check_tick_shapes(
            torch, spec, sched.tables, g, f"[ticks-lane] {key}", folds=(8,),
            sweep=(sweep_e0 if pe0 else None, oms if pom else None)))
        c = excited
        rolls = torch.rand((spec.ratio * 5, E * npad), generator=g, device=dev)
        args = (c.R, c.V, F, c.tp, c.psi_re, c.psi_im, rolls)
        ms, idle = kernel_ms(torch, lambda: tf.fused_md_substeps(
            spec, False, *args, tick0=1000, tables=sched.tables, e0_lanes=e0p,
            om_lanes=omp))
        plain = cuda_ms(torch, lambda: tf.fused_md_substeps_reference(
            spec, False, *args, sched.tables, tick0=1000, e0_lanes=e0p,
            om_lanes=omp), reps=10)
        log(f"[ticks-lane] {key}: kernel {both(ms, idle)}, plain torch "
            f"{plain:.4f} ms per {spec.ratio}-tick MD step of the E={E} fold "
            f"(median of {N_TIMED}/10); {resources(spec)}")
        out[key] = dict(max_abs_err=worst, ms=ms, idle_card_ms=idle,
                        plain_ms=plain,
                        **tick_bound(spec, E * n, E * npad))
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
            ty.yukawa_forces_potential_pallas_batched, "launches"),
        yukawa_forces_cols=(ty.yukawa_forces_soa_cols_batched, "launches"),
        yukawa_forces_cross=(ty.yukawa_forces_cross_n3l_soa_batched,
                             "launches"))
    for attr in LAUNCH_COUNTERS:     # launches[_rng][_s<S>][_per_lane_..]
        out["fused_ticks" + attr[len("launches"):]] = (fused_md_substeps,
                                                        attr)
    if PlainTicks.installed:
        out["plain_engine_ticks"] = (PlainTicks, "launches")
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
    from mdqtplasmasims_torch.io import checkpoint as ckpt
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


def check_interval_files(job, cfg, outs, L):
    """The interval diagnostics' files of a finished run in ``job``: per
    VAF interval the rows, the time axis, VAF(0) = <|v0|^2> of the sampled
    origin and the terminal VZERO snapshot; ``J_interval0.dat``'s rows and
    step counter, and the first and last samples' J(k), taken on the card,
    against a float64 direct sum over the sampled R and V on the host.
    Returns ``([(rows, ok) per interval], J shape, J error, J ok)``."""
    import numpy as np
    from mdqtplasmasims_torch.io.datfiles import read_rows
    n_md = int(round(cfg.tmax / cfg.timestep))
    t = np.asarray(outs["t"], np.float64)
    got = []
    for k, ts in enumerate(cfg.vaf_intervals):
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
    return got, J.shape, j_err, j_ok and j_err <= LCCF_TOL


def interval_path(torch, card, L):
    """A flagship-width run with the interval diagnostics (``L`` is the
    box length of its 3500 ions)."""
    import numpy as np
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
        job = next(d for d, _, fs in os.walk(tmp) if "energies.dat" in fs)
        got, j_shape, j_err, j_ok = check_interval_files(job, cfg,
                                                         res["outs"], L)
        with np.load(os.path.join(job, f"checkpoint_{n_md - 1:06d}.npz")) as z:
            vh = z["vholder"]
        vh_ok = vh.shape == (13, cfg.n0, 3) and not vh[2:].any()
    log(f"[intervals] run(n0=3500, tmax=1.0, vaf_intervals={iv}, "
        f"record_lccf=True) in {wall:.3f} s ({card}): VAF rows and checks "
        f"{got}; J_interval0.dat {j_shape}, max err vs float64 direct sum "
        f"{j_err:.3g} of max|J| (tol {LCCF_TOL:g}), ok {j_ok}; checkpoint "
        f"vholder "
        f"{vh.shape} ok {vh_ok}")
    if not (all(ok for _, ok in got) and j_ok and vh_ok):
        raise SystemExit("the interval diagnostics' files are wrong")


def _shard_blocks(torch, g, L, E, I, npad, seed=None):
    """``I`` ion shards of ``npad`` lanes for ``E`` members of N0=3500 (a
    mesh slot's shapes): positions ``[E, I*npad, 3]`` (0 on padded lanes)
    and masks ``[E, I*npad]``, each member's ions split into I contiguous
    shards of the padded count, as a mesh splits them.  ``seed=None``
    gives every member 3500 ions (the mesh run's fixed-N members: 3500/I
    real lanes per shard), a seed Poissonian members."""
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    dev = torch.device("cuda")
    if seed is None:
        m, n_js = torch.ones((E, 3500)), [3500] * E
    else:
        m, n_js = poisson_member_mask(3500, E, seed, round_to=I)
    n_loc = m.shape[1] // I
    cm = torch.zeros((E, I, npad), device=dev)
    cm[:, :, :n_loc] = torch.as_tensor(m, device=dev).reshape(E, I, n_loc)
    cm = cm.reshape(E, I * npad)
    R = torch.rand((E, I * npad, 3), generator=g, device=dev) * L
    return R * cm[..., None], cm, n_js


def _lanes(R):
    """``[E, npad, 3]`` -> the folded lane layout ``[3, E*npad]``."""
    return R.permute(2, 0, 1).reshape(3, -1).contiguous()


# the mesh run of phase 17: 2 members over 2 ens slots (E_loc = 1 member
# per slot) and 4 ion shards of 875 real ions in 1792 lanes each
MESH_K, MESH_I, MESH_E_LOC, MESH_NPAD = 2, 4, 1, 1792


def _cols_check(torch, L, ldeb, E, cols, cmask, what, row_mask=None):
    """Kernel E on shard 0's rows against ``cols``, with ``row_mask`` as
    the gather schedule launches it or without: its plain version, run to
    run, and the rows the mask clears exactly 0.  Returns (max abs err,
    rows)."""
    from mdqtplasmasims_torch.ops import yukawa as ty
    rows = _lanes(cols[:, :MESH_NPAD])
    F = ty.yukawa_forces_soa_cols_batched(rows, cols, cmask, E, L, ldeb,
                                          row_mask=row_mask)
    F2 = ty.yukawa_forces_soa_cols_batched(rows, cols, cmask, E, L, ldeb,
                                           row_mask=row_mask)
    ref = ty.yukawa_forces_soa_cols_batched_reference(
        rows, cols, cmask, E, L, ldeb, row_mask=row_mask)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((F - ref).abs().max())
    if row_mask is not None:
        dead = row_mask.expand(E, MESH_NPAD).reshape(-1) == 0
        what += (f" with the row mask ({int(dead.sum())} cleared rows, max "
                 f"|F| there {float(F[:, dead].abs().max()):g})")
        if float(F[:, dead].abs().max()) != 0.0:
            raise SystemExit("kernel E: masked rows are not exactly zero")
    log(f"[cols] E {what}: rows [3,{E}x{MESH_NPAD}] x cols "
        f"{list(cols.shape)}, real columns "
        f"{[int(x) for x in cmask.sum(-1).reshape(-1).tolist()]}: max|F| "
        f"{scale:.6g} max abs err {err:.3g} (rel {err / scale:.3g}, tol "
        f"{FORCE_TOL:g}); bitwise equal run to run {torch.equal(F, F2)}")
    if not err <= FORCE_TOL * scale:
        raise SystemExit(f"kernel E ({what}) disagrees with its plain "
                         "version")
    if not torch.equal(F, F2):
        raise SystemExit("kernel E is not deterministic run to run")
    return err, rows


def check_cols_kernel(torch, L, ldeb):
    """Phase 15: kernel E against its plain version at the shapes the mesh
    run of phase 17 gives it (one member per slot, rows 1792 lanes of 875
    ions against the 4 x 1792 gathered columns, the column mask in the
    per-member form the gather schedule passes and the shard's row mask
    handed to the kernel as ``_gather_forces`` does), run to run, masked
    rows exactly 0, and timed in that form; the same without the row mask;
    then 2 Poissonian members per slot against the plain version, masked
    and not, and a member's own lanes as columns against kernel C."""
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    from mdqtplasmasims_torch.ops import yukawa as ty
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(51)
    E, I, npad = MESH_E_LOC, MESH_I, MESH_NPAD
    cols, cmask, _ = _shard_blocks(torch, g, L, E, I, npad)
    # the shard's mask row as the mesh stepper holds it: [1, npad], shared
    # by the slot's members
    rmask = cmask[:1, :npad].contiguous()
    err, rows = _cols_check(torch, L, ldeb, E, cols, cmask,
                            "at the mesh run's shapes", rmask)
    _cols_check(torch, L, ldeb, E, cols, cmask, "at the mesh run's shapes")
    # two Poissonian members per slot: per-member masks
    cols2, cmask2, _ = _shard_blocks(torch, g, L, 2, I, npad, seed=8)
    _cols_check(torch, L, ldeb, 2, cols2, cmask2, "2 Poissonian members",
                cmask2[:, :npad].contiguous())
    _cols_check(torch, L, ldeb, 2, cols2, cmask2, "2 Poissonian members")
    # a member's own lanes as its columns: kernel C's forces bit for bit
    m, n2 = poisson_member_mask(3500, 2, 9)
    npad2 = -(-max(3584, m.shape[1]) // 128) * 128
    masks = torch.zeros((2, npad2), device=dev)
    masks[:, :m.shape[1]] = torch.as_tensor(m, device=dev)
    own = torch.rand((2, npad2, 3), generator=g, device=dev) * L
    own = own * masks[..., None]
    Fc = ty.yukawa_forces_n3l_soa_batched(_lanes(own), masks, 2, L, ldeb)
    Fe = ty.yukawa_forces_soa_cols_batched(_lanes(own), own, masks, 2, L,
                                           ldeb)
    torch.cuda.synchronize()
    real = masks.reshape(-1) > 0
    same = torch.equal(Fc[:, real], Fe[:, real])
    log(f"[cols] E with the member's own {npad2} lanes as columns vs kernel "
        f"C on real rows: bitwise equal {same} (max abs diff "
        f"{float((Fc[:, real] - Fe[:, real]).abs().max()):.3g})")
    if not same:
        raise SystemExit("kernel E on a member's own lanes differs from C")
    ms, idle = kernel_ms(torch, lambda: ty.yukawa_forces_soa_cols_batched(
        rows, cols, cmask, E, L, ldeb, row_mask=rmask))
    plain = cuda_ms(torch, lambda: ty.yukawa_forces_soa_cols_batched_reference(
        rows, cols, cmask, E, L, ldeb, row_mask=rmask), reps=10)
    bare = cuda_ms(torch, lambda: ty.yukawa_forces_soa_cols_batched(
        rows, cols, cmask, E, L, ldeb))
    log(f"[cols] E kernel {both(ms, idle)}, plain torch {plain:.4f} ms at the "
        f"mesh run's shapes with the row mask, as the gather schedule "
        f"launches it (median of {N_TIMED}/10); without the row mask "
        f"{bare:.4f} ms")
    pairs = sum(float(cmask[j, :npad].sum()) * float(cmask[j].sum())
                for j in range(E))
    nbytes = 4 * (3 * E * npad + 4 * E * I * npad + 3 * E * npad)
    return dict(max_abs_err=err, ms=ms, idle_card_ms=idle, plain_ms=plain,
                **bound(pairs * PAIR_OPS, nbytes))


def _cross_check(torch, L, ldeb, E, A, ma, B, mb, what):
    """Kernel F on blocks A x B against its plain version, against both
    halves of kernel E, and bitwise run to run.  Returns max abs err."""
    from mdqtplasmasims_torch.ops import yukawa as ty
    npad = A.shape[1]
    rows = _lanes(A)
    F, G = ty.yukawa_forces_cross_n3l_soa_batched(rows, ma, B, mb, E, L,
                                                  ldeb)
    F2, G2 = ty.yukawa_forces_cross_n3l_soa_batched(rows, ma, B, mb, E, L,
                                                    ldeb)
    Fr, Gr = ty.yukawa_forces_cross_n3l_soa_batched_reference(
        rows, ma, B, mb, E, L, ldeb)
    FE = ty.yukawa_forces_soa_cols_batched(rows, B, mb, E, L, ldeb)
    GE = ty.yukawa_forces_soa_cols_batched(_lanes(B), A, ma.expand(E, npad)
                                           .contiguous(), E, L, ldeb)
    torch.cuda.synchronize()
    FE = FE * ma.expand(E, npad).reshape(1, -1)
    GE = GE.reshape(3, E, npad).permute(1, 2, 0) * mb[..., None]
    scale = max(float(Fr.abs().max()), float(Gr.abs().max()))
    errs = dict(F=float((F - Fr).abs().max()), G=float((G - Gr).abs().max()),
                F_vs_E=float((F - FE).abs().max()),
                G_vs_E=float((G - GE).abs().max()))
    same = torch.equal(F, F2) and torch.equal(G, G2)
    log(f"[cross] F {what}: blocks [{E}x{npad}] x [{E}x{npad}], real "
        f"{[int(x) for x in ma.expand(E, npad).sum(1).tolist()]} x "
        f"{[int(x) for x in mb.sum(1).tolist()]}: max|F,G| {scale:.6g}, max "
        f"abs errs {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} (tol "
        f"{FORCE_TOL:g} of max); F and G bitwise equal run to run: {same}")
    if max(errs.values()) > FORCE_TOL * scale:
        raise SystemExit(f"kernel F ({what}) disagrees with its plain "
                         "version or E")
    if not same:
        raise SystemExit("kernel F is not deterministic run to run")
    return max(errs["F"], errs["G"])


def check_cross_kernel(torch, L, ldeb):
    """Phase 16: kernel F against its plain version at the shapes the ring
    schedule of phase 17 gives it (one member per slot: two of the 4 ion
    shards, 875 ions in 1792 lanes each, a ``[1, npad]`` row mask and the
    column mask the ring carries), against both halves of kernel E, and
    bitwise run to run; timed; then 2 Poissonian members per block."""
    from mdqtplasmasims_torch.ops import yukawa as ty
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(61)
    E, I, npad = MESH_E_LOC, MESH_I, MESH_NPAD
    R, cm, _ = _shard_blocks(torch, g, L, E, I, npad)
    A, B = R[:, :npad].contiguous(), R[:, 2 * npad:3 * npad].contiguous()
    ma, mb = cm[:1, :npad].contiguous(), cm[:, 2 * npad:3 * npad].contiguous()
    err = _cross_check(torch, L, ldeb, E, A, ma, B, mb,
                       "at the mesh run's shapes")
    R2, cm2, _ = _shard_blocks(torch, g, L, 2, 2, npad, seed=10)
    _cross_check(torch, L, ldeb, 2, R2[:, :npad].contiguous(),
                 cm2[:, :npad].contiguous(), R2[:, npad:].contiguous(),
                 cm2[:, npad:].contiguous(), "2 Poissonian members")
    rows = _lanes(A)
    ms, idle = kernel_ms(torch, lambda: ty.yukawa_forces_cross_n3l_soa_batched(
        rows, ma, B, mb, E, L, ldeb))
    plain = cuda_ms(torch, lambda: (
        ty.yukawa_forces_cross_n3l_soa_batched_reference(
            rows, ma, B, mb, E, L, ldeb)), reps=10)
    log(f"[cross] F kernel {both(ms, idle)}, plain torch {plain:.4f} ms at "
        f"the mesh run's shapes (median of {N_TIMED}/10)")
    pairs = float(ma.sum()) * float(mb.sum())
    nbytes = 4 * (3 * E * npad + npad + 4 * E * npad + 3 * E * npad
                  + 3 * E * npad)
    return dict(max_abs_err=err, ms=ms, idle_card_ms=idle, plain_ms=plain,
                **bound(pairs * (PAIR_OPS + REACTION_OPS), nbytes))


def mesh_path(torch, card, L, ldeb):
    """Phase 17: ``run_ensemble`` over a 2 x 4 mesh of slots on the card
    (the shard shapes of a 2-member, 4-way ion-sharded layout), gather and
    ring-N3L, then an ens-only mesh against the unsharded fold."""
    import numpy as np
    from mdqtplasmasims_torch.bridge import states_from_numpy
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, build_scheduler, run_ensemble)
    from mdqtplasmasims_torch.ops import yukawa as ty
    from mdqtplasmasims_torch.parallel.ensemble import (
        make_sharded_fused_step)
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", 0)
    K, I = MESH_K, MESH_I
    mesh = make_mesh(K, I, devices=[dev] * (K * I))
    E, n_md, slots = K * MESH_E_LOC, 500, K * I
    counts = {}
    for ion_forces, want in (
            ("gather", dict(yukawa_forces_cols=n_md * slots,
                            yukawa_forces_cross=0, yukawa_forces_batched=0)),
            # F once per pair of a member row's ion blocks per MD step
            ("ring_n3l", dict(yukawa_forces_cols=0,
                              yukawa_forces_cross=n_md * K * I * (I - 1) // 2,
                              yukawa_forces_batched=n_md * slots))):
        want.update(fused_ticks_rng=512 * slots, yukawa_forces=0,
                    yukawa_forces_potential_batched=13, fused_ticks=0)
        with tempfile.TemporaryDirectory() as tmp:
            cfg = CoolingConfig(n0=3500, tmax=1.0,
                                checkpoint_every_segments=6,
                                save_directory=os.path.join(tmp, "a"))
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, outs = run_ensemble(cfg, E, seed=5, mesh=mesh,
                                       ion_forces=ion_forces)
            wall = time.perf_counter() - t0
            c = read_counts()
            log(f"[mesh] run_ensemble(n0=3500, tmax=1.0, n_jobs=2, "
                f"mesh=2x4 on {dev}, ion_forces={ion_forces!r}): {n_md} MD "
                f"steps in {wall:.3f} s -> "
                f"{E * cfg.n0 * n_md * cfg.ratio / wall:.4g} aggregate "
                f"ion-QT-updates/s ({card})")
            log(f"[mesh] launches: {c}")
            if any(c[k] != v for k, v in want.items()):
                raise SystemExit(f"mesh path launched {c}, want {want}")
            dirs = sorted(os.path.dirname(p) for p in glob_all(
                os.path.join(tmp, "a"), "energies.dat"))
            check_members(f"mesh-{ion_forces}", final, outs, [cfg.n0] * E,
                          dirs, n_md)
            # start-of-step forces of a mesh step against kernel C on the
            # unsharded fold
            states = states_from_numpy(final, device=dev)
            sched = build_scheduler(cfg, dev)
            sched.seed = torch.tensor([1], dtype=torch.int32, device=dev)
            out = make_sharded_fused_step(sched, ldeb, mesh, n_steps=1,
                                          ion_forces=ion_forces)(states)
            npad = sched._npad(cfg.n0)
            Rp = torch.zeros((3, E, npad), device=dev)
            Rp[:, :, :cfg.n0] = states.R.permute(2, 0, 1)
            mrow = torch.zeros((1, npad), device=dev)
            mrow[0, :cfg.n0] = 1.0
            Fc = ty.yukawa_forces_n3l_soa_batched(Rp.reshape(3, -1), mrow, E,
                                                  L, ldeb)
            Fc = Fc.reshape(3, E, npad)[:, :, :cfg.n0].permute(1, 2, 0)
            scale = float(Fc.abs().max())
            ferr = float((out.F - Fc).abs().max())
            # a window to tmax=0.5 resumed on the mesh to 1.0
            cfg_b = dataclasses.replace(
                cfg, tmax=0.5, save_directory=os.path.join(tmp, "b"))
            run_ensemble(cfg_b, E, seed=5, mesh=mesh, ion_forces=ion_forces)
            fin_b, _ = run_ensemble(dataclasses.replace(cfg_b, tmax=1.0), E,
                                    seed=5, resume=True, mesh=mesh,
                                    ion_forces=ion_forces)
            same = all(np.array_equal(getattr(final, k), getattr(fin_b, k))
                       for k in ("R", "V", "psi", "t_part"))
        log(f"[mesh] {ion_forces}: start-of-step forces vs kernel C on the "
            f"unsharded fold: max abs err {ferr:.3g} of max|F| {scale:.6g} "
            f"(tol {FORCE_TOL:g}); tmax 0.5 resumed on the mesh to 1.0 vs "
            f"the uninterrupted run: bitwise equal {same}")
        if not ferr <= FORCE_TOL * scale:
            raise SystemExit(f"mesh forces ({ion_forces}) disagree with C")
        if not same:
            raise SystemExit(f"mesh resume ({ion_forces}) differs from the "
                             "uninterrupted run")
        counts[ion_forces] = c
    cfg = CoolingConfig(n0=3500, tmax=0.5)
    f0, o0 = run_ensemble(cfg, E, seed=6, device="cuda")
    f1, o1 = run_ensemble(cfg, E, seed=6,
                          mesh=make_mesh(2, 1, devices=[dev] * 2))
    same = (all(np.array_equal(getattr(f0, k), getattr(f1, k))
                for k in ("R", "V", "psi", "t_part"))
            and all(np.array_equal(o0[k], o1[k]) for k in o0))
    log(f"[mesh] ens-only 2x1 mesh vs the unsharded 2-member fold (n0=3500, "
        f"tmax=0.5, seed 6): final states and samples bitwise equal {same}")
    if not same:
        raise SystemExit("the ens-only mesh differs from the unsharded fold")
    return counts


# ---- the frozen-start tagging and three-state families (phases 18-22)

TAG_CUT = dict(tstart=0.3, tmax=1.0)     # 500 MD steps, the pump inside


def want_counts(counts: dict, what: str, **nonzero) -> None:
    """Fail unless exactly the counters ``nonzero`` moved, by the numbers
    given (every other kernel form stayed at 0)."""
    want = {k: nonzero.get(k, 0) for k in counts}
    if counts != want:
        raise SystemExit(f"{what} launched {counts}, want {want}")


def check_fold_force_entry(torch, L, ldeb):
    """Phase 18: kernel C through ``yukawa_forces_n3l_pallas_batched``
    with a holed ``[E, N]`` mask against its plain version, and the
    entries the tagging family calls, timed at its shapes."""
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    from mdqtplasmasims_torch.ops import yukawa as ty
    dev = torch.device("cuda")
    E = 8
    m, n_js = poisson_member_mask(3500, E, seed=0)
    g = torch.Generator(device=dev).manual_seed(23)
    mask = torch.as_tensor(m, device=dev).clone()
    holes = torch.rand(mask.shape, generator=g, device=dev) < 0.02
    mask[holes] = 0.0                      # holes inside, not only a tail
    n = mask.shape[1]
    R = torch.rand((E, n, 3), generator=g, device=dev) * L * mask[..., None]
    F = ty.yukawa_forces_n3l_pallas_batched(R, L, ldeb, mask=mask)
    F2 = ty.yukawa_forces_n3l_pallas_batched(R, L, ldeb, mask=mask)
    Rp, rows, npad = ty._pack_lanes(R, mask, 512)
    ref = ty.yukawa_forces_n3l_soa_batched_reference(Rp, rows, E, L, ldeb)
    ref = ref.reshape(3, E, npad)[:, :, :n].permute(1, 2, 0)
    torch.cuda.synchronize()
    scale, err = float(ref.abs().max()), float((F - ref).abs().max())
    dead = float(F[mask == 0].abs().max())
    log(f"[fold-entry] yukawa_forces_n3l_pallas_batched, R [{E}, {n}, 3], "
        f"holed [E, N] mask ({int(holes.sum())} holes, counts "
        f"{[int(x) for x in mask.sum(1)]}): max|F|={scale:.6g} max abs err="
        f"{err:.3g} (tol {FORCE_TOL:g} of max|F|); max |F| on masked ions "
        f"{dead:g}")
    if not err <= FORCE_TOL * scale:
        raise SystemExit("the [E, N, 3] force entry disagrees with its "
                         "plain version under a per-member mask")
    if not torch.equal(F, F2) or dead != 0.0:
        raise SystemExit("the [E, N, 3] force entry: not deterministic, or "
                         "masked ions not exactly 0")
    R1 = torch.rand((3500, 3), generator=g, device=dev) * L
    times = dict(
        A=cuda_ms(torch, lambda: ty.yukawa_forces_n3l_pallas(R1, L, ldeb)),
        C=cuda_ms(torch, lambda: ty.yukawa_forces_n3l_pallas_batched(
            R, L, ldeb, mask=mask)),
        D=cuda_ms(torch, lambda: ty.yukawa_potential_pallas(R1, L, ldeb)),
        G=cuda_ms(torch, lambda: ty.yukawa_potential_pallas_batched(
            R, L, ldeb, mask)))
    log("[fold-entry] device ms per call of the entries the tagging family "
        "uses (pack, kernel, unpack; median of "
        f"{N_TIMED}): A [3500, 3] {times['A']:.4f}, C [{E}, {n}, 3] "
        f"{times['C']:.4f}, D {times['D']:.4f}, G {times['G']:.4f}")
    return times


def _tag_tree(job_dir, ac_name, n_rows, ac_rows, labels, c0_tag, c0_end):
    """Check the files and labels ``write_outputs`` promises."""
    def rows(name):
        with open(os.path.join(job_dir, name)) as f:
            return [r for r in f.read().splitlines() if r.strip()]
    got = dict(energies=len(rows("energies.dat")),
               moments=len(rows("taggedMoments.dat")), ac=len(rows(ac_name)))
    names = set(os.listdir(job_dir))
    have = sorted(int(f[len("vel_distX_timestep"):-4]) for f in names
                  if f.startswith("vel_distX_timestep"))
    want = {f"spinUpIons_timestep{c0_tag:06d}.dat",
            f"checkpoint_{c0_end:06d}.npz",
            f"ions_timestep{c0_end:06d}.dat",
            f"conditions_timestep{c0_end:06d}.dat",
            f"spinUpIonsList_timestep{c0_end:06d}.dat"}
    if (got != dict(energies=n_rows, moments=n_rows, ac=ac_rows)
            or have != labels or not want <= names):
        raise SystemExit(f"{job_dir}: rows {got} (want {n_rows}/{ac_rows}), "
                         f"vel_distX labels {have} (want {labels}), missing "
                         f"{sorted(want - names)}")


def frozen_tag_path(torch, card):
    """Phase 19: one frozen-start tagging job at full width, then its
    resume."""
    import numpy as np
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ft.FrozenTagConfig(save_directory=tmp, **TAG_CUT)
        n_md_a, n_md, segs, tail = ft._phase_b_plan(cfg)
        blocks = len(segs)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, res = ft.run(cfg, device="cuda")      # ends in a host fetch
        wall = time.perf_counter() - t0
        counts = read_counts()
        pump_steps, pump_ticks = frozen_pump_steps(torch, cfg)
        log(f"[frozen-tag] run(FrozenTagConfig(tstart=0.3, tmax=1.0), "
            f"device='cuda'): 422linear, N0={cfg.n0}, {n_md} MD steps "
            f"({n_md_a} to the tag; {pump_ticks} pump ticks in {pump_steps} "
            f"launches of the tick kernel), {blocks} output blocks in "
            f"{wall:.3f} s -> {n_md / wall:.1f} MD steps/s ({card})")
        log(f"[frozen-tag] launches: {counts}")
        want_counts(counts, "the frozen-tag run", yukawa_forces=n_md + 1,
                    yukawa_forces_potential=blocks + 2,
                    fused_ticks_s5=pump_steps)
        e = res["outs"]["energies"]
        frac = float(res["spin_up"].mean())
        audit = float(np.abs(e[:, 4]).max())
        ek = e[:, :3].sum(-1)
        log(f"[frozen-tag] tag fraction {frac:.4f}, n_up "
            f"{int(res['out_tag']['n_up'])}; Ekin {ek[0]:.4g} .. {ek[-1]:.4g}, "
            f"Epot {e[0, 3]:.6g} .. {e[-1, 3]:.6g}, max |Ekin+Epot-Epot0| "
            f"{audit:.3g}; t = {res['out_tag']['t']:.6g} (tag), "
            f"{res['outs']['t'][0]:.6g} .. {res['outs']['t'][-1]:.6g}")
        arrays = [final.R, final.V, final.psi, *res["outs"].values()]
        if not all(np_isfinite(a) for a in arrays):
            raise SystemExit("frozen-tag: non-finite outputs")
        if not 0.0 < frac < 1.0:
            raise SystemExit("frozen-tag: tag fraction outside (0, 1)")
        if not (ek[-1] > ek[0] > 0.0 and audit < 0.1 * ek[-1]):
            raise SystemExit("frozen-tag: no DIH, or the energy audit column "
                             "is not small against the kinetic energy")
        if not (np.abs(final.psi) ** 2)[:, 2:].sum() > 0:
            raise SystemExit("frozen-tag: the pump moved no population")
        f = cfg.sample_freq
        l0 = n_md_a + (f - n_md_a % f) - 1
        labels = [l0 + k * f for k in range(blocks)]
        _tag_tree(cfg.job_dir(), "VAF.dat", blocks, blocks + 1, labels,
                  n_md_a - 1, n_md - 1)
        # resume to a longer tmax: rows append on the same grid
        cfg2 = dataclasses.replace(cfg, tmax=1.2)
        reset_counts()
        final2, res2 = ft.run(cfg2, resume=True, device="cuda")
        counts2 = read_counts()
        n_md2 = int(round(cfg2.tmax / cfg2.timestep))
        more = res2["labels"]
        want_counts(counts2, "the frozen-tag resume",
                    yukawa_forces=n_md2 - n_md,
                    yukawa_forces_potential=len(more))
        _tag_tree(cfg.job_dir(), "VAF.dat", blocks + len(more),
                  blocks + 1 + len(more), labels + more, n_md_a - 1,
                  n_md2 - 1)
        t = np.loadtxt(os.path.join(cfg.job_dir(), "energies.dat"))[:, 0]
        step = np.diff(t)
        log(f"[frozen-tag] resume to tmax=1.2: {len(more)} more blocks at MD "
            f"steps {more}, launches {counts2['yukawa_forces']} A / "
            f"{counts2['yukawa_forces_potential']} D; energies.dat t "
            f"{t[0]:.6g} .. {t[-1]:.6g}, spacing {step.min():.6g} .. "
            f"{step.max():.6g}")
        if len(more) != 3 or not np.allclose(step, f * cfg.timestep,
                                             rtol=1e-4):
            raise SystemExit("frozen-tag resume: rows left the sample grid")
        if not np.array_equal(res2["spin_up"], res["spin_up"]):
            raise SystemExit("frozen-tag resume lost the spin-up list")
    return counts, dict(wall=wall, n_md=n_md, steps_per_s=n_md / wall,
                        pump_steps=pump_steps)


def frozen_pump_steps(torch, cfg):
    """``(MD steps, ticks)`` of a frozen-tag job's pump window: each MD
    step with a tick in the window is one launch of the tick kernel
    (FrozenTagScheduler.window)."""
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    sched = ft.build_scheduler(cfg)
    wins = [sched.window(k * cfg.ratio, torch.float32)
            for k in range(ft._phase_b_plan(cfg)[0])]
    return sum(k1 > k0 for k0, k1 in wins), sum(k1 - k0 for k0, k1 in wins)


class raw_fold:
    """Keeps the device state a fold ends with (``frozen_tagging._phases``'s
    result, padded lanes included: the results are cut to each member's
    N)."""

    def __enter__(self):
        from mdqtplasmasims_torch.experiments import frozen_tagging as ft
        self.ft, self.orig, self.kept = ft, ft._phases, []

        def keeping(*a, **kw):
            out = self.orig(*a, **kw)
            self.kept.append(out)
            return out
        ft._phases = keeping
        return self.kept

    def __exit__(self, *exc):
        self.ft._phases = self.orig


def frozen_fold_path(torch, card):
    """Phase 20: the Poissonian fold of 8 and the 2-point sweep."""
    import numpy as np
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    from mdqtplasmasims_torch.io import checkpoint as ckpt
    E = 8
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ft.FrozenTagConfig(exact_n=False, save_directory=tmp, **TAG_CUT)
        n_md_a, n_md, segs, _ = ft._phase_b_plan(cfg)
        mask, n_js = poisson_member_mask(cfg.n0, E, 0)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with raw_fold() as kept:
            results = ft.run_ensemble(cfg, E, device="cuda")
        wall = time.perf_counter() - t0
        counts = read_counts()
        log(f"[frozen-fold] run_ensemble(FrozenTagConfig(tstart=0.3, "
            f"tmax=1.0, exact_n=False), n_jobs={E}), N={n_js} in "
            f"{mask.shape[1]} lanes: {n_md} MD steps, {len(segs)} blocks in "
            f"{wall:.3f} s -> {n_md / wall:.1f} fold MD steps/s, "
            f"{E * n_md / wall:.1f} member MD steps/s ({card})")
        log(f"[frozen-fold] launches: {counts}")
        pump_steps, _ = frozen_pump_steps(torch, cfg)
        want_counts(counts, "the frozen-tag fold",
                    yukawa_forces_batched=n_md + 1,
                    yukawa_forces_potential_batched=len(segs) + 2,
                    fused_ticks_s5=pump_steps)
        state, spin_up, _, _, _, vholder = kept[0]
        pad = torch.as_tensor(mask == 0, device=state.R.device)
        worst = max(float(x[pad].abs().max()) for x in
                    (state.R, state.V, state.F, state.psi, vholder))
        ups = int(spin_up[pad].sum())
        log(f"[frozen-fold] padded lanes at the end: max |R|,|V|,|F|,|psi|,"
            f"|vholder| = {worst:g}, tagged {ups}")
        if worst != 0.0 or ups:
            raise SystemExit("frozen-tag fold: padded lanes did not stay "
                             "inert")
        dirs = sorted(os.path.dirname(q) for q in glob_all(tmp,
                                                           "energies.dat"))
        if len(dirs) != E:
            raise SystemExit(f"frozen-tag fold wrote {len(dirs)} job trees")
        for j, (r, d) in enumerate(zip(results, dirs)):
            e = r["outs"]["energies"]
            ek = e[:, :3].sum(-1)
            frac = float(r["spin_up"].mean())
            n_file, rows = ckpt.read_ions(d, n_md - 1)
            log(f"[frozen-fold] member {j}: N={r['n_ions']}, tag fraction "
                f"{frac:.4f}, Ekin {ek[0]:.4g} .. {ek[-1]:.4g}, max |audit| "
                f"{float(np.abs(e[:, 4]).max()):.3g}, ions_ N {n_file}, "
                f"{rows} rows")
            ok = (r["n_ions"] == n_js[j] == n_file
                  and r["final"].R.shape[0] == n_js[j]
                  and all(np_isfinite(v) for v in r["outs"].values())
                  and 0.0 < frac < 1.0 and ek[-1] > ek[0] > 0.0
                  and float(np.abs(e[:, 4]).max()) < 0.1 * ek[-1]
                  and rows == len(segs))
            if not ok:
                raise SystemExit(f"frozen-tag fold: member {j} fails its "
                                 "checks")
        if np.array_equal(results[0]["spin_up"][:100],
                          results[1]["spin_up"][:100]):
            raise SystemExit("frozen-tag fold: members 0 and 1 are the same")
    # 2-point sweeps of the pump's detuning, Rabi frequency and both (the
    # tick kernel's S=5 per-lane forms e0, om, e0_om): the member at cfg's
    # own (detuning, om) is the 2-member ensemble's, bit for bit
    cfg = ft.FrozenTagConfig(exact_n=False, **TAG_CUT)
    ens = ft.run_ensemble(cfg, 2, device="cuda")
    own = {"detuning": cfg.detuning, "om": cfg.om}
    sweeps = {}
    for form, other in (("e0", {"detuning": -4.0}), ("om", {"om": 0.8}),
                        ("e0_om", {"detuning": -4.0, "om": 0.8})):
        reset_counts()
        t0 = time.perf_counter()
        swept, mcfgs = ft.run_sweep(cfg, [own, other], device="cuda")
        wall_s = time.perf_counter() - t0
        c_sweep = sweeps[form] = read_counts()
        want_counts(c_sweep, f"the frozen-tag sweep over {other}",
                    yukawa_forces_batched=n_md + 1,
                    yukawa_forces_potential_batched=len(segs) + 2,
                    **{f"fused_ticks_s5_per_lane_{form}": pump_steps})
        same = (np.array_equal(swept[0]["spin_up"], ens[0]["spin_up"])
                and np.array_equal(swept[0]["final"].psi, ens[0]["final"].psi)
                and np.array_equal(swept[0]["final"].R, ens[0]["final"].R)
                and all(np.array_equal(swept[0]["outs"][k], ens[0]["outs"][k])
                        for k in ens[0]["outs"]))
        fr = [float(r["spin_up"].mean()) for r in swept]
        log(f"[frozen-fold] run_sweep over {[own, other]} in {wall_s:.3f} s, "
            f"launches {c_sweep['yukawa_forces_batched']} C / "
            f"{c_sweep['yukawa_forces_potential_batched']} G / "
            f"{c_sweep[f'fused_ticks_s5_per_lane_{form}']} B ({form} form); "
            f"tag fractions {fr[0]:.4f} / {fr[1]:.4f}; the identity member "
            f"equals the 2-member ensemble's bit for bit: {same}")
        if not same:
            raise SystemExit("the identity sweep member differs from the "
                             "ensemble member")
        if np.array_equal(swept[1]["final"].psi[:100],
                          swept[0]["final"].psi[:100]):
            raise SystemExit("the swept member pumped like the other")
    return counts, dict(wall=wall, steps_per_s=n_md / wall, sweeps=sweeps)


def frozen_408_path(torch, card):
    """Phase 21: the 408quad variant (7 states, the full tag-instant
    row)."""
    import numpy as np
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ft.FrozenTagConfig(variant="408quad", tstart=0.1, tmax=0.4,
                                 save_directory=tmp)
        n_md_a, n_md, segs, _ = ft._phase_b_plan(cfg)
        reset_counts()
        t0 = time.perf_counter()
        final, res = ft.run(cfg, device="cuda")
        wall = time.perf_counter() - t0
        counts = read_counts()
        want_counts(counts, "the 408quad run", yukawa_forces=n_md + 1,
                    yukawa_forces_potential=len(segs) + 2,
                    fused_ticks_s7=frozen_pump_steps(torch, cfg)[0])
        frac = float(res["spin_up"].mean())
        f = cfg.sample_freq
        l0 = n_md_a + (f - n_md_a % f) - 1
        labels = [n_md_a - 1] + [l0 + k * f for k in range(len(segs))]
        # the tag-instant row leads every stream of the 408 variants
        _tag_tree(cfg.job_dir(), "vSquareAutoCorr.dat", len(segs) + 1,
                  len(segs) + 1, labels, n_md_a - 1, n_md - 1)
        t = np.loadtxt(os.path.join(cfg.job_dir(), "energies.dat"))[:, 0]
        log(f"[frozen-408quad] run(variant='408quad', tstart=0.1, tmax=0.4), "
            f"N0={cfg.n0}, S={final.psi.shape[1]}, ratio {cfg.ratio}: {n_md} "
            f"MD steps in {wall:.3f} s ({card}); tag fraction {frac:.4f}; "
            f"rows at t = {t[0]:.6g} (tag instant, {res['out_tag']['t']:.6g})"
            f" .. {t[-1]:.6g}; vel_distX labels {labels}")
        if not (final.psi.shape[1] == 7 and frac < 0.3
                and abs(t[0] - float(res["out_tag"]["t"])) < 1e-5
                and np_isfinite(res["outs"]["long_kin"])):
            raise SystemExit("408quad: wrong state count, tag fraction or "
                             "tag-instant row")
    return counts


def three_state_launches(c, members: int) -> int:
    """Tick-kernel launches of a three-state run or fold: one per block of
    ticks (three_state.roll_block), every segment."""
    from mdqtplasmasims_torch.experiments import three_state as ts
    lanes = (c.n0,) if members == 1 else (members, c.n0)
    return c.n_segments * -(-c.sample_freq // ts.roll_block(c, lanes))


def three_state_path(torch, card):
    """Phase 22: the three-state family at full width through the tick
    kernel's S=3 forms, and the fold over two mesh slots of the card."""
    import numpy as np
    from mdqtplasmasims_torch.experiments import three_state as ts
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    cfg = ts.ThreeStateConfig(tmax=30.0)
    rates, launched = {}, {}
    grid = [{"detuning": d, "om": o} for d in (-0.5, -1.0) for o in (0.5, 1.0)]
    with tempfile.TemporaryDirectory() as tmp:
        cfg_w = dataclasses.replace(cfg, save_directory=tmp)
        cfg_f = dataclasses.replace(cfg_w, tmax=20.0)    # the folds: 2000
        short = dataclasses.replace(cfg, tmax=10.0)
        swp = dataclasses.replace(cfg, tmax=20.0)       # 2 segments
        runs = (
            ("run", 1, cfg_w, "fused_ticks_s3",
             lambda: ts.run(cfg_w, device="cuda")),
            ("run_ensemble(8)", 8, cfg_f, "fused_ticks_s3",
             lambda: ts.run_ensemble(cfg_f, 8, device="cuda")),
            ("run_sweep(2x2)", 4, cfg_f, "fused_ticks_s3_per_lane_e0_om",
             lambda: ts.run_sweep(cfg_f, grid, device="cuda")[0]),
            ("run_sweep(detuning)", 2, swp, "fused_ticks_s3_per_lane_e0",
             lambda: ts.run_sweep(swp, [{"detuning": -0.5},
                                        {"detuning": -2.0}],
                                  device="cuda")[0]),
            ("run_sweep(om)", 2, swp, "fused_ticks_s3_per_lane_om",
             lambda: ts.run_sweep(swp, [{"om": 0.5}, {"om": 1.0}],
                                  device="cuda")[0]))
        for name, members, c, form, call in runs:
            ticks = c.n_segments * c.sample_freq
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = call()                          # ends in a host fetch
            wall = time.perf_counter() - t0
            counts = read_counts()
            want_counts(counts, f"three-state {name}",
                        **{form: three_state_launches(c, members)})
            launched[name] = counts[form]
            ek = np.atleast_2d(res["ekin_x"])
            rates[name] = ticks / wall
            log(f"[three-state] {name}: ThreeStateConfig(tmax={c.tmax:g}), n0="
                f"{cfg.n0}, {members} member(s), {ticks} ticks in {wall:.3f} "
                f"s -> {ticks / wall:.1f} ticks/s, {1e3 * wall / ticks:.4f} "
                f"host ms per tick, {members * cfg.n0 * ticks / wall:.4g} "
                f"ion-QT-updates/s, {counts[form]} launches of {form} "
                f"({card}); <Ekin_x> {ek[:, 0].mean():.6g} -> "
                f"{ek[:, -1].mean():.6g}, ground population "
                f"{np.atleast_2d(res['ground_pop'])[:, -1].mean():.4f}")
            if not (np_isfinite(res["ekin_x"]) and np_isfinite(res["V"])
                    and ek.shape == (members, c.n_segments)
                    and ek[:, -1].mean() < ek[:, 0].mean()):
                raise SystemExit(f"three-state {name}: x kinetic energy did "
                                 "not fall")
            if members == 2 and np.array_equal(ek[0], ek[1]):
                raise SystemExit(f"three-state {name}: the members agree")
        files = glob_all(tmp, "energies.dat")
        if len(files) != 1 + 8 + 4 - 2:      # sweep point 1 reuses job1's dir
            raise SystemExit(f"three-state wrote {len(files)} energies.dat")
    dev = torch.device("cuda", 0)
    reset_counts()
    a = ts.run_ensemble(short, 8, seed=3, device="cuda")
    want_counts(read_counts(), "the three-state fold",
                fused_ticks_s3=three_state_launches(short, 8))
    reset_counts()
    b = ts.run_ensemble(short, 8, seed=3,
                        mesh=make_mesh(2, 1, devices=[dev] * 2))
    # each slot launches its 4 members in the fold's blocks of ticks
    want_counts(read_counts(), "the member-sharded three-state fold",
                fused_ticks_s3=2 * three_state_launches(short, 8))
    same = (np.array_equal(a["ekin_x"], b["ekin_x"])
            and np.array_equal(a["V"], b["V"])
            and np.array_equal(a["ground_pop"], b["ground_pop"]))
    log(f"[three-state] 8-job fold (tmax=10) through member_sharded over 2 "
        f"slots on {dev} vs the unsharded fold: bitwise equal {same}")
    if not same:
        raise SystemExit("the member-sharded three-state fold differs from "
                         "the unsharded one")
    return launched, rates


# ---- the Monte-Carlo families (phases 23-26)

# the transport cut of phases 24 and 26: 2000 MC steps in 2 chunks, 751
# MD steps (100 + 200 recorded + 200 + 100 + 51 under the laser + 100)
TRANSPORT_CUT = dict(mc_steps=2000, gr_every_mc=1000, pre_record_md_steps=100,
                     record_steps=200, gr_every_record=100,
                     instant_aniso_steps=200, reequil_steps=100,
                     aniso_time_us=0.5, aniso_relax_steps=100)
# the MC-tagging cut of phase 25: 2000 MC steps, 200 collisional MD steps,
# the production pump window, 200 recorded steps
MC_TAG_CUT = dict(mc_steps=2000, record_steps=200)
# the identity check of phase 25 at a shorter depth: a 5-step pump window
MC_TAG_SHORT = dict(mc_steps=500, pre_record_md_steps=20, record_steps=100,
                    tpump_seconds=2e-8)
MC_ACCEPT_BAND = (0.05, 0.99)          # tests/test_classical.py:187
MC_R_TOL = 1e-12                       # float64 chain, card against CPU


def _synced_wall(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def metropolis_path(torch, card):
    """Phase 23: the Metropolis chain at full width (n = 4096, the
    transport config's Gamma and kappa) from the lattice start: 2000 steps
    of one job and of an 8-member fold with per-member generators, timed;
    the acceptance band and the correlation hole; 200 float64 steps on the
    card against the same draws on the CPU."""
    from mdqtplasmasims_torch.core.init import lattice_init
    from mdqtplasmasims_torch.core.mc import McDraws, MetropolisMC, draw_mc
    from mdqtplasmasims_torch.experiments import mc_md_anisotropy as tr
    from mdqtplasmasims_torch.ops.structure import pair_correlation
    cfg = tr.MCTransportConfig()
    dev = torch.device("cuda")
    R0, _ = lattice_init(torch.Generator(device=dev).manual_seed(1), cfg.n,
                         cfg.gamma, cfg.L)
    mc = MetropolisMC(L=cfg.L, ldeb=cfg.ldeb, gamma=cfg.gamma,
                      max_r_step=cfg.max_r_step)
    steps = 2000
    rates = {}
    reset_counts()
    for E in (1, 8):
        gens = [torch.Generator(device=dev).manual_seed(10 + j)
                for j in range(E)]
        R = R0[None].expand(E, -1, -1).contiguous()
        mc.run(R, draws=draw_mc(gens, 20, cfg.n))       # warm-up, untimed
        (R, acc), wall = _synced_wall(torch, lambda: mc.run(
            R, draws=draw_mc(gens, steps, cfg.n)))
        rates[E] = 1e3 * wall / steps
        frac = (acc.float() / steps).cpu().numpy()
        g = pair_correlation(R[0], cfg.L).cpu().numpy()
        log(f"[metropolis] E={E}: {steps} steps of n={cfg.n} (Gamma "
            f"{cfg.gamma:g}, kappa {cfg.kappa:g}) in {wall:.3f} s -> "
            f"{rates[E]:.4f} ms per MC step ({card}); acceptance "
            f"{frac.min():.4f} .. {frac.max():.4f}; g(r<0.4) max "
            f"{g[:8].max():.3g}, g peak {g.max():.4g} at r="
            f"{0.05 * g.argmax():.3g}")
        if not (MC_ACCEPT_BAND[0] < frac.min() <= frac.max()
                < MC_ACCEPT_BAND[1]):
            raise SystemExit(f"metropolis E={E}: acceptance outside "
                             f"{MC_ACCEPT_BAND}")
        if not (np_isfinite(R.cpu()) and g[:8].max() < 0.5 and g.max() > 1.0):
            raise SystemExit(f"metropolis E={E}: no correlation hole")
    want_counts(read_counts(), "the Metropolis chain")   # plain torch only
    # 200 float64 steps: the card and the CPU from the same draws
    cpu = torch.Generator().manual_seed(3)
    Rr = (torch.rand((cfg.n, 3), generator=cpu, dtype=torch.float64)
          * cfg.L)
    d = draw_mc([cpu], 200, cfg.n, torch.float64)
    R_c, a_c = mc.run(Rr.to(dev), draws=McDraws(*(x.to(dev) for x in d)))
    R_h, a_h = mc.run(Rr, draws=d)
    err = float((R_c.cpu() - R_h).abs().max())
    log(f"[metropolis] float64, 200 steps from a random start: accepted "
        f"{int(a_c)} on the card, {int(a_h)} on the CPU; max |R| difference "
        f"{err:.3g} (tol {MC_R_TOL:g})")
    if int(a_c) != int(a_h) or not err <= MC_R_TOL:
        raise SystemExit("the float64 chain on the card differs from the "
                         "CPU's")
    return rates


@contextlib.contextmanager
def first_forces():
    """Keep ``(R, F)`` of the first force call that a staged-family run
    started inside the context makes (core/pipeline._forces wrapped; the
    call is the run's own kernel launch, counted as usual)."""
    from mdqtplasmasims_torch.core import pipeline
    first = []
    orig = pipeline._forces

    def keeping(*a, **kw):
        fn = orig(*a, **kw)

        def forces(R):
            F = fn(R)
            if not first:
                first.append((R.clone(), F.clone()))
            return F
        return forces
    pipeline._forces = keeping
    try:
        yield first
    finally:
        pipeline._forces = orig


def check_first_forces(torch, first, L, ldebs, what):
    """Hold a run's captured start forces ``F [E, N, 3]`` against the plain
    version on the same card tensors at each member's ldeb, FORCE_TOL of
    max|F|; fails the run on a miss."""
    from mdqtplasmasims_torch.ops import yukawa as ty
    R, F = first[0]
    errs = []
    for j, ld in enumerate(ldebs):
        ref = ty.yukawa_forces_potential(R[j], L, ld)[0]
        errs.append((float((F[j] - ref).abs().max()),
                     float(ref.abs().max())))
    log(f"[{what}] start forces {tuple(F.shape)} (L {L:.4f}) against the "
        "plain version at each member's ldeb: " + ", ".join(
            f"member {j} ldeb {ld:g}: max|F| {s:.4g}, max abs err {e:.3g}"
            for j, (ld, (e, s)) in enumerate(zip(ldebs, errs)))
        + f" (tol {FORCE_TOL:g} of max|F|)")
    if not all(e <= FORCE_TOL * s for e, s in errs):
        raise SystemExit(f"{what}: the start forces disagree with the plain "
                         "version")


def _md_ms(torch, cfg, E, single):
    """Host-clock ms per collisional velocity-Verlet MD step of E members
    at cfg's width (a job: kernel A; a fold: kernel C), 50 steps from a
    lattice start."""
    from mdqtplasmasims_torch.core import pipeline as pl
    from mdqtplasmasims_torch.core.draws import MemberDraws
    dev = torch.device("cuda")
    m = pl.members_of(cfg, [cfg.gamma] * E, [cfg.ldeb] * E, MemberDraws(
        [torch.Generator(device=dev).manual_seed(j) for j in range(E)]),
        single=single)
    R, V = pl.lattice_start(cfg, m, dev)
    A = m.forces(R)
    pl.md_stage(cfg, m, R, V, A, 5, collision_freq=cfg.collision_freq)
    _, wall = _synced_wall(torch, lambda: pl.md_stage(
        cfg, m, R, V, A, 50, collision_freq=cfg.collision_freq))
    return 1e3 * wall / 50


def _arrays_equal(a, b) -> bool:
    import numpy as np
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def transport_path(torch, card):
    """Phase 24: ``mc_md_anisotropy.run`` at full width (n = 4096) at the
    cut depths, with checkpoints: exact launch counts, the run's start
    forces (kernel A on [1, 4096, 3], no padding) against the plain
    version, VAF(0), the instantaneous anisotropy relaxing, the tree; then
    a crash mid-record resumed bit for bit."""
    import numpy as np
    from mdqtplasmasims_torch.experiments import mc_md_anisotropy as tr
    with tempfile.TemporaryDirectory() as tmp:
        cfg = tr.MCTransportConfig(save_directory=os.path.join(tmp, "a"),
                                   checkpoint_every_chunks=1, **TRANSPORT_CUT)
        n_md = cfg.md_steps
        reset_counts()
        with first_forces() as first:
            res, wall = _synced_wall(torch, lambda: tr.run(cfg,
                                                           device="cuda"))
        counts = read_counts()
        log(f"[transport] run(MCTransportConfig(n={cfg.n}, "
            f"{', '.join(f'{k}={v}' for k, v in TRANSPORT_CUT.items())}, "
            f"checkpoint_every_chunks=1), device='cuda'): {cfg.mc_steps} MC "
            f"+ {n_md} MD steps in {wall:.3f} s ({card})")
        log(f"[transport] launches: {counts}")
        want_counts(counts, "the transport run", yukawa_forces=n_md + 1)
        check_first_forces(torch, first, cfg.L, [cfg.ldeb], "transport")
        ti = res["temps_inst"]
        aniso = ti[:, 0] - 0.5 * (ti[:, 1] + ti[:, 2])
        log(f"[transport] accepted {int(res['mc_accepted'])} of "
            f"{cfg.mc_steps}; VAF(0) {res['vaf'][0]:.4g}; temps_inst x/y/z "
            f"{ti[0, 0]:.4g}/{ti[0, 1]:.4g}/{ti[0, 2]:.4g} -> "
            f"{ti[-1, 0]:.4g}/{ti[-1, 1]:.4g}/{ti[-1, 2]:.4g} (x - <y,z> "
            f"{aniso[0]:.4g} -> {aniso[-1]:.4g}); temps_force x/y "
            f"{res['temps_force'][-1, 0]:.4g}/{res['temps_force'][-1, 1]:.4g}")
        if not all(np_isfinite(v) for v in res.values()):
            raise SystemExit("transport: non-finite outputs")
        if not 0.3 < res["vaf"][0] < 3.0:
            raise SystemExit("transport: VAF(0) outside 0.3-3.0")
        # x hot by the applied rescale, 1.15/0.925 of y and z; at n = 4096
        # an axis's temperature fluctuates by ~2 %
        x_hot = ti[0, 0] / (0.5 * (ti[0, 1] + ti[0, 2]))
        if not (1.1 < x_hot < 1.4
                and aniso[-20:].mean() < aniso[:20].mean()):
            raise SystemExit(f"transport: the rescale heated x by {x_hot:.3f}"
                             " (want ~1.15/0.925) or did not relax")
        names = {os.path.basename(p) for p in glob_all(tmp, "VAF.dat")
                 + glob_all(tmp, "TemperaturesAlongAxesAfterForcePeriod.dat")
                 + glob_all(tmp, "pairPairCorrStepNum1000.dat")}
        if len(names) != 3:
            raise SystemExit(f"transport: tree incomplete ({names})")
        # a crash after the 4th checkpoint (mid-record: the stored
        # velocities ride it), resumed
        cfg_b = dataclasses.replace(cfg, save_directory=os.path.join(tmp,
                                                                     "b"))
        try:
            tr.run(cfg_b, device="cuda", _crash_after_checkpoints=4)
            raise SystemExit("transport: the crash hook did not fire")
        except RuntimeError:
            pass
        resumed = tr.run(cfg_b, device="cuda", resume=True)
        same = _arrays_equal(res, resumed)
        log(f"[transport] crash after checkpoint 4 (stage 2, chunk 1), "
            f"resumed: bitwise equal to the uninterrupted run {same}")
        if not same:
            raise SystemExit("transport: the resumed run differs")
    md1 = _md_ms(torch, cfg, 1, True)
    md8 = _md_ms(torch, cfg, 8, False)
    log(f"[transport] collisional MD step at n={cfg.n}: {md1:.4f} ms (job, "
        f"kernel A), {md8:.4f} ms (fold of 8, kernel C), host clock ({card})")
    return counts, dict(wall=wall, md_ms={1: md1, 8: md8})


def mc_tag_path(torch, card):
    """Phase 25: ``mc_qt_tagging.run`` (408quad) at full width with the
    production pump window; a fold of 8 (its start forces, kernel C on [8,
    4096, 3], against the plain version); a 2-point detuning sweep whose
    identity member equals the 2-member ensemble's bit for bit."""
    from mdqtplasmasims_torch.experiments import mc_qt_tagging as mt
    with tempfile.TemporaryDirectory() as tmp:
        cfg = mt.MCTagConfig(variant="408quad", save_directory=tmp,
                             **MC_TAG_CUT)
        n_md, ticks = cfg.md_steps, cfg.pump_md_steps * cfg.ratio
        reset_counts()
        res, wall = _synced_wall(torch, lambda: mt.run(cfg, device="cuda"))
        counts = read_counts()
        frac = float(res["tags"].mean())
        log(f"[mc-tag] run(MCTagConfig(variant='408quad', n={cfg.n}, "
            f"mc_steps={cfg.mc_steps}, record_steps={cfg.record_steps}), "
            f"device='cuda'): {cfg.mc_steps} MC + {n_md} MD steps ("
            f"{cfg.pump_md_steps} pump steps of {cfg.ratio} ticks = {ticks} "
            f"ticks) in {wall:.3f} s ({card}); tag fraction {frac:.4f}; "
            f"VAF(0) {res['vaf'][0]:.4g}")
        log(f"[mc-tag] launches: {counts}")
        want_counts(counts, "the mc-tag run", yukawa_forces=n_md + 1,
                    fused_ticks_s7=cfg.pump_md_steps)
        if not (all(np_isfinite(v) for v in res.values()) and 0 < frac < 1):
            raise SystemExit("mc-tag: non-finite outputs or tag fraction "
                             "outside (0, 1)")
        if len(glob_all(tmp, "vel_distX_timestep000199.dat")) != 1:
            raise SystemExit("mc-tag: tree incomplete")
    E = 8
    reset_counts()
    with first_forces() as first:
        fold, wall8 = _synced_wall(torch, lambda: mt.run_ensemble(
            dataclasses.replace(cfg, save_directory=None), E, device="cuda"))
    c_fold = read_counts()
    fr = [float(r["tags"].mean()) for r in fold]
    log(f"[mc-tag] run_ensemble(n_jobs={E}) at the same cut in {wall8:.3f} s "
        f"({card}); tag fractions {min(fr):.4f} .. {max(fr):.4f}")
    log(f"[mc-tag] fold launches: {c_fold}")
    want_counts(c_fold, "the mc-tag fold", yukawa_forces_batched=n_md + 1,
                fused_ticks_s7=cfg.pump_md_steps)
    check_first_forces(torch, first, cfg.L, [1.0 / cfg.kappa] * E,
                       "mc-tag fold")
    if not all(0 < f < 1 for f in fr) or _arrays_equal(fold[0], fold[1]):
        raise SystemExit("mc-tag fold: members fail their checks")
    # 2-point sweeps of the pump's detuning, Rabi frequency and both (the
    # tick kernel's S=7 per-lane forms)
    short = mt.MCTagConfig(variant="408quad", **MC_TAG_SHORT)
    ens = mt.run_ensemble(short, 2, device="cuda")
    sweeps = {}
    for form, other in (("e0", {"detuning": -3.0}), ("om", {"om": 1.0}),
                        ("e0_om", {"detuning": -3.0, "om": 1.0})):
        reset_counts()
        swept, mcfgs = mt.run_sweep(short, [{}, other], device="cuda")
        c_sweep = sweeps[form] = read_counts()
        want_counts(c_sweep, f"the mc-tag sweep over {other}",
                    yukawa_forces_batched=short.md_steps + 1,
                    **{f"fused_ticks_s7_per_lane_{form}":
                       short.pump_md_steps})
        same = _arrays_equal(swept[0], ens[0])
        log(f"[mc-tag] 2-point sweep over {other} (mc_steps="
            f"{short.mc_steps}, {short.pump_md_steps} pump steps, the "
            f"{form} form): the identity member equals the 2-member "
            f"ensemble's bit for bit: {same}")
        if not same or _arrays_equal(swept[1], ens[1]):
            raise SystemExit("mc-tag sweep: the identity member differs, or "
                             "the swept member does not")
    return counts, c_fold, dict(wall=wall, wall8=wall8, sweeps=sweeps)


def pump_step_ms(torch, E):
    """Host-clock ms per pump MD step (408quad: one launch of 62 ticks of
    the tick kernel and a velocity-Verlet step) of E members at n = 4096,
    3 steps."""
    from mdqtplasmasims_torch.core.draws import MemberDraws
    from mdqtplasmasims_torch.core.pipeline import lattice_start
    from mdqtplasmasims_torch.experiments import mc_qt_tagging as mt
    from mdqtplasmasims_torch.state import SimState, complex_dtype
    dev = torch.device("cuda")
    cfg = mt.MCTagConfig(variant="408quad")
    draws = MemberDraws([torch.Generator(device=dev).manual_seed(j)
                         for j in range(E)])
    m = mt._members(cfg, E, draws, single=E == 1)
    R, V = lattice_start(cfg, m, dev)
    st = SimState(R=R, V=V, F=m.forces(R),
                  psi=draws.psi(cfg.n, cfg.n_states,
                                complex_dtype(torch.float32)),
                  t_part=torch.zeros((E, cfg.n), device=dev))
    sched = mt._make_scheduler(cfg, m)
    st = mt._pump_chunk(sched, st, 1)
    _, wall = _synced_wall(torch, lambda: mt._pump_chunk(sched, st, 3))
    return 1e3 * wall / 3


def transport_sweep_path(torch, card):
    """Phase 26: a 2 x 2 (Gamma, kappa) transport sweep at full width
    through kernel C with a per-member ``ldeb [E]``: exact launch counts,
    and the forces of the MD's start against the plain version at each
    member's ldeb."""
    from mdqtplasmasims_torch.experiments import mc_md_anisotropy as tr
    cfg = tr.MCTransportConfig(**TRANSPORT_CUT)
    pts = [{"gamma": g, "kappa": k} for g in (3.0, 10.0) for k in (0.5, 1.0)]
    reset_counts()
    with first_forces() as first:
        (res, mcfgs), wall = _synced_wall(torch, lambda: tr.run_sweep(
            cfg, pts, device="cuda"))
    counts = read_counts()
    log(f"[transport-sweep] run_sweep over (Gamma, kappa) "
        f"{[(m.gamma, m.kappa) for m in mcfgs]} at the phase-24 cut in "
        f"{wall:.3f} s ({card})")
    log(f"[transport-sweep] launches: {counts}")
    want_counts(counts, "the transport sweep",
                yukawa_forces_batched=cfg.md_steps + 1)
    check_first_forces(torch, first, cfg.L, [m.ldeb for m in mcfgs],
                       "transport-sweep")
    vaf0 = [float(r["vaf"][0]) for r in res]
    if not (all(np_isfinite(v) for r in res for v in r.values())
            and vaf0[0] > vaf0[2] and vaf0[1] > vaf0[3]):
        raise SystemExit(f"transport sweep: VAF(0) {vaf0} does not fall "
                         "with Gamma")
    log(f"[transport-sweep] VAF(0) per member {[round(v, 4) for v in vaf0]}"
        " (3/Gamma-like)")
    return counts


def mc_projections(card, mc_ms, md_ms, pump_ms):
    """Production times the measured rates imply (host clock): a transport
    job (200,000 MC + 8,712 MD steps), an mc-tag 408quad job (100,000 MC +
    1,700 MD steps + 23 pump steps of 62 ticks), each for one job and for
    a fold of 8."""
    for E in (1, 8):
        tj = (200_000 * mc_ms[E] + 8_712 * md_ms[E]) / 1e3
        mj = (100_000 * mc_ms[E] + 1_700 * md_ms[E] + 23 * pump_ms[E]) / 1e3
        log(f"[projection] E={E}: MC step {mc_ms[E]:.4f} ms, MD step "
            f"{md_ms[E]:.4f} ms, pump MD step {pump_ms[E]:.2f} ms -> "
            f"transport job {tj:.1f} s ({100 * 200_000 * mc_ms[E] / 1e3 / tj:.0f}"
            f" % MC), mc-tag job {mj:.1f} s ({card})")


# ---- presets, the .dat codec, the host tools and a trace (phases 27-29)

# the tabs of a flagship tree (CoolingConfig() to tmax=30: 375 samples)
FLAGSHIP_PANELS = ["Kinetic energies", "Energy audit (cooling removes energy)",
                   "Velocity distribution (x)",
                   "State populations vs velocity (last sample)"]


def _timed(torch, fn):
    """(result, seconds) of ``fn()`` from a synced card to its return."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def same_trees(a, b):
    """The files of job directories ``a`` and ``b`` as the writers left
    them: the same names, every text file byte for byte, and every array
    of a ``.npz`` both hold bitwise (a rewrite carries no generator state,
    and the archive's member timestamps differ).  Returns (ok, what)."""
    import filecmp
    import numpy as np
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    if fa != fb:
        return False, f"file lists differ: {sorted(set(fa) ^ set(fb))[:6]}"
    for name in fa:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                keys = set(za.files) & set(zb.files)
                if ({"R", "V", "psi", "counter"} - keys or not all(
                        np.array_equal(za[k], zb[k]) for k in keys)):
                    return False, f"{name} differs"
        elif not filecmp.cmp(pa, pb, shallow=False):
            return False, f"{name} differs"
    return True, f"{len(fa)} files"


def rewrite_tree(cfg, outs, epot0, final, directory, fmt, n_actual=None):
    """Seconds to write one finished run's tree (.dat files and terminal
    checkpoint, one group, aligned tmax) again into ``directory`` through
    the formatter ``fmt``."""
    from mdqtplasmasims_torch.experiments.laser_cooling import write_outputs
    n_md = int(round(cfg.tmax / cfg.timestep))
    t0 = time.perf_counter()
    write_outputs(directory, cfg, outs, epot0, final, n_md,
                  n_actual=n_actual, fmt=fmt)
    return time.perf_counter() - t0


def presets_path(torch, card, root):
    """Phase 27: the flagship preset to tmax=30 with its tree through the
    codec, the same tree written again through the Python ``%g`` path
    (byte for byte), then the pre-speedup preset unmodified with exact
    launch counts and its interval diagnostics.  Returns the two job
    directories."""
    import numpy as np
    from mdqtplasmasims_torch import _build
    from mdqtplasmasims_torch.experiments import presets
    from mdqtplasmasims_torch.experiments.laser_cooling import _save_dir, run
    from mdqtplasmasims_torch.io import datfiles
    from mdqtplasmasims_torch.units import PlasmaUnits
    cfg = presets.north_star(save_directory=os.path.join(root, "north_star"))
    n_md = int(round(cfg.tmax / cfg.timestep))
    if n_md % cfg.sample_freq or cfg.checkpoint_every_segments:
        raise SystemExit("the flagship rewrite assumes one aligned group")
    (final, res), wall = _timed(torch, lambda: run(cfg, device="cuda"))
    _, wall_bare = _timed(torch, lambda: run(
        dataclasses.replace(cfg, save_directory=None), device="cuda"))
    job = _save_dir(cfg)
    t_codec = rewrite_tree(cfg, res["outs"], res["epot0"], final,
                           os.path.join(root, "north_star_codec"),
                           datfiles.format_rows)
    t_py = rewrite_tree(cfg, res["outs"], res["epot0"], final,
                        os.path.join(root, "north_star_py"),
                        datfiles.format_rows_py)
    same_py, what_py = same_trees(job, os.path.join(root, "north_star_py"))
    same_c, what_c = same_trees(job, os.path.join(root, "north_star_codec"))
    size = sum(os.path.getsize(os.path.join(job, f)) for f in os.listdir(job))
    shutil.rmtree(os.path.join(root, "north_star_py"))
    shutil.rmtree(os.path.join(root, "north_star_codec"))
    log(f"[presets] run(presets.north_star()) to tmax={cfg.tmax:g} ({n_md} "
        f"MD steps) "
        f"with its tree: {wall:.3f} s; without the tree {wall_bare:.3f} s "
        f"({card})")
    log(f"[presets] the tree ({what_py}, {size / 2 ** 20:.1f} MiB) written "
        f"again: codec {t_codec:.3f} s, Python %g {t_py:.3f} s; the codec's "
        f"build {_build.build_seconds.get('datio', 0.0):.2f} s (cc, at its "
        f"first use); run's tree == Python tree byte for byte: {same_py}; "
        f"== codec rewrite: {same_c} ({what_c})")
    if not (same_py and same_c):
        raise SystemExit(f"the codec's tree differs from the Python path's: "
                         f"{what_py}; {what_c}")

    # the reference's original program, unmodified
    pcfg = presets.pre_speedup(save_directory=os.path.join(root,
                                                           "pre_speedup"))
    n_md = int(round(pcfg.tmax / pcfg.timestep))
    n_samples = n_md // pcfg.sample_freq
    reset_counts()
    (pfinal, pres), pwall = _timed(torch, lambda: run(pcfg, device="cuda"))
    counts = read_counts()
    log(f"[presets] run(presets.pre_speedup()) (N0={pcfg.n0}, tmax="
        f"{pcfg.tmax:g}, physics={pcfg.physics!r}, "
        f"{len(pcfg.vaf_intervals)} VAF intervals, LCCF) in {pwall:.3f} s "
        f"({card}); launches: {counts}")
    want_counts(counts, "the pre-speedup run", yukawa_forces=n_md,
                fused_ticks_rng=n_md + n_samples,
                yukawa_forces_potential=n_samples + 1)
    outs = pres["outs"]
    pjob = _save_dir(pcfg)
    got, j_shape, j_err, j_ok = check_interval_files(
        pjob, pcfg, outs, PlasmaUnits.box_length(pcfg.n0))
    missing = [k for k in range(len(pcfg.vaf_intervals)) if not
               os.path.exists(os.path.join(pjob, f"VAF_interval{k}.dat"))]
    e = datfiles.read_rows(os.path.join(pjob, "energies.dat"), 7)
    norms = outs["pops"].sum(-1)
    pop_err = float(abs(norms.mean(-1) - 1.0).max())
    finite = all(np_isfinite(a) for a in (pfinal.R, pfinal.V, pfinal.psi,
                                          *outs.values()))
    log(f"[presets] pre-speedup: VAF rows and checks {got}; "
        f"J_interval0.dat {j_shape}, max err vs float64 direct sum "
        f"{j_err:.3g} of max|J| (tol {LCCF_TOL:g}), ok {j_ok}; energy audit "
        f"{e[0, 5]:.4g} -> {e[-1, 5]:.4g}; max |<S+P+D>-1| {pop_err:.3g} "
        f"(tol {POP_TOL:g}); EkinX {e[0, 1]:.4g} -> {e[-1, 1]:.4g}")
    if (missing or len(got) != 13 or not all(ok for _, ok in got)
            or not j_ok):
        raise SystemExit(f"pre-speedup interval files wrong: missing VAF "
                         f"intervals {missing}, checks {got}, J ok {j_ok}")
    if not (finite and e.shape[0] == n_samples and e[-1, 5] < 0.0
            and e[-1, 5] < e[0, 5] and pop_err <= POP_TOL):
        raise SystemExit("pre-speedup run: non-finite values, wrong rows, "
                         "an energy audit that did not fall, or S+P+D off")
    return {"north_star": job, "pre_speedup": pjob}, counts


def _report_sections(rep) -> list:
    return [k for k in rep if k not in ("job_dir", "notes")]


def host_tools_path(torch, card, trees, root):
    """Phase 28: ``analyze_job``, ``collect_panels`` and ``cli analyze``
    on phase 27's trees; an 8-member Poissonian ``run_ensemble`` with its
    trees (timed with and without, its member trees written again through
    both formatters) and ``analyze_ensemble`` on its parameter
    directory."""
    import io
    import numpy as np
    from mdqtplasmasims_torch import analysis, cli, quicklook
    from mdqtplasmasims_torch.core.init import poisson_member_mask
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, _member_np, _save_dir, run_ensemble)
    from mdqtplasmasims_torch.io import datfiles
    for name, job in trees.items():
        t0 = time.perf_counter()
        rep = analysis.analyze_job(job)
        t_an = time.perf_counter() - t0
        text = analysis.format_job_report(rep)
        titles = [t for t, _ in quicklook.collect_panels(job)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["analyze", job, "--json"])
        same = json.loads(buf.getvalue()) == json.loads(json.dumps(rep))
        log(f"[host] analyze_job({name}) in {t_an:.3f} s: sections "
            f"{_report_sections(rep)}, notes {rep['notes']}, "
            f"{len(text.splitlines())} report lines; panels {titles}; "
            f"`analyze --json` rc {rc}, same report {same}")
        for line in text.splitlines()[:6]:
            log(f"[host]   {line}")
        want = FLAGSHIP_PANELS + (["Velocity autocorrelation"]
                                  if name == "pre_speedup" else [])
        ok = (rc == 0 and same and titles == want and not rep["notes"]
              and {"energies", "structure"} <= set(rep)
              and rep["structure"]["checkpoint"] == 14999)
        if name == "pre_speedup":
            d = rep.get("diffusion", {}).get("d", float("nan"))
            ok = ok and np.isfinite(d) and d > 0 and "dispersion" in rep
        if not ok:
            raise SystemExit(f"the host tools on the {name} tree: {rep}")

    E = 8
    cfg = CoolingConfig(n0=3500, tmax=1.0, exact_n=False,
                        save_directory=os.path.join(root, "ensemble"))
    (final, outs), wall = _timed(torch, lambda: run_ensemble(
        cfg, E, device="cuda"))
    _, wall_bare = _timed(torch, lambda: run_ensemble(
        dataclasses.replace(cfg, save_directory=None), E, device="cuda"))
    _, n_js = poisson_member_mask(cfg.n0, E, 0)
    n_md = int(round(cfg.tmax / cfg.timestep))
    secs, same = {}, []
    for tag, fmt in (("codec", datfiles.format_rows),
                     ("python", datfiles.format_rows_py)):
        secs[tag] = 0.0
        for j in range(E):
            src = _save_dir(dataclasses.replace(cfg, job=j + 1))
            jc = dataclasses.replace(cfg, job=j + 1, save_directory=(
                os.path.join(root, "ensemble_" + tag)))
            with np.load(os.path.join(src, f"checkpoint_{n_md - 1:06d}.npz")
                         ) as z:
                epot0 = float(z["epot0"])
            secs[tag] += rewrite_tree(
                jc, {k: v[j] for k, v in outs.items()}, epot0,
                _member_np(final, j), _save_dir(jc), fmt, n_actual=n_js[j])
            same.append(same_trees(src, _save_dir(jc))[0])
        shutil.rmtree(os.path.join(root, "ensemble_" + tag))
    param_dir = os.path.dirname(_save_dir(cfg))
    t0 = time.perf_counter()
    rep = analysis.analyze_ensemble(param_dir)
    t_an = time.perf_counter() - t0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["analyze", param_dir, "--json"])
    log(f"[host] run_ensemble(n0={cfg.n0}, tmax={cfg.tmax:g}, exact_n=False), "
        f"{E} "
        f"members, N={n_js}: {wall:.3f} s with the trees, {wall_bare:.3f} s "
        f"without ({card}); the trees written again: codec "
        f"{secs['codec']:.3f} s, Python %g {secs['python']:.3f} s; byte "
        f"for byte equal to the run's: {all(same)}")
    log(f"[host] analyze_ensemble in {t_an:.3f} s: {len(rep['jobs'])} jobs, "
        f"pooled {sorted(rep['pooled'])}; `analyze --json` rc {rc}")
    for k, v in rep["pooled"].items():
        log(f"[host]   {k}: mean {v['mean']:.6g} sd {v['sd']:.6g} n {v['n']}")
    titles = [t for t, _ in quicklook.collect_panels(
        analysis.job_dirs(param_dir)[0])]
    if not (all(same) and len(same) == 2 * E and rc == 0
            and len(rep["jobs"]) == E and titles == FLAGSHIP_PANELS
            and rep["pooled"]["structure.s_peak"]["n"] == E
            and json.loads(buf.getvalue())["pooled"] == rep["pooled"]):
        raise SystemExit(f"the ensemble's trees or report are wrong: same "
                         f"{same}, rc {rc}, panels {titles}, pooled "
                         f"{rep['pooled']}")


def _template_args(name: str, symbol: str):
    """The template arguments of ``symbol<...>`` in a demangled kernel
    name (``(bool)1`` read as ``true``), or None."""
    i = name.find(symbol + "<")
    if i < 0:
        return None
    args = name[i + len(symbol) + 1:name.index(">", i)].split(",")
    norm = {"(bool)0": "false", "(bool)1": "true"}
    return [norm.get(a.strip(), a.strip()) for a in args]


def trace_path(torch, card):
    """Phase 29: a torch.profiler trace of ~200 MD steps of the flagship
    config; the trace must hold kernels A and B'rng by their CUDA symbol
    names.  Prints the five device operations that took most time and the
    card's busy share of the traced window."""
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, run)
    from mdqtplasmasims_torch.profiling import PhaseTimer, device_trace
    cfg = CoolingConfig(tmax=0.4)
    n_md = int(round(cfg.tmax / cfg.timestep))
    run(CoolingConfig(tmax=0.02), device="cuda")      # warm the path
    timer = PhaseTimer()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp, device="cuda"):
            with timer.phase("run", block_on=torch.zeros(1, device="cuda")):
                run(cfg, device="cuda")
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(os.path.join(tmp, "trace.json"))
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in spans if e.get("cat") in ("kernel", "gpu_memcpy",
                                                "gpu_memset")]
    if not dev:
        raise SystemExit("the trace holds no device activity")
    t_lo = min(e["ts"] for e in spans)
    t_hi = max(e["ts"] + e["dur"] for e in spans)
    busy, end = 0.0, t_lo
    for e in sorted(dev, key=lambda e: e["ts"]):      # union of intervals
        a, b = max(e["ts"], end), e["ts"] + e["dur"]
        if b > a:
            busy += b - a
        end = max(end, b)
    by_name = {}
    for e in dev:
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    kernels = [e["name"] for e in dev if e.get("cat") == "kernel"]
    a_hits = sum(_template_args(k, "yukawa_pair_kernel") == ["false", "false"]
                 for k in kernels)
    b_hits = sum((lambda t: t is not None and t[0] == "12" and t[2:5] == [
        "false", "false", "true"])(_template_args(k, "fused_ticks_kernel"))
        for k in kernels)
    wall_ms = timer.phases["run"] * 1e3
    log(f"[trace] torch.profiler over run(CoolingConfig(tmax={cfg.tmax:g})) "
        f"({n_md} MD steps, {card}): {len(spans)} spans, {len(dev)} device "
        f"operations, trace {size / 2 ** 20:.1f} MiB; window "
        f"{(t_hi - t_lo) / 1e3:.3f} ms, card busy {busy / 1e3:.3f} ms = "
        f"{100 * busy / (t_hi - t_lo):.1f} %; PhaseTimer (block_on) "
        f"{wall_ms:.3f} ms")
    for name, (n, t) in top:
        log(f"[trace]   {t / 1e3:9.3f} ms  x{n:<6d} {name[:110]}")
    log(f"[trace] kernel A (yukawa_pair_kernel<false, false>) events "
        f"{a_hits}, kernel B'rng (fused_ticks_kernel<12, G, false, false, "
        f"true, W>) events {b_hits}")
    if not (a_hits >= n_md and b_hits >= n_md and wall_ms >= busy / 1e3):
        raise SystemExit("the trace lacks kernel A or B'rng, or the "
                         "PhaseTimer read less than the card's busy time")


# ---- a production job uncut (phase 30)

# tests/test_physics_targets.py::TestFullScaleSoak.test_frozen_tagging:
# the pooled compiled-reference tag fraction 0.439-0.447, the sigma+ pump's
# vx > 0 wing, the tau=0 VAF row at the DIH plateau (open intervals)
# (tests/test_torch_smoke_bands.py holds this copy to that test's asserts)
FROZEN_BANDS = dict(tag_fraction=(0.30, 0.55), tagged_vx_at_tag=(0.10, 0.35),
                    tagged_vx2_at_tag=(0.20, 0.45), vaf_tau0=(0.20, 0.45))


def frozen_band_misses(m: dict) -> list:
    """The keys of :data:`FROZEN_BANDS` whose value in ``m`` lies outside
    its open band."""
    return [k for k, (lo, hi) in FROZEN_BANDS.items() if not lo < m[k] < hi]


def production_frozen_path(torch, card, cut):
    """Phase 30: ``tools/torch_soak.py::soak_frozen`` on the card, uncut,
    held to the frozen soak bands and exact launch counts.  With phase
    19's job (``cut``: its wall and MD steps; the same pump window) it
    splits the wall: host ms per MD step (with its share of the blocks and
    the tree) and the seconds left for the pump window's ticks."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import torch_soak
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    with tempfile.TemporaryDirectory() as tmp:
        cfg = torch_soak.frozen_config("422linear",
                                       os.path.join(tmp, "frozen"))
        n_md_a, n_md, segs, _ = ft._phase_b_plan(cfg)
        blocks = len(segs)
        reset_counts()
        m = torch_soak.soak_frozen(tmp, device="cuda")
        counts = read_counts()
        log(f"[production] tools/torch_soak.py frozen: FrozenTagConfig("
            f"422linear, n0={cfg.n0}, tstart={cfg.tstart:g}, tmax="
            f"{cfg.tmax:g}): {n_md} MD steps ({n_md_a} to the tag), {blocks} "
            f"output blocks with the tree in {m['wall_s']:.3f} s -> "
            f"{n_md / m['wall_s']:.1f} MD steps/s ({card})")
        md_ms = 1e3 * (m["wall_s"] - cut["wall"]) / (n_md - cut["n_md"])
        rest = cut["wall"] - cut["n_md"] * md_ms / 1e3
        log(f"[production] against phase 19's cut job ({cut['n_md']} MD "
            f"steps, the same pump window, {cut['wall']:.3f} s): "
            f"{md_ms:.4f} ms per MD step, so the MD steps take "
            f"{n_md * md_ms / 1e3:.3f} s of this job and the pump window's "
            f"ticks and fixed costs {rest:.3f} s")
        log(f"[production] launches: {counts}")
        log("[production] " + ", ".join(
            f"{k} {m[k]:.6g} (band {lo:g} .. {hi:g})"
            for k, (lo, hi) in FROZEN_BANDS.items())
            + f"; tagged vx at the end {m['tagged_vx_final']:.4g}")
        pump_steps, pump_ticks = frozen_pump_steps(torch, cfg)
        log(f"[production] the pump window: {pump_ticks} ticks in "
            f"{pump_steps} launches of the tick kernel")
        want_counts(counts, "the production frozen-tag job",
                    yukawa_forces=n_md + 1,
                    yukawa_forces_potential=blocks + 2,
                    fused_ticks_s5=pump_steps)
        if not (m["n0"] == 3500 and m["tstart"] == 15.0 and m["tmax"] == 25.0
                and not frozen_band_misses(m)):
            raise SystemExit(f"the production frozen-tag job misses the "
                             f"soak bands: {m}")
        f = cfg.sample_freq
        l0 = n_md_a + (f - n_md_a % f) - 1
        _tag_tree(cfg.job_dir(), "VAF.dat", blocks, blocks + 1,
                  [l0 + k * f for k in range(blocks)], n_md_a - 1, n_md - 1)
    return counts, m


CAMPAIGN_CUT = dict(tmax=0.4)     # 200 MD steps, 5 samples, 1 group
CAMPAIGN_PLAIN_REPS = 5           # timings of the E=99 plain versions


def campaign_kernels(torch, cfg, final, E):
    """One launch each of kernels C, B'rng and G at E=99, on the cut
    campaign's final state, against the plain version of the whole launch
    (B'rng in the fold's own lane layout, ``lane0`` 0, so member j draws
    from global lanes j*npad on); timed (device clock, median of
    :data:`N_TIMED`; the plain versions of :data:`CAMPAIGN_PLAIN_REPS`).
    Returns each kernel's readings and bound."""
    from mdqtplasmasims_torch.bridge import states_from_numpy
    from mdqtplasmasims_torch.core import qt_fused as tf
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    from mdqtplasmasims_torch.ops import yukawa as ty
    from mdqtplasmasims_torch.units import PlasmaUnits
    dev = torch.device("cuda")
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    n = cfg.n0
    fold = states_from_numpy(final, device=dev)
    sched = lc.build_scheduler(cfg, dev)
    carry = sched.soa_ens_init(fold)
    npad = carry.R.shape[1] // E
    rows = torch.zeros((1, npad), device=dev)
    rows[0, :n] = 1.0
    on = (torch.arange(E * npad, device=dev) % npad) < n
    out = {}

    # C: the MD step's forces of the whole fold
    force_c = lambda: ty.yukawa_forces_n3l_soa_batched(carry.R, rows, E, L,
                                                       ldeb)
    plain_c = lambda: ty.yukawa_forces_n3l_soa_batched_reference(
        carry.R, rows, E, L, ldeb)
    F, F2, Fr = force_c(), force_c(), plain_c()
    torch.cuda.synchronize()
    scale, err = float(Fr.abs().max()), float((F - Fr).abs().max())
    pads = float(F[:, ~on].abs().max())
    log(f"[campaign99] C, E={E} x {npad} lanes ({n} ions each), the whole "
        f"launch against the plain version: max|F| {scale:.6g}, max abs err "
        f"{err:.3g} (rel {err / scale:.3g}, tol {FORCE_TOL:g}); padded lanes "
        f"{pads:g}")
    if not err <= FORCE_TOL * scale or pads != 0.0:
        raise SystemExit("kernel C at E=99 disagrees with its plain version")
    if not torch.equal(F, F2):
        raise SystemExit("kernel C at E=99 is not deterministic run to run")
    out["C"] = dict(max_abs_err=err, plain=plain_c, fn=force_c,
                    **bound(half_pairs([n] * E) * PAIR_OPS,
                            4 * 7 * E * npad))

    # B'rng: the MD step's 25 ticks of the whole fold, in-kernel draws
    spec = sched.fused_spec
    if not spec.internal_rng:
        raise SystemExit("the campaign's scheduler on CUDA is not B'rng")
    seed = torch.tensor([987654321], dtype=torch.int32, device=dev)
    args = (carry.R, carry.V, F, carry.tp, carry.psi_re, carry.psi_im)
    tick0 = int(carry.tick)
    ticks_b = lambda: tf.fused_md_substeps(spec, False, *args, tick0=tick0,
                                           tables=sched.tables, seed=seed)
    plain_b = lambda: tf.fused_md_substeps_reference(
        spec, False, *args, None, sched.tables, tick0=tick0, seed=seed)
    res, again, ref = ticks_b(), ticks_b(), plain_b()
    torch.cuda.synchronize()
    err = compare_ticks(
        torch, spec, res, ref, on, allowed_lanes(E, spec.ratio),
        f"[campaign99] B'rng, E={E} x {npad} lanes, tick {tick0}, lane0 0, "
        f"the whole launch against the plain version")
    if not all(torch.equal(x, y) for x, y in zip(res, again)):
        raise SystemExit("B'rng at E=99 is not bitwise equal run to run")
    out["B'rng"] = dict(max_abs_err=err, plain=plain_b, fn=ticks_b,
                        **tick_bound(spec, E * n, E * npad))

    # G: a sample's per-ion potentials of every member
    pot_g = lambda: ty.yukawa_forces_potential_pallas_batched(fold.R, L,
                                                              ldeb)
    plain_g = lambda: [ty.yukawa_forces_potential(fold.R[j], L, ldeb)
                       for j in range(E)]
    (Fg, pot), twin = pot_g(), plain_g()
    Fgr = torch.stack([f for f, _ in twin])
    potr = torch.stack([u for _, u in twin])
    eb = ty.yukawa_potential_pallas_batched(fold.R, L, ldeb)
    er = torch.stack([ty.yukawa_potential(fold.R[j], L, ldeb)
                      for j in range(E)])
    torch.cuda.synchronize()
    sf, sp = float(Fgr.abs().max()), float(potr.abs().max())
    ef, ep = float((Fg - Fgr).abs().max()), float((pot - potr).abs().max())
    ee = float(((eb - er) / er).abs().max())
    log(f"[campaign99] G, E={E} x {n} ions, the whole launch against the "
        f"plain version: max|F| {sf:.6g} err {ef:.3g} (tol {FORCE_TOL:g} of "
        f"it), max pot {sp:.6g} err {ep:.3g} (tol {POTENTIAL_TOL:g} of it); "
        f"per-member energy rel err {ee:.3g}")
    if not (ef <= FORCE_TOL * sf and ep <= POTENTIAL_TOL * sp
            and ee <= POTENTIAL_TOL):
        raise SystemExit("kernel G at E=99 disagrees with its plain version")
    out["G"] = dict(max_abs_err=max(ef / sf, ep / sp), plain=plain_g,
                    fn=pot_g,
                    **bound(half_pairs([n] * E) * (PAIR_OPS + POT_OPS),
                            4 * 8 * E * (-(-n // 512) * 512)))

    for name, k in out.items():
        k["ms"], k["idle_card_ms"] = kernel_ms(torch, k.pop("fn"))
        k["plain_ms"] = cuda_ms(torch, k.pop("plain"),
                                reps=CAMPAIGN_PLAIN_REPS)
        log(f"[campaign99] {name} at E={E}: kernel "
            f"{both(k['ms'], k['idle_card_ms'])}, bound {k['bound_ms']:.5f} "
            f"ms ({k['bound_by']}; {100 * k['bound_ms'] / k['ms']:.1f} % of "
            f"it), plain {k['plain_ms']:.4f} ms (median of {N_TIMED} / "
            f"{CAMPAIGN_PLAIN_REPS})")
    return out


def campaign_path(torch, card):
    """Phase 31: the reference's 99-job campaign through
    ``tools/torch_campaign99.py``, cut to :data:`CAMPAIGN_CUT`: the
    launches of C, B'rng and G exact, the run twice bitwise equal, the
    members' final EkinX all distinct; then :func:`campaign_kernels`.
    Returns ``(counts, kernels)``."""
    import warnings
    import numpy as np
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import torch_campaign99 as tc
    cfg = tc.campaign_config(**CAMPAIGN_CUT)
    E = tc.N_JOBS
    n_md = int(round(cfg.tmax / cfg.timestep))
    samples = n_md // cfg.sample_freq
    runs = []
    for _ in range(2):
        with warnings.catch_warnings():
            # no sample at t >= 25: the cooling ratio is a mean of none
            warnings.simplefilter("ignore", RuntimeWarning)
            runs.append(tc.campaign_run("cuda", E, **CAMPAIGN_CUT))
    (m, final, outs), (m2, final2, outs2) = runs
    counts = {k: m["launches"].get(k, 0) for k in read_counts()}
    log(f"[campaign99] tools/torch_campaign99.py campaign(tmax="
        f"{cfg.tmax:g}): {E} jobs x {cfg.n0} ions, {n_md} MD steps, "
        f"{samples} samples: wall {m['wall_s']:.3f} s and {m2['wall_s']:.3f} "
        f"s, {m['agg_updates_per_s']:.4g} ion-QT-updates/s, peak memory "
        f"{m['max_memory_allocated'] / 2**30:.2f} GiB ({card})")
    log(f"[campaign99] {tc.campaign_line(m)}")
    log(f"[campaign99] launches: {m['launches']}")
    want = dict(yukawa_forces_batched=n_md, fused_ticks_rng=n_md + samples,
                yukawa_forces_potential_batched=samples + 1)
    want_counts(counts, "the cut campaign", **want)
    if m2["launches"] != m["launches"]:
        raise SystemExit(f"the second cut campaign launched "
                         f"{m2['launches']}")
    if outs["ekin"].shape != (E, samples, 3) or not all(
            np_isfinite(v) for v in outs.values()):
        raise SystemExit(f"the cut campaign's outputs: ekin "
                         f"{outs['ekin'].shape}, or non-finite values")
    same = [k for k in outs if np.array_equal(outs[k], outs2[k])]
    same += [k for k in ("R", "V", "psi", "t_part")
             if np.array_equal(getattr(final, k), getattr(final2, k))]
    if len(same) != len(outs) + 4:
        raise SystemExit(f"the cut campaign is not bitwise equal run to "
                         f"run: equal only {same}")
    ek = outs["ekin"][:, :, 0]
    distinct = len(set(ek[:, -1].tolist()))
    log(f"[campaign99] bitwise equal run to run ({len(same)} arrays); "
        f"final EkinX of the {E} members: {distinct} distinct, "
        f"{ek[:, -1].min():.5g} .. {ek[:, -1].max():.5g}")
    if distinct != E or not (ek[:, -1] > ek[:, 0]).all():
        raise SystemExit("the campaign's members coincide, or a member's "
                         "EkinX did not rise from the frozen start")
    return counts, campaign_kernels(torch, cfg, final, E)


# ---- the analysis layer's tools (phase 32)

# tools/torch_validate_analysis.py at --fast sizes (N=216, 1200 recording
# steps, 6000 Metropolis steps), sections A, C, D: the Gamma=3 trajectory
# and the Gamma=50 one (2400 recording steps)
VALIDATE_CUT = ["--fast", "--sections", "ACD", "--skip-e"]
# tools/torch_lccf_dispersion.py's laser-free flagship cut to tmax=12
# (6000 MD steps, 150 samples), the first 4 omega_E^-1 dropped
LCCF_CUT = ["--n0", "1024", "--tmax", "12", "--skip-time", "4"]
A_SHAPES_MC = 2000        # Metropolis steps behind phase 32's kernel-A inputs


def _all_finite(x) -> bool:
    """Every number in a nested report is finite."""
    import math
    if isinstance(x, dict):
        return all(_all_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_all_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def chain_start_ions(torch, n: int):
    """``n`` ions of a lattice after :data:`A_SHAPES_MC` Metropolis steps at
    Gamma=3, kappa=0.5 (``tools/torch_validate_analysis.py::chain_start``):
    the validation trajectories' start, ``(R [n, 3] on the card, L,
    lambda_D)``."""
    import torch_validate_analysis as tva
    from mdqtplasmasims_torch.core.draws import MemberDraws
    from mdqtplasmasims_torch.units import PlasmaUnits
    dev = torch.device("cuda")
    R, _ = tva.chain_start(n, tva.GAMMA_A, tva.KAPPA_A, A_SHAPES_MC,
                           MemberDraws([torch.Generator(device=dev)
                                        .manual_seed(n)]), dev,
                           torch.float32)
    return R, PlasmaUnits.box_length(n), 1.0 / tva.KAPPA_A


def analysis_tools_path(torch, card):
    """Phase 32: the analysis layer's tools on the card.
    ``tools/torch_validate_analysis.py`` at :data:`VALIDATE_CUT` (its
    trajectories: kernel A once per MD step + once a trajectory, nothing
    else; every key of the JAX record's sections A, C, D present and every
    number finite), then ``tools/torch_lccf_dispersion.py``'s laser-free
    flagship at :data:`LCCF_CUT` (its scheme's coupling all zero, B'rng
    the only tick form; A once per MD step, B'rng once per MD step + once
    per sample, D once per sample + 1; the JAX tool's keys, every number
    finite), then kernel A at N=216 and N=512 against its plain version
    (:func:`check_force_kernel` on :func:`chain_start_ions`).  Returns
    ``(counts of each tool, kernel A's readings by N)``."""
    import numpy as np
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import torch_lccf_dispersion as tld
    import torch_validate_analysis as tva
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    counts = {}
    with open(tva.JAX_REPORT) as f:
        jax_rep = json.load(f)
    with tempfile.TemporaryDirectory() as work:
        args = tva.parse_args(VALIDATE_CUT + ["--work-dir", work, "--out",
                                              work])
        plan = tva.trajectory_plan(args)
        n_md = sum(1 + kw["equil_steps"] + kw["record_steps"]
                   for kw in plan.values())
        reset_counts()
        rep = tva.run(args)
        counts["validate_analysis"] = read_counts()
        log(f"[analysis-tools] tools/torch_validate_analysis.py "
            f"{' '.join(VALIDATE_CUT)}: {rep['wall_s']:.2f} s ({card}); "
            f"walls {rep['section_walls_s']}; trajectories "
            + "; ".join(f"Gamma={t['gamma']:g} kappa={t['kappa']:g} "
                        f"{t['record_steps']} steps {t['wall_s']:.2f} s"
                        for t in rep["trajectories"]))
        log(f"[analysis-tools] A ratio {rep['A_gk_vs_msd']['ratio']:.4f}, "
            f"C max|dS| {rep['C_sk_gofr']['max_abs_err']:.4f}, D ratios "
            f"{[round(r['ratio'], 3) for r in rep['D_dispersion']['rows']]}"
            f", Gamma=50 shear {rep['D_dispersion']['gamma50_shear']}; ok "
            f"{rep['ok']} (the --fast sizes are not the recorded bands)")
        want_counts(counts["validate_analysis"],
                    "the validation's trajectories",
                    yukawa_forces=n_md)
        missing = [f"{s}.{k}" for s in ("A_gk_vs_msd", "C_sk_gofr",
                                        "D_dispersion")
                   for k in jax_rep[s] if k not in rep.get(s, {})]
        if missing or not _all_finite(rep) or rep["dtype"] != "float32":
            raise SystemExit(f"the validation's report: missing {missing}, "
                             f"or a number not finite, or dtype "
                             f"{rep['dtype']}")

        largs = tld.parse_args(LCCF_CUT + ["--out", os.path.join(work,
                                                                 "lccf")])
        cfg = tld.lccf_config(largs)
        spec = lc.build_scheduler(cfg, "cuda").fused_spec
        if np.count_nonzero(spec.scheme.coupling) or not spec.internal_rng:
            raise SystemExit("the laser-free flagship's tick kernel is not "
                             "B'rng with a zero coupling")
        n_md = int(round(cfg.tmax / cfg.timestep))
        samples = n_md // cfg.sample_freq
        reset_counts()
        job, wall, launches = tld.run_flagship(cfg, "cuda")
        counts["lccf"] = read_counts()
        disp = tld.dispersion(job, cfg, largs, wall)
        log(f"[analysis-tools] tools/torch_lccf_dispersion.py "
            f"{' '.join(LCCF_CUT)}: {n_md} MD steps, {samples} samples in "
            f"{wall:.3f} s ({card}); {len(disp['rows'])} shells, d_omega "
            f"{disp['d_omega']:.4f}, lowest four ratios "
            f"{[round(float(r['ratio']), 3) for r in disp['rows'][:4]]}; "
            f"launches "
            f"{launches}")
        want_counts(counts["lccf"], "the laser-free flagship",
                    yukawa_forces=n_md, fused_ticks_rng=n_md + samples,
                    yukawa_forces_potential=samples + 1)
        if not ({"n0", "tmax", "kappa", "d_omega", "wall_s", "rows"}
                <= set(disp) and disp["rows"] and _all_finite(disp)):
            raise SystemExit(f"the dispersion's keys or numbers: {disp}")
    return counts, {n: check_force_kernel(torch, *chain_start_ions(torch, n),
                                          tag=f"[analysis-tools] N={n}")
                    for n in (216, 512)}


# ---- the JAX package's physics targets and its examples (phase 33)

def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def cooling_fold_counts(cfg, form: str) -> dict:
    """The launches of a laser-cooling fold (``run`` or ``run_sweep``):
    the force kernel once per MD step, the tick kernel's ``form`` once
    per MD step and once per sample, the potential kernel once per sample
    and once at the start."""
    n_md = int(round(cfg.tmax / cfg.timestep))
    samples = n_md // cfg.sample_freq
    batched = "_batched" if "per_lane" in form else ""
    return {f"yukawa_forces{batched}": n_md, form: n_md + samples,
            f"yukawa_forces_potential{batched}": samples + 1}


def frozen_sweep_counts(torch, cfg) -> dict:
    """The launches of a frozen-tag ``run_sweep`` over detunings (kernel
    C once per MD step and once at the start, G twice plus once per
    output block, B's S = 5 per-lane e0 form once per MD step of the pump
    window)."""
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    _, n_md, segs, _ = ft._phase_b_plan(cfg)
    return dict(yukawa_forces_batched=n_md + 1,
                yukawa_forces_potential_batched=len(segs) + 2,
                fused_ticks_s5_per_lane_e0=frozen_pump_steps(torch, cfg)[0])


def archived_dip_run(tpt, work_dir: str, name: str) -> bool:
    """Whether the dip run in ``work_dir/name`` wrote, byte for byte, the
    population files archived under ``artifacts/physics_targets_torch/
    <name>/``: the run whose JAX asserts tier-1's archive test reads."""
    job, = glob.glob(os.path.join(work_dir, name, "*", "job1"))
    files = tpt.dip_files(job)
    kept = sorted(glob.glob(os.path.join(tpt.OUT, name, "*.dat")))
    if [os.path.basename(f) for f in files] != [os.path.basename(f)
                                                 for f in kept]:
        return False
    for f, k in zip(files, kept):
        with open(f, "rb") as x, open(k, "rb") as y:
            if x.read() != y.read():
                return False
    return True


def physics_targets_path(torch, card):
    """Phase 33: ``tools/torch_physics_targets.py``'s ``run_targets`` at
    full size, each target's launches held exactly and the report to
    every JAX assert (``report_misses``), then the three examples at full
    size held to their launches and their physics (``physics_misses``).
    Every miss raises but one kind: a dip run that wrote, byte for byte,
    the archived population files is the archived run, whose misses are
    tier-1's (tests/test_torch_physics_targets.py::
    test_archived_dark_state_dip_tracks_detuning); any other run of a dip
    case, the port's output changed in any bit, is held to the JAX asserts
    here.  Returns the launches of the targets and of the examples,
    summed by form."""
    import math
    from mdqtplasmasims_torch.experiments.frozen_tagging import (
        FrozenTagConfig)
    from mdqtplasmasims_torch.experiments.laser_cooling import CoolingConfig
    root = os.path.dirname(os.path.abspath(__file__))
    for d in ("tools", "examples"):
        sys.path.insert(0, os.path.join(root, d))
    import torch_dark_state_sweep
    import torch_physics_targets as tpt
    import torch_rabi_sweep
    import torch_tag_class_sweep
    targets, examples = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rep = tpt.run_targets("cuda", tmp)
        log(f"[targets] run_targets: {time.perf_counter() - t0:.3f} s "
            f"({card}); walls {rep['walls_s']}")
        n_dih, n_budget = tpt.DIH_RUN[1], tpt.DIH_BUDGET[1]
        sections = [
            ("DIH", rep["dih"], dict(yukawa_forces=n_dih)),
            ("budget float32", rep["dih_budget"]["f32"],
             dict(yukawa_forces=n_budget)),
            ("budget float64 (plain: the reference)",
             rep["dih_budget"]["f64"], {}),
            ("EIT", rep["eit"], dict(fused_ticks=math.ceil(
                tpt.EIT_TICKS / tpt.EIT_CHUNK))),
            *((name, d, cooling_fold_counts(tpt.dip_config(
                d["det_sp"], d["det_dp"], tmp), "fused_ticks_rng"))
              for name, d in rep["dip"].items()),
            ("tagged class", rep["tagged"], frozen_sweep_counts(
                torch, FrozenTagConfig(**tpt.TAG_CONFIG)))]
        for what, sec, want in sections:
            log(f"[targets] {what}: {sec['wall_s']:.3f} s; launches "
                f"{sec['launches']}")
            # every counter, the ones the report leaves out at 0
            counts = dict.fromkeys(read_counts(), 0) | sec["launches"]
            want_counts(counts, what, **want)
            add_counts(targets, counts)
        log(f"[targets] DIH {tpt.dih_values(rep['dih']['T'])}; budget "
            f"early {rep['dih_budget']['early']:.3g}, late "
            f"{rep['dih_budget']['late']:.3g}")
        log(f"[targets] EIT P {rep['eit']['pop_p']}, D {rep['eit']['pop_d']}"
            f", vx fixed {rep['eit']['v_fixed']}")
        for name, d in rep["dip"].items():
            log(f"[targets] {name}: v_res {d['v_res']:.4f}, v_dip "
                f"{d['v_dip']}, window {d['window']} bins, "
                f"{len(d['files'])} files of {sum(d['file_bytes'])} B")
        vx = tpt.tagged_vx(rep["tagged"]["rows"])
        log(f"[targets] tagged <vx> {vx}, spin-up "
            f"{[round(r['mean'], 4) for r in rep['tagged']['spin_up']]}")
        archived = {name for name in rep["dip"]
                    if archived_dip_run(tpt, tmp, name)}
        misses = tpt.report_misses(rep)
        held = [m for m in misses if m.split(": ", 1)[0] in archived]
        log(f"[targets] dip runs equal to the archived run, byte for byte: "
            f"{sorted(archived)}; their misses, tier-1's archive test's: "
            f"{held}")
        faults = [m for m in misses if m not in held]
        if faults:
            raise SystemExit(f"phase 33: the targets miss {faults}")
        for mod, out, cfg in (
                (torch_dark_state_sweep, os.path.join(tmp, "dark"),
                 cooling_fold_counts(CoolingConfig(
                     **torch_dark_state_sweep.CONFIG),
                     "fused_ticks_rng_per_lane_e0")),
                (torch_rabi_sweep, None, cooling_fold_counts(CoolingConfig(
                    **torch_rabi_sweep.CONFIG),
                    "fused_ticks_rng_per_lane_om")),
                (torch_tag_class_sweep, None, frozen_sweep_counts(
                    torch, FrozenTagConfig(**torch_tag_class_sweep.CONFIG)))):
            name = mod.__name__
            reset_counts()
            t0 = time.perf_counter()
            table = mod.main(out, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            log(f"[examples] {name}: {wall:.3f} s ({card}); launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            want_counts(counts, name, **cfg)
            add_counts(examples, counts)
            log(f"[examples] {name}: " + "; ".join(
                ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else
                          f"{k} {v}" for k, v in r.items()
                          if k not in ("centers", "profile"))
                for r in table["rows"]))
            if mod.physics_misses(table):
                raise SystemExit(f"phase 33: {name} misses its physics: "
                                 f"{mod.physics_misses(table)}")
    return targets, examples


# phase 34: the frozen fold (TAG_CUT, N0 = 3500) and the 4 x 1 cooling mesh
# of 8 jobs (N0 = 3500), cut
MESH_CARDS_FROZEN = dict(n0=3500, **TAG_CUT)
MESH_CARDS_COOL = dict(n0=3500, tmax=0.2)


@contextlib.contextmanager
def slot_workers():
    """``member_sharded`` in its multi-card form (a worker process a slot)
    on slots that all lie on one card."""
    from mdqtplasmasims_torch.parallel import ensemble as pe
    orig = pe.mesh_is_multi_card
    pe.mesh_is_multi_card = lambda mesh: True
    try:
        yield
    finally:
        pe.mesh_is_multi_card = orig


def mesh_cards_path(torch, card):
    """Phase 34: the mesh of ``tools/torch_mesh_cards.py`` with every slot
    on cuda:0: the frozen fold of 8 through ``member_sharded``'s slot
    workers (its form on several cards) bitwise equal to the same fold in
    turn, each with 4x the unsharded fold's launches; the 4 x 1 cooling
    mesh of 8 jobs bitwise equal to
    the unsharded fold of 8, exact launches.  Returns the launches of the
    phase, summed by form."""
    from mdqtplasmasims_torch.experiments import frozen_tagging as ft
    from mdqtplasmasims_torch.experiments.laser_cooling import (
        CoolingConfig, run_ensemble)
    from mdqtplasmasims_torch.parallel.ensemble import (start_workers,
                                                        stop_workers)
    from mdqtplasmasims_torch.parallel.mesh import make_mesh
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tools"))
    import torch_mesh_cards as tmc
    dev = torch.device("cuda", 0)
    total = {}
    cfg = ft.FrozenTagConfig(**MESH_CARDS_FROZEN)
    mesh = make_mesh(4, 1, devices=[dev] * 4)
    with slot_workers():
        log(f"[mesh-cards] four slot workers on {dev} started in "
            f"{start_workers(mesh):.3f} s")
    runs = {}
    for name, kw, ctx in (
            ("fold", dict(device=dev), contextlib.nullcontext()),
            ("workers", dict(mesh=mesh), slot_workers()),
            ("in turn", dict(mesh=mesh), contextlib.nullcontext())):
        reset_counts()
        with ctx:
            res, wall = _synced_wall(torch, lambda: ft.run_ensemble(
                cfg, 8, seed=5, **kw))
        runs[name] = (res, read_counts())
        log(f"[mesh-cards] frozen fold of 8 ({MESH_CARDS_FROZEN}), {name}: "
            f"{wall:.3f} s ({card}); launches "
            f"{ {k: v for k, v in runs[name][1].items() if v} }")
        add_counts(total, runs[name][1])
    stop_workers()
    fold_counts = runs["fold"][1]
    same = tmc.same(runs["workers"][0], runs["in turn"][0])
    log(f"[mesh-cards] frozen 4 x 1 in the slots' worker processes vs in "
        f"turn: bitwise equal {same}; vs the unsharded fold of 8: "
        f"{tmc.same(runs['in turn'][0], runs['fold'][0])}")
    if not same:
        raise SystemExit("phase 34: the frozen fold over 4 slots in worker "
                         "processes differs from the same fold in turn")
    for name in ("workers", "in turn"):
        want_counts(runs[name][1], f"the frozen fold over 4 slots ({name})",
                    **{k: 4 * v for k, v in fold_counts.items() if v})
    c = CoolingConfig(**MESH_CARDS_COOL)
    n_md = int(round(c.tmax / c.timestep))
    segs = n_md // c.sample_freq
    cool = {}
    for name, kw, k in (("fold", dict(device=dev), 1),
                        ("4 x 1", dict(mesh=mesh), 4)):
        reset_counts()
        res, wall = _synced_wall(torch, lambda: run_ensemble(
            c, 8, seed=5, **kw))
        counts = read_counts()
        log(f"[mesh-cards] cooling {name} of 8 ({MESH_CARDS_COOL}): "
            f"{wall:.3f} s ({card}); launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        want_counts(counts, f"the cooling {name} of 8",
                    yukawa_forces_batched=k * n_md,
                    fused_ticks_rng=k * (n_md + segs),
                    yukawa_forces_potential_batched=segs + 1)
        add_counts(total, counts)
        cool[name] = tmc._final_and_outs(res)
    same = tmc.same(cool["4 x 1"], cool["fold"])
    log(f"[mesh-cards] cooling 4 x 1 vs the unsharded fold of 8: final "
        f"states and samples bitwise equal {same}")
    if not same:
        raise SystemExit("phase 34: the cooling 4 x 1 mesh differs from the "
                         "unsharded fold")
    return total


def glob_all(root, name):
    return [os.path.join(d, name) for d, _, fs in os.walk(root) if name in fs]


def np_isfinite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(np.asarray(a)).all())


# instantiations of the tick kernel: the group kernel at S = 12 in four
# per-lane forms with and without the RNG, each with short and long rows
# (16), and the ion kernel's four per-lane forms of each compiled coupling
# pattern (24: one at S = 3, two at S = 5, three at S = 7)
TICK_FORMS = 40


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
    for line in _build.build_log("yukawa_forces").splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log(f"[build] yukawa_forces: {line.strip()}")
    forms = kernel_resources()
    for (S, pat, pe0, pom, rng, long_rows), res in sorted(forms.items()):
        log(f"[build] fused_ticks S={S}{' ' + pat if pat else ''} "
            f"per_lane_e0={pe0:d} per_lane_om={pom:d} internal_rng={rng:d} "
            f"long_rows={long_rows:d}: "
            f"{res['registers']} registers, {res['spill_stores']} / "
            f"{res['spill_loads']} B spill stores / loads, {res['stack']} B "
            f"stack")
    spilled = {k: v for k, v in forms.items()
               if v["spill_stores"] or v["spill_loads"]}
    if len(forms) != TICK_FORMS or spilled:
        raise SystemExit(f"the tick kernel's nvcc log lists {len(forms)} of "
                         f"{TICK_FORMS} forms; forms that spill: {spilled}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    from mdqtplasmasims_torch.units import PlasmaUnits

    # IEEE float32 for the plain versions too (the kernels use no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mdqtplasmasims_torch.profiling import card_name
    smi = card_name("cuda")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"[env] card: {smi}")
    build_kernels(torch)
    count_plain_ticks()

    cfg = lc.CoolingConfig()
    pu = PlasmaUnits(cfg.density, cfg.ge)
    L = PlasmaUnits.box_length(cfg.n0)
    log(f"[config] N0={cfg.n0} L={L:.6f} lambda_D={pu.debye_length:.6f} "
        f"ratio={cfg.ratio} qdt={cfg.qdt:g}")
    force = check_force_kernel(torch, random_ions(torch, 3500, L), L,
                               pu.debye_length)
    ticks = check_tick_kernel(torch, cfg, L, pu.debye_length)
    small = check_small_tick_kernels(torch)
    check_ion_sass()
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
    cols = check_cols_kernel(torch, L, pu.debye_length)
    cross = check_cross_kernel(torch, L, pu.debye_length)
    mesh_counts = mesh_path(torch, smi, L, pu.debye_length)
    check_fold_force_entry(torch, L, pu.debye_length)
    tag_counts, tag_cut = frozen_tag_path(torch, smi)
    fold_counts, fold_info = frozen_fold_path(torch, smi)
    f408_counts = frozen_408_path(torch, smi)
    ts_launched, _ = three_state_path(torch, smi)
    t_mc = time.perf_counter()
    mc_ms = metropolis_path(torch, smi)
    tr_counts, tr_walls = transport_path(torch, smi)
    mt_counts, mt_fold_counts, mt_info = mc_tag_path(torch, smi)
    mc_projections(smi, mc_ms, tr_walls["md_ms"],
                   {E: pump_step_ms(torch, E) for E in (1, 8)})
    sweep_tr_counts = transport_sweep_path(torch, smi)
    log(f"[env] phases 23-26 (the Monte-Carlo families) took "
        f"{time.perf_counter() - t_mc:.1f} s")
    t_host = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        trees, preset_counts = presets_path(torch, smi, root)
        host_tools_path(torch, smi, trees, root)
    trace_path(torch, smi)
    log(f"[env] phases 27-29 (presets, codec, host tools, trace) took "
        f"{time.perf_counter() - t_host:.1f} s")
    t_prod = time.perf_counter()
    prod_counts, _ = production_frozen_path(torch, smi, tag_cut)
    log(f"[env] phase 30 (the production frozen-tag job) took "
        f"{time.perf_counter() - t_prod:.1f} s")
    t_camp = time.perf_counter()
    camp_counts, camp = campaign_path(torch, smi)
    log(f"[env] phase 31 (the 99-job campaign cut to tmax="
        f"{CAMPAIGN_CUT['tmax']:g}) took {time.perf_counter() - t_camp:.1f} s")
    t_tools = time.perf_counter()
    tool_counts, force_md = analysis_tools_path(torch, smi)
    log(f"[env] phase 32 (the analysis layer's tools) took "
        f"{time.perf_counter() - t_tools:.1f} s")
    val_counts, lccf_counts = (tool_counts["validate_analysis"],
                               tool_counts["lccf"])
    t_targets = time.perf_counter()
    target_counts, example_counts = physics_targets_path(torch, smi)
    log(f"[env] phase 33 (the physics targets and the examples) took "
        f"{time.perf_counter() - t_targets:.1f} s")
    t_mesh = time.perf_counter()
    mesh_cards_counts = mesh_cards_path(torch, smi)
    log(f"[env] phase 34 (the mesh on distinct cards, its slots on this "
        f"card) took {time.perf_counter() - t_mesh:.1f} s")

    log(f"[env] card: {smi}")
    src_f = "mdqtplasmasims_torch/csrc/yukawa_forces.cu"
    src_t = "mdqtplasmasims_torch/csrc/fused_ticks.cu"
    tpu_t = "mdqtplasmasims_tpu/core/qt_fused.py:93"
    tpu_rng = "mdqtplasmasims_tpu/core/qt_fused.py:111"
    kernels = [
        dict(name="yukawa_forces", route="cuda", source=src_f,
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:302",
             launches=counts["yukawa_forces"],
             launches_frozen_tag=tag_counts["yukawa_forces"],
             launches_transport=tr_counts["yukawa_forces"],
             launches_mc_tag=mt_counts["yukawa_forces"],
             launches_pre_speedup=preset_counts["yukawa_forces"],
             launches_frozen_production=prod_counts["yukawa_forces"],
             launches_validate_analysis=val_counts["yukawa_forces"],
             launches_lccf=lccf_counts["yukawa_forces"],
             n216=force_md[216], n512=force_md[512], **force),
        dict(name="yukawa_forces_batched", route="cuda", source=src_f,
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:411",
             launches=ens_counts["yukawa_forces_batched"],
             launches_frozen_tag_fold=fold_counts["yukawa_forces_batched"],
             launches_mc_tag_fold=mt_fold_counts["yukawa_forces_batched"],
             launches_transport_sweep=sweep_tr_counts[
                 "yukawa_forces_batched"],
             launches_campaign99=camp_counts["yukawa_forces_batched"],
             e99=camp["C"], **force_e),
        dict(name="yukawa_forces_potential", route="cuda", source=src_f,
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:147",
             launches=counts["yukawa_forces_potential"],
             launches_frozen_tag=tag_counts["yukawa_forces_potential"],
             launches_pre_speedup=preset_counts["yukawa_forces_potential"],
             launches_frozen_production=prod_counts[
                 "yukawa_forces_potential"],
             launches_lccf=lccf_counts["yukawa_forces_potential"],
             **pot_d),
        dict(name="yukawa_forces_potential_batched", route="cuda",
             source=src_f, replaces="mdqtplasmasims_tpu/ops/yukawa.py:166",
             launches=ens_counts["yukawa_forces_potential_batched"],
             launches_frozen_tag_fold=fold_counts[
                 "yukawa_forces_potential_batched"],
             launches_campaign99=camp_counts[
                 "yukawa_forces_potential_batched"],
             e99=camp["G"], **pot_g),
        dict(name="fused_ticks_rng", route="cuda", source=src_t,
             replaces=tpu_rng, launches=counts["fused_ticks_rng"],
             launches_pre_speedup=preset_counts["fused_ticks_rng"],
             launches_campaign99=camp_counts["fused_ticks_rng"],
             launches_lccf=lccf_counts["fused_ticks_rng"],
             e99=camp["B'rng"], **rng["fused_ticks_rng"]),
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
        dict(name="fused_ticks_s3", route="cuda", source=src_t,
             replaces=tpu_t, launches=ts_launched["run"],
             launches_three_state_fold=ts_launched["run_ensemble(8)"],
             **small["fused_ticks_s3"]),
        dict(name="fused_ticks_s3_per_lane_e0", route="cuda", source=src_t,
             replaces=tpu_t, launches=ts_launched["run_sweep(detuning)"],
             **small["fused_ticks_s3_per_lane_e0"]),
        dict(name="fused_ticks_s3_per_lane_om", route="cuda", source=src_t,
             replaces=tpu_t, launches=ts_launched["run_sweep(om)"],
             **small["fused_ticks_s3_per_lane_om"]),
        dict(name="fused_ticks_s3_per_lane_e0_om", route="cuda",
             source=src_t, replaces=tpu_t,
             launches=ts_launched["run_sweep(2x2)"],
             **small["fused_ticks_s3_per_lane_e0_om"]),
        dict(name="fused_ticks_s5", route="cuda", source=src_t,
             replaces=tpu_t, launches=tag_counts["fused_ticks_s5"],
             launches_frozen_tag_fold=fold_counts["fused_ticks_s5"],
             launches_frozen_production=prod_counts["fused_ticks_s5"],
             **small["fused_ticks_s5"]),
        *(dict(name=f"fused_ticks_s5_per_lane_{f}", route="cuda",
               source=src_t, replaces=tpu_t,
               launches=fold_info["sweeps"][f][
                   f"fused_ticks_s5_per_lane_{f}"],
               **small[f"fused_ticks_s5_per_lane_{f}"])
          for f in ("e0", "om", "e0_om")),
        dict(name="fused_ticks_s7", route="cuda", source=src_t,
             replaces=tpu_t, launches=mt_counts["fused_ticks_s7"],
             launches_mc_tag_fold=mt_fold_counts["fused_ticks_s7"],
             launches_frozen_408quad=f408_counts["fused_ticks_s7"],
             **small["fused_ticks_s7"]),
        *(dict(name=f"fused_ticks_s7_per_lane_{f}", route="cuda",
               source=src_t, replaces=tpu_t,
               launches=mt_info["sweeps"][f][f"fused_ticks_s7_per_lane_{f}"],
               **small[f"fused_ticks_s7_per_lane_{f}"])
          for f in ("e0", "om", "e0_om")),
        dict(name="yukawa_forces_cols", route="cuda", source=src_f,
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:538",
             launches=mesh_counts["gather"]["yukawa_forces_cols"], **cols),
        dict(name="yukawa_forces_cross", route="cuda", source=src_f,
             replaces="mdqtplasmasims_tpu/ops/yukawa.py:616",
             launches=mesh_counts["ring_n3l"]["yukawa_forces_cross"],
             **cross),
    ]
    for k in kernels:
        for key, counts in (("launches_physics_targets", target_counts),
                            ("launches_examples", example_counts),
                            ("launches_mesh_cards", mesh_cards_counts)):
            if counts.get(k["name"]):
                k[key] = counts[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
