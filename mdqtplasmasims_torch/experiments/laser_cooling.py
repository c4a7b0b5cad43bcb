"""Flagship experiment: MDQT laser cooling + expansion of a Sr+ Yukawa OCP.

Counterpart of ``mdqtplasmasims_tpu/experiments/laser_cooling.py`` (the
reference's laserCoolingPlusExpansionMDQTSpeedUp.cpp: N0=3500, Ge=0.1,
density=2, tmax=30, the 12-level S/P/D scheme with S->P cooling and D->P
repump lasers along x, in a self-similarly expanding frame).

The run is a host loop over output segments, each ``sample_freq`` MD
steps in the kernels' lane layout (core/scheduler.py).  Samples are taken
at the reference's instant, one quantum tick into the segment's last MD
step (SpeedUp.cpp:1365-1368): that step is split [forces; 1 tick] ->
sample -> [ratio-1 ticks, same forces], so sample k lands at
t = ((k*sampleFreq-1)*ratio+1)*qdt.  The observables are computed on the
device and stacked; the host fetches them once per checkpoint group and
writes the reference-schema .dat files.

:func:`run_ensemble` runs E independent trajectories (the reference's
SLURM job array) as one fold: one batched force launch and one tick
launch per MD step serve all members.  :func:`run_sweep` makes the members
a laser-parameter grid (per-lane detunings and Rabi frequencies) in the
same fold.  Both write each member's tree into its own job directory.

Randomness: explicit ``torch.Generator`` objects.  A single run draws its
start and then its uniforms from one generator seeded with ``seed``
(default ``cfg.job``).  An ensemble's member j starts from a generator
seeded with :func:`member_seed` ``(seed, j)`` and the fold's uniforms come
from one generator seeded with :func:`fold_seed` ``(seed)``.  Every native
checkpoint carries the generator's state under ``torch_rng_state`` (never
under the JAX package's ``key``); a checkpoint without it (the JAX
package's, or an ASCII one) reseeds with ``job*7919 + c0`` as the JAX
package does.

Not ported yet: the interval diagnostics (``record_snapshots``,
``vaf_intervals``, ``record_lccf``), multi-device ``mesh`` runs, float64
on CUDA.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from mdqtplasmasims_tpu.io import checkpoint as ckpt
from mdqtplasmasims_tpu.io.datfiles import DatWriter
from mdqtplasmasims_tpu.io.dirs import cooling_dir
from mdqtplasmasims_tpu.levels import sr12_cooling, with_recoil
from mdqtplasmasims_tpu.units import (PlasmaUnits, QTUnits, VKICK_408_QUANTUM,
                                      K_RATIO_1033, qt_units_408)

from ..bridge import NumpyState, state_to_numpy, states_from_numpy
from ..core.init import frozen_gas_init, poisson_member_mask
from ..core.md import kinetic_energies
from ..core.qt import QTEngine, state_populations
from ..core.qt_fused import FusedTickSpec
from ..core.scheduler import (CoolingScheduler, auto_qt_tile,
                              check_uniform_tick, fold_sweep_lanes,
                              uniform_rolls)
from ..ops.kde import folded_bins, folded_bins_np, gaussian_kde
from ..ops.yukawa import yukawa_potential
from ..state import SimState, make_state

S_MANIFOLD = (0, 1)
P_MANIFOLD = (2, 3, 4, 5)
D_MANIFOLD = (6, 7, 8, 9, 10, 11)


@dataclasses.dataclass(frozen=True)
class CoolingConfig:
    """User inputs of the reference (README.md:40-55; SpeedUp.cpp:56-108)."""

    ge: float = 0.1
    density: float = 2.0          # units of 1e14 m^-3
    sig0: float = 4.0             # initial cloud width, mm
    te: float = 19.0              # electron temperature, K
    frac_of_sig: float = 0.0      # chunk position in units of sigma
    n0: int = 3500
    detuning: float = -1.0        # SP detuning / gamma_SP
    detuning_dp: float = 1.0      # DP detuning / gamma_SP
    om: float = 1.0               # SP Rabi freq / gamma_SP
    om_dp: float = 1.0            # DP Rabi freq / gamma_SP
    tmax: float = 30.0
    timestep: float = 0.002
    sample_freq: int = 40
    renormalize: bool = False
    # "speedup" or "pre_speedup" physics generation (levels.sr12_cooling)
    physics: str = "speedup"
    job: int = 1
    exact_n: bool = True          # pin N = n0 (False: Poissonian, as reference)
    dtype: str = "float32"        # "float64" runs on the CPU only
    save_directory: Optional[str] = None   # base dir; None = no file output
    # periodic native checkpoints every this many output segments (the
    # reference checkpoints only at the end); 0 = terminal only
    checkpoint_every_segments: int = 0

    @property
    def units(self) -> QTUnits:
        return qt_units_408(self.density)

    @property
    def ratio(self) -> int:
        return self.units.ratio_cooling()

    @property
    def qdt(self) -> float:
        return self.timestep / self.ratio

    @property
    def vkick(self) -> float:
        return VKICK_408_QUANTUM / self.units.plas_to_quant_vel

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32


def build_engine(cfg: CoolingConfig) -> QTEngine:
    scheme = with_recoil(
        sr12_cooling(cfg.detuning, cfg.detuning_dp, cfg.om, cfg.om_dp,
                     gs_convention=cfg.physics),
        kick_s=cfg.vkick, kick_d=cfg.vkick * K_RATIO_1033)
    u = cfg.units
    return QTEngine(scheme, h=cfg.qdt * u.gamma_to_einstein,
                    dt_plasma=cfg.qdt,
                    plas_to_quant_vel=u.plas_to_quant_vel,
                    gamma_to_einstein=u.gamma_to_einstein,
                    apply_force=True, renormalize=cfg.renormalize)


def om_split_schemes(cfg: CoolingConfig):
    """Base coupling patterns of per-lane Rabi sweeps: the sr12 scheme at
    (om, om_dp) = (1, 0) and (0, 1).  Every coupling, beat-note
    coefficient and Ehrenfest force weight is linear in its Rabi
    frequency, so H = om*H_sp + om_dp*H_dp + diag exactly."""
    ks, kd = cfg.vkick, cfg.vkick * K_RATIO_1033
    sp = with_recoil(sr12_cooling(cfg.detuning, cfg.detuning_dp, om=1.0,
                                  om_dp=0.0, gs_convention=cfg.physics),
                     kick_s=ks, kick_d=kd)
    dp = with_recoil(sr12_cooling(cfg.detuning, cfg.detuning_dp, om=0.0,
                                  om_dp=1.0, gs_convention=cfg.physics),
                     kick_s=ks, kick_d=kd)
    return sp, dp


def expansion_coeffs(cfg: CoolingConfig):
    """(c1, c2) of the expanding-frame detuning c1*t/sqrt(1+c2*t^2)
    (SpeedUp.cpp:447)."""
    c1 = 0.0126 * cfg.frac_of_sig * cfg.te / (math.sqrt(cfg.density) * cfg.sig0)
    c2 = 0.00014314 * cfg.te / (cfg.density * cfg.sig0 ** 2)
    return c1, c2


def build_scheduler(cfg: CoolingConfig, device, rolls_fn: Callable,
                    per_lane_e0: bool = False,
                    per_lane_om: bool = False) -> CoolingScheduler:
    """The run's stepper on ``device``; ``rolls_fn(n_ticks, npad)`` gives
    each MD step's uniforms (:func:`uniform_rolls` of a seeded generator
    in :func:`run`).  ``per_lane_e0`` / ``per_lane_om`` select the sweep
    variants of the tick kernel (detuning / Rabi sweeps)."""
    engine = build_engine(cfg)
    L = PlasmaUnits.box_length(cfg.n0)
    c1, c2 = expansion_coeffs(cfg) if cfg.frac_of_sig else (0.0, 0.0)
    ssp, sdp = om_split_schemes(cfg) if per_lane_om else (None, None)
    spec = FusedTickSpec(
        scheme=engine.scheme, h=engine.h, qdt=cfg.qdt,
        plas_to_quant_vel=engine.plas_to_quant_vel,
        gamma_to_einstein=engine.gamma_to_einstein, ratio=cfg.ratio, L=L,
        apply_force=True, exp_c1=c1, exp_c2=c2,
        renormalize=cfg.renormalize, per_lane_e0=per_lane_e0,
        per_lane_om=per_lane_om, scheme_sp=ssp, scheme_dp=sdp)
    return CoolingScheduler(
        fused_spec=spec, L=L,
        ldeb=PlasmaUnits(cfg.density, cfg.ge).debye_length, qdt=cfg.qdt,
        ratio=cfg.ratio, tile=auto_qt_tile(cfg.n0),
        device=torch.device(device), rolls_fn=rolls_fn,
        dtype=cfg.torch_dtype)


def initial_state(cfg: CoolingConfig, generator: torch.Generator,
                  n: Optional[int] = None) -> SimState:
    """Frozen-gas start drawn from ``generator`` on its device (``n``
    ions in the n0 cell when given)."""
    R, V, psi, _ = frozen_gas_init(generator, cfg.n0, n_states=12,
                                   exact_n=cfg.exact_n,
                                   dtype=cfg.torch_dtype,
                                   seed_for_count=cfg.job, n=n)
    return make_state(R, V, psi, device=generator.device,
                      dtype=cfg.torch_dtype)


def member_seed(seed: int, j: int) -> int:
    """Seed of ensemble member j's start generator: a function of (seed,
    j) alone, so a member starts the same in a fold of any size."""
    return seed * 100003 + j + 1


def fold_seed(seed: int) -> int:
    """Seed of the generator that draws an ensemble fold's uniforms
    (distinct from every :func:`member_seed` of the same ``seed``)."""
    return seed * 100003


def member_states(cfg: CoolingConfig, n_jobs: int, seed: int,
                  device, n: Optional[int] = None) -> SimState:
    """``[E, n, ...]`` frozen-gas starts (n0 ions unless ``n``), member j
    from a generator seeded with :func:`member_seed` ``(seed, j)`` on
    ``device``."""
    members = [initial_state(
        cfg, torch.Generator(device=device).manual_seed(member_seed(seed, j)),
        n=cfg.n0 if n is None else n) for j in range(n_jobs)]
    return SimState(**{k: torch.stack([getattr(m, k) for m in members])
                       for k in ("R", "V", "F", "psi", "t_part")})


def _poisson_member_states(cfg: CoolingConfig, n_jobs: int, seed: int,
                           device):
    """Fold with per-member Poissonian ion counts (the reference draws a
    fresh N per array job, SpeedUp.cpp:289-348): counts from
    :func:`poisson_member_mask` (the JAX package's draws for the same
    seed), members padded to the largest count; padded lanes start at
    R=V=psi=0 and stay there.  Returns ``(states, mask [E, n_arr],
    counts)``."""
    m, n_js = poisson_member_mask(cfg.n0, n_jobs, seed)
    states = member_states(cfg, n_jobs, seed, device, n=m.shape[1])
    mc = torch.as_tensor(m).to(device=states.R.device)
    return (dataclasses.replace(
        states, R=states.R * mc[..., None].to(states.R.dtype),
        V=states.V * mc[..., None].to(states.V.dtype),
        psi=states.psi * mc[..., None].to(states.psi.dtype)), m, n_js)


def _sample_outputs(state: SimState, L: float, ldeb: float,
                    bins: torch.Tensor, mask=None) -> dict:
    """Observables of one output sample (reference output()), on the
    state's device.  ``mask`` marks real ions when the member carries
    padded lanes (a Poissonian fold); every reduction excludes the rest."""
    ekx, eky, ekz, vx_mean = kinetic_energies(state.V, subtract_mean_vx=True,
                                              mask=mask)
    vx = state.V[:, 0] - vx_mean
    pvel = torch.stack([
        gaussian_kde(vx, bins, folded=True, weights=mask),
        gaussian_kde(state.V[:, 1], bins, folded=True, weights=mask),
        gaussian_kde(state.V[:, 2], bins, folded=True, weights=mask)])
    pops = state_populations(state.psi, [S_MANIFOLD, P_MANIFOLD, D_MANIFOLD])
    return dict(ekin=torch.stack([ekx, eky, ekz]),
                epot=yukawa_potential(state.R, L, ldeb, mask),
                vx_mean=vx_mean, pvel=pvel, vx_ions=state.V[:, 0],
                pops=torch.stack(pops, -1))


def _member(states: SimState, j: int) -> SimState:
    return SimState(R=states.R[j], V=states.V[j], F=states.F[j],
                    psi=states.psi[j], t_part=states.t_part[j],
                    tick=states.tick, t=states.t)


def _make_advance(sched: CoolingScheduler, forces_for=None, init=None,
                  restore=None, e0_lanes=None, om_lanes=None):
    """``(advance, advance_sampled)``, shared by every run path (single
    run, span, ensemble fold) so none can diverge from another.  The
    defaults step one state; the ensemble passes its fold's force
    function, ``soa_ens_init``/``soa_ens_restore`` and sweep lanes.

    ``advance(state, n_steps)`` runs whole MD steps;
    ``advance_sampled(state, n_steps) -> (state_mid, state_end)`` splits
    the LAST MD step at the reference's output instant, one quantum tick
    in (SpeedUp.cpp:1365-1368), and completes it with the same forces."""
    forces_for = forces_for or (lambda s: sched.soa_forces_fn(s.n_ions))
    init = init or sched.soa_init
    restore = restore or sched.soa_restore

    def step(carry, forces, **kw):
        return sched.soa_md_step(carry, forces, e0_lanes, om_lanes, **kw)

    def advance(state, n_steps):
        forces = forces_for(state)
        carry = init(state)
        for _ in range(n_steps):
            carry = step(carry, forces)
        return restore(carry, state)

    def advance_sampled(state, n_steps):
        forces = forces_for(state)
        carry = init(state)
        for _ in range(n_steps - 1):
            carry = step(carry, forces)
        carry = step(carry, forces, n_ticks=1)
        state_mid = restore(carry, state)
        if sched.ratio > 1:
            carry = step(carry, forces, n_ticks=sched.ratio - 1,
                         reuse_forces=True)
        return state_mid, restore(carry, state)
    return advance, advance_sampled


def _stack_samples(samples, times, dtype, axis=0) -> dict:
    outs = {k: torch.stack([s[k] for s in samples], axis) for k in samples[0]}
    t = torch.tensor(times, dtype=dtype)
    outs["t"] = t if axis == 0 else t.repeat(samples[0]["ekin"].shape[0], 1)
    return outs


def run_compiled(cfg: CoolingConfig, sched: CoolingScheduler,
                 state: SimState, n_segments: int):
    """``n_segments`` output segments of ``sample_freq`` MD steps each.
    Returns the final state and the per-sample outputs stacked on the
    device (``t`` on the host)."""
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    bins = folded_bins(cfg.torch_dtype, sched.device)
    _, advance_sampled = _make_advance(sched)
    samples, times = [], []
    for _ in range(n_segments):
        state_mid, state = advance_sampled(state, cfg.sample_freq)
        samples.append(_sample_outputs(state_mid, L, ldeb, bins))
        times.append(state_mid.t)
    return state, _stack_samples(samples, times, cfg.torch_dtype)


def run_compiled_span(cfg: CoolingConfig, sched: CoolingScheduler,
                      state: SimState, n_steps: int, sample: bool = True):
    """A partial segment off the sample grid: ``n_steps`` MD steps,
    optionally with one output sample at the reference instant.  The
    reference runs to tmax regardless of sample-grid alignment (while t <=
    tmax+0.0009, SpeedUp.cpp:1247) and its output gate is global
    ((c0+1)%sampleFreq==0, :1365), so a run whose tmax is off the grid
    ends with an unsampled span, and a resumed window first realigns to
    the gate with a sampled one.  Returns ``(state, outs)`` (``outs``
    None unsampled, else stacked with a leading axis of 1)."""
    advance, advance_sampled = _make_advance(sched)
    if not sample:
        return advance(state, n_steps), None
    state_mid, state = advance_sampled(state, n_steps)
    out = _sample_outputs(state_mid, PlasmaUnits.box_length(cfg.n0),
                          PlasmaUnits(cfg.density, cfg.ge).debye_length,
                          folded_bins(cfg.torch_dtype, sched.device))
    return state, _stack_samples([out], [state_mid.t], cfg.torch_dtype)


def run_compiled_ensemble(cfg: CoolingConfig, sched: CoolingScheduler,
                          states: SimState, n_segments: int, mask=None,
                          sweep_e0=None, sweep_om=None,
                          seg_len: Optional[int] = None, tail: int = 0):
    """Ensemble run of ``states [E, n, ...]``: the members fold into the
    kernels' lane axis, so each MD step is one batched force launch and
    one tick launch for the whole fold.

    ``mask [E, n]`` marks each member's real ions (Poissonian counts):
    padded lanes start at R=V=psi=0 and stay there (the force kernel masks
    both sides, zero wavefunctions neither jump nor kick), and every
    sampled reduction excludes them.  ``sweep_e0 [E, S]`` gives each
    member its own diagonal energies (a detuning sweep) and ``sweep_om [E,
    2]`` its own (om, om_dp); ``sched`` must be built with the matching
    per-lane flags.  ``seg_len`` overrides the per-segment step count
    (splice realignment, see :func:`run_compiled_span`); ``tail`` appends
    that many unsampled MD steps after the last segment.  Returns
    ``(states, outs)`` with outs ``[E, n_segments, ...]`` on the device
    (None without segments)."""
    check_uniform_tick(states.tick)
    spec = sched.fused_spec
    if (spec.per_lane_e0 != (sweep_e0 is not None)
            or spec.per_lane_om != (sweep_om is not None)):
        raise ValueError("the scheduler's per-lane flags must match the "
                         "sweep tables given (build_scheduler(..., "
                         "per_lane_e0=, per_lane_om=))")
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    bins = folded_bins(cfg.torch_dtype, sched.device)
    E, n = states.R.shape[:2]
    forces = sched.soa_ens_forces_fn(E, n, mask)
    e0p, omp = fold_sweep_lanes(spec, sched._npad(n), sweep_e0, sweep_om,
                                sched.device)
    mask_t = (None if mask is None else
              torch.as_tensor(mask).to(sched.device, cfg.torch_dtype))
    advance, advance_sampled = _make_advance(
        sched, forces_for=lambda _: forces, init=sched.soa_ens_init,
        restore=sched.soa_ens_restore, e0_lanes=e0p, om_lanes=omp)
    samples, times = [], []
    for _ in range(n_segments):
        mid, states = advance_sampled(states, seg_len or cfg.sample_freq)
        per = [_sample_outputs(_member(mid, j), L, ldeb, bins,
                               None if mask_t is None else mask_t[j])
               for j in range(E)]
        samples.append({k: torch.stack([p[k] for p in per]) for k in per[0]})
        times.append(mid.t)
    if tail:
        states = advance(states, tail)
    outs = (_stack_samples(samples, times, cfg.torch_dtype, axis=1)
            if samples else None)
    return states, outs


def _save_dir(cfg: CoolingConfig) -> str:
    return cooling_dir(cfg.save_directory, ge=cfg.ge, density=cfg.density,
                       sig0=cfg.sig0, te=cfg.te, frac_of_sig=cfg.frac_of_sig,
                       detuning=cfg.detuning, detuning_dp=cfg.detuning_dp,
                       om=cfg.om, om_dp=cfg.om_dp, n0=cfg.n0, job=cfg.job)


def latest_checkpoint(directory: str) -> Optional[int]:
    """Highest c0 among native checkpoints in a run directory."""
    return ckpt.latest_native_checkpoint(directory)


def _rng_extra(generator: Optional[torch.Generator]) -> dict:
    """The generator's state for a native checkpoint (empty when the
    uniforms came from a caller's ``rolls_fn``)."""
    if generator is None:
        return {}
    return {"torch_rng_state": generator.get_state().numpy(),
            "torch_rng_device": np.str_(generator.device.type)}


def _rng_restore(generator: torch.Generator, z: dict, reseed: int) -> None:
    """Continue the checkpointed generator stream, or reseed with
    ``reseed`` (job*7919 + c0, the JAX package's rule) when the
    checkpoint has none (the JAX package's, or an ASCII one)."""
    if "torch_rng_state" not in z:
        generator.manual_seed(reseed)
        return
    kind = str(z.get("torch_rng_device", "cpu"))
    if kind != generator.device.type:
        raise ValueError(f"the checkpoint's generator state is from a {kind} "
                         f"generator; this run draws on "
                         f"{generator.device.type}")
    generator.set_state(torch.from_numpy(np.array(z["torch_rng_state"])))


def _np_float(cfg: CoolingConfig, x: float) -> float:
    return float((np.float64 if cfg.dtype == "float64" else np.float32)(x))


def run(cfg: CoolingConfig, seed: Optional[int] = None,
        state: Optional[SimState] = None, resume: bool = False,
        device="cuda", rolls_fn: Optional[Callable] = None):
    """Execute the run on ``device``; write the reference-schema .dat tree
    and checkpoints when ``cfg.save_directory`` is set.  Returns
    ``(final, dict(outs=..., epot0=..., final=...))`` with host numpy
    values, as the JAX package's ``run`` does.

    With ``checkpoint_every_segments`` the run goes in groups of segments,
    the .dat rows streamed and a native checkpoint published after each.
    ``resume=True`` (without ``state``) continues from the newest
    checkpoint of the run directory, native or ASCII, to ``cfg.tmax``; a
    window whose tmax ended off the sample grid is realigned to the global
    gate with one partial sampled segment.

    Random draws come from one ``torch.Generator`` on ``device`` seeded
    with ``seed`` (default ``cfg.job``): the initial state (unless
    ``state`` is given), then each MD step's uniforms.  ``rolls_fn``
    replaces the latter (tests replay another implementation's draws)."""
    device = torch.device(device)
    if cfg.torch_dtype == torch.float64 and device.type != "cpu":
        raise NotImplementedError("float64 runs on the CPU only; the CUDA "
                                  "kernels are float32 (ROADMAP.md)")
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.job if seed is None else seed)
    save_dir = _save_dir(cfg) if cfg.save_directory is not None else None
    done, step_done, epot0 = 0, None, None
    if resume and save_dir is not None and state is None:
        c0_last = latest_checkpoint(save_dir)
        # newest checkpoint wins across formats: after the reference
        # binary continues a run only the ASCII files advance
        c0_ascii = ckpt.latest_ascii_checkpoint(save_dir)
        if c0_ascii is not None and (c0_last is None or c0_ascii > c0_last):
            state = resume_state(save_dir, c0_ascii, cfg, device)
            _, done = ckpt.read_ions(save_dir, c0_ascii)
            step_done = c0_ascii + 1
            generator.manual_seed(cfg.job * 7919 + c0_ascii)
            # the ASCII schema has no Epot0; the reference's stays 0.0 on a
            # newRun=0 restart (SpeedUp.cpp:119, 346)
            epot0 = 0.0
        elif c0_last is not None:
            z = ckpt.load_native(save_dir, c0_last)
            _rng_restore(generator, z, cfg.job * 7919 + c0_last)
            tick = (c0_last + 1) * cfg.ratio
            state = make_state(z["R"], z["V"], z["psi"], device=device,
                               dtype=cfg.torch_dtype, tick=tick,
                               t=_np_float(cfg, tick * cfg.qdt),
                               t_part=z.get("t_part"))
            done = int(z["counter"])
            step_done = c0_last + 1
            if "epot0" in z:
                epot0 = float(z["epot0"])
    if state is None:
        state = initial_state(cfg, generator)
    sched = build_scheduler(cfg, device, rolls_fn or uniform_rolls(generator))
    rng_gen = None if rolls_fn else generator
    L = PlasmaUnits.box_length(cfg.n0)
    if epot0 is None:
        epot0 = float(yukawa_potential(
            state.R, L, PlasmaUnits(cfg.density, cfg.ge).debye_length))

    n_md = int(round(cfg.tmax / cfg.timestep))
    f = cfg.sample_freq
    n_segments = n_md // f          # output samples (global gate)
    group = cfg.checkpoint_every_segments or n_segments
    if step_done is None:
        step_done = done * f
    aligned = n_md == n_segments * f
    outs_groups = []
    while done < n_segments:
        if step_done % f:
            # splice realignment: the previous window ended off the grid
            g = 1
            state, outs = run_compiled_span(cfg, sched, state,
                                            f - step_done % f)
        else:
            g = min(group, n_segments - done)
            state, outs = run_compiled(cfg, sched, state, g)
        outs_np = {k: v.cpu().numpy() for k, v in outs.items()}
        outs_groups.append(outs_np)
        prev_done = done
        done += g
        step_done = done * f
        if save_dir is not None:
            # this group's rows first, then the checkpoint: a crash in
            # between re-appends one group on resume instead of a gap
            st = state_to_numpy(state)
            os.makedirs(save_dir, exist_ok=True)
            write_outputs(save_dir, cfg, outs_np, epot0, st, n_md,
                          sample_offset=prev_done,
                          terminal=(done == n_segments and aligned),
                          rng_extra=_rng_extra(rng_gen))
            if done < n_segments:
                ckpt.save_native(save_dir, done * f - 1, R=st.R, V=st.V,
                                 psi=st.psi, counter=done,
                                 extra={"epot0": epot0, "t_part": st.t_part,
                                        **_rng_extra(rng_gen)})
    if step_done < n_md:
        # trailing sub-segment past the last output gate: the terminal
        # checkpoint at c0 = n_md-1 holds the true tmax state
        state, _ = run_compiled_span(cfg, sched, state, n_md - step_done,
                                     sample=False)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            write_terminal_checkpoint(save_dir, cfg, state_to_numpy(state),
                                      n_md, done, epot0,
                                      rng_extra=_rng_extra(rng_gen))
    final = state_to_numpy(state)
    outs = ({k: np.concatenate([o[k] for o in outs_groups])
             for k in outs_groups[0]} if outs_groups else None)
    return final, dict(outs=outs, epot0=epot0, final=final)


def _pad_rows(a, n_arr: int) -> np.ndarray:
    """Zero-pad axis 0 of a host array to ``n_arr`` rows."""
    a = np.asarray(a)
    out = np.zeros((n_arr,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out


def _stack_fold(members, cfg: CoolingConfig, device, tick: int, t: float):
    """Stack per-member host states ``(R, V, psi, t_part | None)`` into the
    ``[E, n_arr, ...]`` fold on ``device``, padded to the largest member,
    and build the Poissonian ion mask.  Returns ``(states, mask, n_js)``,
    mask and n_js None when every member fills all lanes (shared by the
    ASCII and native resume rebuilds)."""
    n_js = [len(m[0]) for m in members]
    n_arr = max(n_js)
    R, V, psi, tp = (np.stack(col) for col in zip(*(
        [_pad_rows(np.zeros(len(m[0])) if x is None else x, n_arr)
         for x in m] for m in members)))
    states = make_state(R, V, psi, device=device, dtype=cfg.torch_dtype,
                        tick=tick, t=t, F=np.zeros_like(R), t_part=tp)
    if all(nj == n_arr for nj in n_js):
        return states, None, None
    m = np.zeros((len(n_js), n_arr), np.float32)
    for j, nj in enumerate(n_js):
        m[j, :nj] = 1.0
    return states, m, n_js


def _ensemble_numpy(states: SimState) -> NumpyState:
    """Host copy of a fold, with per-member ``tick``/``t`` arrays as the
    JAX package's stacked states carry them."""
    st = state_to_numpy(states)
    E = st.R.shape[0]
    return st._replace(tick=np.full(E, st.tick, np.int32),
                       t=np.full(E, st.t))


def _member_np(st: NumpyState, j: int) -> NumpyState:
    return NumpyState(*(x[j] for x in st))


def _resume_fold(cfg, job_cfgs, job_dirs, device, generator):
    """Rebuild a fold from the newest checkpoint common to all job
    directories (newest format wins, as in :func:`run`).  Returns None
    when there is none, else ``(states, mask, n_js, done, step_done,
    epot0 [E])``; members at inconsistent checkpoints raise."""
    n_jobs = len(job_dirs)
    c0s = [latest_checkpoint(d) for d in job_dirs]
    c0s_ascii = [ckpt.latest_ascii_checkpoint(d) for d in job_dirs]
    have_native = all(c is not None for c in c0s)
    use_ascii = (all(c is not None for c in c0s_ascii)
                 and (not have_native or min(c0s_ascii) > min(c0s)))
    if use_ascii:
        c0set = set(c0s_ascii)
        if len(c0set) != 1:
            raise ValueError(
                "ensemble members at inconsistent ASCII checkpoints "
                f"{sorted(c0set)}; the fused fold requires one shared tick")
        c0 = c0set.pop()
        counters = {ckpt.read_ions(d, c0)[1] for d in job_dirs}
        if len(counters) != 1:
            raise ValueError(
                "ensemble members at inconsistent checkpoint counters "
                f"{sorted(counters)}; the fused fold requires one shared "
                "tick")
        hosts = []
        for d in job_dirs:
            R, V = ckpt.read_conditions(d, c0)
            psi = ckpt.read_wvfns(d, c0)
            if psi.shape[0] != R.shape[0]:
                raise ValueError(
                    f"{d}: wvFns_timestep{c0:06d}.dat has {psi.shape[0]} "
                    f"rows for {R.shape[0]} ions — truncated or mismatched "
                    "member checkpoint")
            hosts.append((R, V, psi, None))
        t0 = ckpt.restore_time(c0, cfg.timestep)
        states, mask, n_js = _stack_fold(hosts, cfg, device,
                                         int(round(t0 / cfg.qdt)),
                                         _np_float(cfg, t0))
        generator.manual_seed(job_cfgs[0].job * 7919 + c0)
        # reference newRun=0 semantics per job: Epot0 stays 0
        return states, mask, n_js, counters.pop(), c0 + 1, np.zeros(n_jobs)
    if have_native:
        c0 = min(c0s)               # newest checkpoint common to all jobs
        newer_ascii = sorted({ca for ca in c0s_ascii
                              if ca is not None and ca > c0})
        if newer_ascii:
            raise ValueError(
                f"ASCII checkpoints at timestep(s) {newer_ascii} are newer "
                f"than the native resume point {c0} but not present for "
                "every job; advance the remaining jobs to the same "
                "checkpoint (or remove the stale files) before resuming "
                "the fold")
        zs = [ckpt.load_native(d, c0) for d in job_dirs]
        counters = {int(z["counter"]) for z in zs}
        if len(counters) != 1:
            raise ValueError("ensemble members at inconsistent checkpoint "
                             f"counters {sorted(counters)}; the fused fold "
                             "requires one shared tick")
        tick = (c0 + 1) * cfg.ratio
        states, mask, n_js = _stack_fold(
            [(z["R"], z["V"], z["psi"], z.get("t_part")) for z in zs], cfg,
            device, tick, _np_float(cfg, tick * cfg.qdt))
        _rng_restore(generator, zs[0], job_cfgs[0].job * 7919 + c0)
        epot0 = (np.asarray([float(z["epot0"]) for z in zs])
                 if all("epot0" in z for z in zs) else None)
        return states, mask, n_js, counters.pop(), c0 + 1, epot0
    if any(c is not None for c in c0s + c0s_ascii):
        n_nat = sum(c is not None for c in c0s)
        n_asc = sum(c is not None for c in c0s_ascii)
        raise ValueError(
            f"resume=True but no single checkpoint format covers every job "
            f"({n_nat}/{n_jobs} native, {n_asc}/{n_jobs} ASCII): "
            f"checkpoints exist for only a subset of jobs; refusing to "
            f"restart the fold from scratch (it would replay covered steps "
            f"and append duplicate .dat rows)")
    return None


def run_ensemble(cfg: CoolingConfig, n_jobs: int, seed: int = 0,
                 resume: bool = False, mesh=None, sweep=None, device="cuda",
                 states=None, rolls_fn: Optional[Callable] = None):
    """Batched ensemble of independent trajectories, the replacement of
    the reference's SLURM job array (exampleSlurmFile.slurm).  Returns
    ``(final, outs)``: host numpy states ``[E, ...]`` and per-job stacked
    outputs ``[E, n_samples, ...]`` (None when no sample was taken).  With
    ``cfg.save_directory`` set, each member writes its .dat tree into its
    own ``job<k>/`` directory, as the reference's array jobs would.

    The members fold into the kernels' lane axis: one batched force launch
    (kernel C; kernel A for one member) and one tick launch per MD step.
    ``cfg.exact_n=False`` gives each member its own Poissonian ion count
    (padded lanes inert).  With ``checkpoint_every_segments`` every job
    directory gets a native checkpoint after each group and its rows
    stream group by group; ``resume=True`` rebuilds the fold from the
    newest checkpoint common to all job directories (members at
    inconsistent counters raise).

    ``sweep`` makes the members a parameter grid instead of replicas: a
    length-``n_jobs`` sequence of per-member overrides with keys among
    ``detuning``/``detuning_dp``/``om``/``om_dp``/``job``.  Detunings
    enter only through the diagonal energies and H is linear in each
    Rabi frequency, so the grid still runs as one fold (the per-lane tick
    kernel variants); each member writes into its own param-encoded
    directory.

    ``states`` (a stacked numpy or JAX start, ``[E, n, ...]``) replaces
    the members' drawn start when no checkpoint is resumed; ``rolls_fn``
    replaces the fold generator's uniforms (tests replay another
    implementation's draws).  ``mesh`` (multi-device folds) is not
    ported."""
    if mesh is not None:
        raise NotImplementedError("multi-device ensemble folds (mesh=) are "
                                  "not ported yet (ROADMAP.md Queue 1 item "
                                  "14)")
    device = torch.device(device)
    if cfg.torch_dtype == torch.float64 and device.type != "cpu":
        raise NotImplementedError("float64 runs on the CPU only; the CUDA "
                                  "kernels are float32 (ROADMAP.md)")
    generator = torch.Generator(device=device).manual_seed(fold_seed(seed))
    n_md = int(round(cfg.tmax / cfg.timestep))
    f = cfg.sample_freq
    n_segments = n_md // f
    group = cfg.checkpoint_every_segments or n_segments
    job_cfgs = [dataclasses.replace(cfg, job=j + 1) for j in range(n_jobs)]
    sweep_e0 = sweep_om = None
    if sweep is not None:
        if len(sweep) != n_jobs:
            raise ValueError(f"sweep has {len(sweep)} entries for {n_jobs} "
                             "jobs")
        allowed = {"detuning", "detuning_dp", "om", "om_dp", "job"}
        keys = {k for s in sweep for k in s}
        if keys - allowed:
            # only fields the tick kernel reads per lane can vary in a fold
            raise ValueError(f"sweep can only override {sorted(allowed)}, "
                             f"got {sorted(keys - allowed)}")
        job_cfgs = [dataclasses.replace(c, **dict(s))
                    for c, s in zip(job_cfgs, sweep)]
        if keys & {"detuning", "detuning_dp"}:
            sweep_e0 = np.stack([build_engine(c).scheme.e0
                                 for c in job_cfgs]).astype(np.float32)
        if keys & {"om", "om_dp"}:
            sweep_om = np.asarray([[c.om, c.om_dp] for c in job_cfgs],
                                  np.float32)
    job_dirs = ([_save_dir(c) for c in job_cfgs]
                if cfg.save_directory is not None else None)

    done, step_done, mask, n_js, epot0 = 0, None, None, None, None
    fold = None
    if resume and job_dirs is not None:
        found = _resume_fold(cfg, job_cfgs, job_dirs, device, generator)
        if found is not None:
            fold, mask, n_js, done, step_done, epot0 = found
    if fold is None:
        if states is not None:
            fold = states_from_numpy(states, device=device,
                                     dtype=cfg.torch_dtype)
            if not cfg.exact_n:
                mask, n_js = poisson_member_mask(cfg.n0, n_jobs, seed)
                if mask.shape[1] != fold.R.shape[1]:
                    raise ValueError(
                        f"states have {fold.R.shape[1]} lanes; the Poisson "
                        f"counts of seed {seed} need {mask.shape[1]}")
        elif cfg.exact_n:
            fold = member_states(cfg, n_jobs, seed, device)
        else:
            fold, mask, n_js = _poisson_member_states(cfg, n_jobs, seed,
                                                      device)
    if fold.R.shape[0] != n_jobs:
        raise ValueError(f"the fold has {fold.R.shape[0]} members for "
                         f"{n_jobs} jobs")
    sched = build_scheduler(cfg, device, rolls_fn or uniform_rolls(generator),
                            per_lane_e0=sweep_e0 is not None,
                            per_lane_om=sweep_om is not None)
    rng_gen = None if rolls_fn else generator
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    if epot0 is None:
        mask_t = (None if mask is None else
                  torch.as_tensor(mask).to(device, cfg.torch_dtype))
        epot0 = np.asarray([float(yukawa_potential(
            fold.R[j], L, ldeb, None if mask_t is None else mask_t[j]))
            for j in range(n_jobs)])

    rem = n_md - n_segments * f      # trailing steps past the last gate
    if step_done is None:
        step_done = done * f
    outs_groups = []
    while done < n_segments:
        if step_done % f:
            # splice realignment onto the global output gate
            g, seg_len = 1, f - step_done % f
        else:
            g, seg_len = min(group, n_segments - done), None
        # the trailing sub-segment rides the final group, so the returned
        # states hold the true tmax state for the terminal checkpoint
        tail = rem if done + g == n_segments else 0
        fold, outs = run_compiled_ensemble(cfg, sched, fold, g, mask=mask,
                                           sweep_e0=sweep_e0,
                                           sweep_om=sweep_om,
                                           seg_len=seg_len, tail=tail)
        outs_np = {k: v.cpu().numpy() for k, v in outs.items()}
        outs_groups.append(outs_np)
        prev_done = done
        done += g
        step_done = done * f + tail
        if job_dirs is not None:
            st = _ensemble_numpy(fold)
            extra = _rng_extra(rng_gen)
            for j in range(n_jobs):
                n_j = n_js[j] if n_js is not None else None
                final_j = _member_np(st, j)
                write_outputs(job_dirs[j], job_cfgs[j],
                              {k: v[j] for k, v in outs_np.items()},
                              float(epot0[j]), final_j, n_md,
                              sample_offset=prev_done,
                              terminal=(done == n_segments), n_actual=n_j,
                              rng_extra=extra)
                if done < n_segments:
                    nw = final_j.R.shape[0] if n_j is None else n_j
                    ckpt.save_native(
                        job_dirs[j], done * f - 1, R=final_j.R[:nw],
                        V=final_j.V[:nw], psi=final_j.psi[:nw],
                        counter=done,
                        extra={"epot0": float(epot0[j]),
                               "t_part": final_j.t_part[:nw], **extra})

    if step_done < n_md:
        # trailing sub-segment with no sampled segment left to carry it:
        # advance to tmax and publish the terminal checkpoints
        fold, _ = run_compiled_ensemble(cfg, sched, fold, 0, mask=mask,
                                        sweep_e0=sweep_e0, sweep_om=sweep_om,
                                        tail=n_md - step_done)
        if job_dirs is not None:
            st = _ensemble_numpy(fold)
            for j in range(n_jobs):
                os.makedirs(job_dirs[j], exist_ok=True)
                write_terminal_checkpoint(
                    job_dirs[j], job_cfgs[j], _member_np(st, j), n_md, done,
                    float(epot0[j]),
                    n_actual=None if n_js is None else n_js[j],
                    rng_extra=_rng_extra(rng_gen))
    final = _ensemble_numpy(fold)
    if not outs_groups:           # resume found nothing left to do
        return final, None
    return final, {k: np.concatenate([o[k] for o in outs_groups], axis=1)
                   for k in outs_groups[0]}


def run_sweep(cfg: CoolingConfig, points, jobs_per_point: int = 1,
              seed: int = 0, resume: bool = False, mesh=None, device="cuda",
              states=None, rolls_fn: Optional[Callable] = None):
    """A laser-parameter grid as ONE ensemble fold (the reference rebuilds
    its binary per point, SpeedUp.cpp:66-69).  ``points``: ``(det_sp,
    det_dp)`` pairs in units of gamma_SP, or dicts with keys among
    ``detuning``/``detuning_dp``/``om``/``om_dp`` (unset fields keep
    ``cfg``'s value).  ``jobs_per_point`` replicates each point (job
    numbers 1..jobs_per_point inside each point's directory); members are
    point-major.  Returns ``(final, outs, member_cfgs)``; the other
    arguments are :func:`run_ensemble`'s."""
    sweep = []
    for pt in points:
        ov = (dict(pt) if isinstance(pt, dict)
              else {"detuning": float(pt[0]), "detuning_dp": float(pt[1])})
        for r in range(jobs_per_point):
            sweep.append({**ov, "job": r + 1})
    member_cfgs = [dataclasses.replace(cfg, **s) for s in sweep]
    final, outs = run_ensemble(cfg, len(sweep), seed=seed, resume=resume,
                               mesh=mesh, sweep=sweep, device=device,
                               states=states, rolls_fn=rolls_fn)
    return final, outs, member_cfgs


def write_outputs(directory: str, cfg: CoolingConfig, outs: dict,
                  epot0: float, final: NumpyState, n_md: int,
                  sample_offset: int = 0, terminal: bool = True,
                  n_actual: Optional[int] = None,
                  rng_extra: Optional[dict] = None) -> None:
    """Emit energies.dat (appended), vel_dist{X,Y,Z}_time*.dat,
    statePopulationsVsVTime*.dat and (when ``terminal``) the final
    checkpoint, in the JAX package's (and the reference's) schema.
    ``sample_offset`` shifts the per-sample file counters of a later
    group or window; ``n_actual`` cuts a Poissonian member's padded lanes
    off every file."""
    w = DatWriter(directory)
    bins = folded_bins_np()
    n_samples = outs["t"].shape[0]
    n = n_actual if n_actual is not None else final.R.shape[0]
    energies = np.zeros((n_samples, 7))
    for k in range(n_samples):
        kk = k + sample_offset
        ekx, eky, ekz = (float(x) for x in outs["ekin"][k])
        epot = float(outs["epot"][k])
        vxm = float(outs["vx_mean"][k])
        energies[k] = (float(outs["t"][k]), ekx, eky, ekz, epot,
                       ekx + eky + ekz + epot - epot0, vxm)
        pv = outs["pvel"][k]
        w.write(f"vel_distX_time{kk:06d}.dat",
                np.stack([bins + vxm, pv[0]], axis=-1))
        w.write(f"vel_distY_time{kk:06d}.dat", np.stack([bins, pv[1]], axis=-1))
        w.write(f"vel_distZ_time{kk:06d}.dat", np.stack([bins, pv[2]], axis=-1))
        w.write(f"statePopulationsVsVTime{kk:06d}.dat",
                np.concatenate([outs["vx_ions"][k][:n, None],
                                outs["pops"][k][:n]], axis=-1))
    w.append("energies.dat", energies)
    if terminal:
        write_terminal_checkpoint(directory, cfg, final, n_md,
                                  sample_offset + n_samples, epot0,
                                  n_actual=n_actual, rng_extra=rng_extra)


def write_terminal_checkpoint(directory: str, cfg: CoolingConfig,
                              final: NumpyState, n_md: int, counter: int,
                              epot0: float, n_actual: Optional[int] = None,
                              rng_extra: Optional[dict] = None) -> None:
    """The reference-schema terminal checkpoint at c0 = n_md - 1
    (writeConditions, SpeedUp.cpp:725-783; the 13 VZERO interval files
    are zeros, as the SpeedUp main writes them) plus the native .npz
    (with t_part, which the ASCII schema drops, and the generator state
    in ``rng_extra``).  ``n_actual`` cuts padded lanes off."""
    n = n_actual if n_actual is not None else final.R.shape[0]
    c0 = n_md - 1
    ckpt.write_ions(directory, c0, n, counter)
    ckpt.write_conditions(directory, c0, final.R[:n], final.V[:n])
    ckpt.write_wvfns(directory, c0, final.psi[:n])
    ckpt.write_vzero(directory, c0, np.zeros((13, n, 3)))
    ckpt.save_native(directory, c0, R=final.R[:n], V=final.V[:n],
                     psi=final.psi[:n], counter=counter,
                     extra={"epot0": epot0, "t_part": final.t_part[:n],
                            **(rng_extra or {})})


def resume_state(directory: str, c0: int, cfg: CoolingConfig,
                 device="cpu") -> SimState:
    """Reference-compatible restart from the ASCII checkpoint at ``c0``
    (readConditions, SpeedUp.cpp:785-916).  The ions_ N pins the
    conditions_/wvFns_ row counts: a truncated or mismatched file raises a
    ValueError naming it.  The clock is ``t = (c0-9)*dt + 0.02`` (:789);
    t_part restarts at 0, as the reference's does.  For walltime chaining
    prefer ``run(cfg, resume=True)``, which realigns to the global output
    gate."""
    n_exp = None
    try:
        n_exp, _ = ckpt.read_ions(directory, c0)
    except FileNotFoundError:
        pass
    R, V = ckpt.read_conditions(directory, c0, expect_n=n_exp)
    psi = ckpt.read_wvfns(directory, c0, expect_n=R.shape[0])
    t0 = ckpt.restore_time(c0, cfg.timestep)
    return make_state(R, V, psi, device=device, dtype=cfg.torch_dtype,
                      tick=int(round(t0 / cfg.qdt)), t=_np_float(cfg, t0))
