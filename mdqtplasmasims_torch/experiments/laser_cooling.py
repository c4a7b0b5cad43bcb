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
start from one generator seeded with ``seed`` (default ``cfg.job``).  An
ensemble's member j starts from a generator seeded with
:func:`member_seed` ``(seed, j)``, and the fold's randomness comes from
one generator seeded with :func:`fold_seed` ``(seed)``.  The jump
uniforms take one of two forms, as in the JAX package, whose device runs
draw them inside the tick kernel and whose CPU interpret runs take
explicit rolls:

* on CUDA without a caller's ``rolls_fn``, the tick kernel draws them
  itself (core/rng.py): the run's generator gives one 31-bit seed word
  when the run or fold starts and nothing per segment or MD step;
* on the CPU, or with a ``rolls_fn``, explicit ``[ratio*5, Np]`` rolls
  drawn before every MD step (from the generator, or the caller's
  ``rolls_fn``, through which tests replay the JAX package's draws).

The choice is made in one place, :func:`_use_internal_rng`, from the
device and the ``rolls_fn`` alone.  Every native checkpoint carries the
generator's state under ``torch_rng_state`` and the seed word under
``torch_rng_seed`` (never the JAX package's ``key``), so a resume
continues both; a checkpoint without them (the JAX package's, or an ASCII
one) reseeds with ``job*7919 + c0`` as the JAX package does, and draws a
fresh word from the reseeded generator.

The interval diagnostics of the pre-SpeedUp code (``record_snapshots``,
``vaf_intervals``, ``record_lccf``) keep V (and R) per sample, take the
LCCF current J(k) at sample time on the run's device, and write
``VAF_interval<k>.dat`` and ``J_interval0.dat``; the interval origins
(``vholder``) ride the VZERO files and native checkpoints.

``run_ensemble(mesh=...)`` spreads the fold over a mesh of device slots
(parallel/mesh.py): members over its ``ens`` axis and, optionally, each
member's ions over its ``ions`` axis, every slot stepping its block
through the same kernels (:func:`run_compiled_sharded`); the files,
checkpoints and resume are the single fold's.

Not ported yet: float64 on CUDA.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..bridge import NumpyState, state_to_numpy, states_from_numpy
from ..core.init import frozen_gas_init, poisson_member_mask
from ..core.md import kinetic_energies
from ..core.qt import QTEngine, state_populations
from ..core.qt_fused import FusedTickSpec
from ..core.scheduler import (CoolingScheduler, auto_qt_tile,
                              check_uniform_tick, draw_seed_word,
                              fold_sweep_lanes, uniform_rolls)
from ..io import checkpoint as ckpt
from ..io.datfiles import DatWriter, format_rows
from ..io.dirs import cooling_dir
from ..levels import sr12_cooling, with_recoil
from ..ops.kde import folded_bins, folded_bins_np, gaussian_kde
from ..ops.structure import current_fourier, k_grid
from ..ops.yukawa import (yukawa_potential_pallas,
                          yukawa_potential_pallas_batched)
from ..profiling import span
from ..state import SimState, make_state
from ..units import (K_RATIO_1033, VKICK_408_QUANTUM, PlasmaUnits, QTUnits,
                     qt_units_408)

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
    # interval diagnostics of the pre-SpeedUp code (active in
    # LaserCoolingPlusExpansionMDQT.cpp:1252-1362; commented out of the
    # SpeedUp main), evaluated from per-sample phase-space snapshots (the
    # reference also evaluates them at sample times only):
    record_snapshots: bool = False         # keep V (and R) per sample
    vaf_intervals: tuple = ()              # start times, e.g. (3,5,...,27)
    record_lccf: bool = False              # J(k) per sample (needs snapshots)
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


def _use_internal_rng(device: torch.device, rolls_fn) -> bool:
    """The uniforms' form of a run, the one place it is chosen: the
    in-kernel stream on CUDA unless a ``rolls_fn`` is given (as the JAX
    package uses its in-kernel RNG on a device), explicit rolls
    otherwise."""
    return device.type == "cuda" and rolls_fn is None


def build_scheduler(cfg: CoolingConfig, device,
                    rolls_fn: Optional[Callable] = None,
                    per_lane_e0: bool = False,
                    per_lane_om: bool = False) -> CoolingScheduler:
    """The run's stepper on ``device``.  With :func:`_use_internal_rng`
    (CUDA and no ``rolls_fn``) the tick kernel draws its own uniforms and
    the caller sets the run's seed word on ``.seed``; otherwise
    ``rolls_fn(n_ticks, npad)`` gives each MD step's uniforms
    (:func:`uniform_rolls` of a seeded generator in :func:`run`).
    ``per_lane_e0`` / ``per_lane_om`` select the sweep variants of the
    tick kernel (detuning / Rabi sweeps)."""
    device = torch.device(device)
    internal_rng = _use_internal_rng(device, rolls_fn)
    engine = build_engine(cfg)
    L = PlasmaUnits.box_length(cfg.n0)
    c1, c2 = expansion_coeffs(cfg) if cfg.frac_of_sig else (0.0, 0.0)
    ssp, sdp = om_split_schemes(cfg) if per_lane_om else (None, None)
    spec = FusedTickSpec(
        scheme=engine.scheme, h=engine.h, qdt=cfg.qdt,
        plas_to_quant_vel=engine.plas_to_quant_vel,
        gamma_to_einstein=engine.gamma_to_einstein, ratio=cfg.ratio, L=L,
        apply_force=True, exp_c1=c1, exp_c2=c2,
        renormalize=cfg.renormalize, internal_rng=internal_rng,
        per_lane_e0=per_lane_e0, per_lane_om=per_lane_om, scheme_sp=ssp,
        scheme_dp=sdp)
    return CoolingScheduler(
        fused_spec=spec, L=L,
        ldeb=PlasmaUnits(cfg.density, cfg.ge).debye_length, qdt=cfg.qdt,
        ratio=cfg.ratio, tile=auto_qt_tile(cfg.n0), device=device,
        rolls_fn=rolls_fn, dtype=cfg.torch_dtype)


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
                           device, round_to: int = 1):
    """Fold with per-member Poissonian ion counts (the reference draws a
    fresh N per array job, SpeedUp.cpp:289-348): counts from
    :func:`poisson_member_mask` (the JAX package's draws for the same
    seed), members padded to the largest count rounded up to a multiple of
    ``round_to`` (a mesh's ion shards); padded lanes start at R=V=psi=0
    and stay there.  Returns ``(states, mask [E, n_arr], counts)``."""
    m, n_js = poisson_member_mask(cfg.n0, n_jobs, seed, round_to=round_to)
    states = member_states(cfg, n_jobs, seed, device, n=m.shape[1])
    mc = torch.as_tensor(m).to(device=states.R.device)
    return (dataclasses.replace(
        states, R=states.R * mc[..., None].to(states.R.dtype),
        V=states.V * mc[..., None].to(states.V.dtype),
        psi=states.psi * mc[..., None].to(states.psi.dtype)), m, n_js)


def _lccf_kvecs(cfg: CoolingConfig, device) -> Optional[torch.Tensor]:
    """The LCCF's ``[K, 3]`` wavevectors on ``device`` (None without
    ``record_lccf``)."""
    if not cfg.record_lccf:
        return None
    return torch.as_tensor(k_grid(PlasmaUnits.box_length(cfg.n0), 12),
                           device=device)


def _sample_outputs(state: SimState, cfg: CoolingConfig, L: float,
                    ldeb: float, bins: torch.Tensor, mask=None,
                    epot=None, kvecs=None) -> dict:
    """Observables of one output sample (reference output()), on the
    state's device: of one state ``[n, ...]``, or of every member of a
    fold at once from ``[E, n, ...]`` (each output then ``[E, ...]``).
    ``mask`` (``[n]``, or ``[E, n]`` for a fold) marks real ions when the
    members carry padded lanes (a Poissonian fold); every reduction
    excludes the rest.  The potential comes from kernel D on the card (its
    twin, the plain ``yukawa_potential``, on the CPU) unless the caller
    gives ``epot`` (a fold's, from one launch of kernel G).  The interval
    diagnostics keep V (and, for the LCCF, R and the current J(k) at the
    wavevectors ``kvecs``, on the state's device; padded lanes, V=0, add
    nothing to it).  Every per-member sum runs over that member's own
    ions, so a fold's sample is its members' samples, bit for bit on the
    CPU."""
    if epot is None:
        epot = yukawa_potential_pallas(state.R, L, ldeb, mask)
    V = state.V
    ekx, eky, ekz, vx_mean = kinetic_energies(
        V.movedim(-2, 0), subtract_mean_vx=True,
        mask=None if mask is None else mask.movedim(-1, 0))
    vx = V[..., 0] - vx_mean[..., None]
    w = None if mask is None else mask[..., None, :]
    pvel = gaussian_kde(torch.stack([vx, V[..., 1], V[..., 2]], -2), bins,
                        folded=True, weights=w)
    pops = state_populations(state.psi, [S_MANIFOLD, P_MANIFOLD, D_MANIFOLD])
    # vx_ions a copy: a view would hold the whole V until the group's stack
    out = dict(ekin=torch.stack([ekx, eky, ekz], -1), epot=epot,
               vx_mean=vx_mean, pvel=pvel, vx_ions=V[..., 0].contiguous(),
               pops=torch.stack(pops, -1))
    if cfg.record_snapshots or cfg.vaf_intervals or cfg.record_lccf:
        out["V"] = V
        if cfg.record_lccf:
            out["R"] = state.R
            out["J"] = current_fourier(state.R, V, kvecs)
    return out


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
    kvecs = _lccf_kvecs(cfg, sched.device)
    _, advance_sampled = _make_advance(sched)
    samples, times = [], []
    for _ in range(n_segments):
        state_mid, state = advance_sampled(state, cfg.sample_freq)
        samples.append(_sample_outputs(state_mid, cfg, L, ldeb, bins,
                                       kvecs=kvecs))
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
    out = _sample_outputs(state_mid, cfg, PlasmaUnits.box_length(cfg.n0),
                          PlasmaUnits(cfg.density, cfg.ge).debye_length,
                          folded_bins(cfg.torch_dtype, sched.device),
                          kvecs=_lccf_kvecs(cfg, sched.device))
    return state, _stack_samples([out], [state_mid.t], cfg.torch_dtype)


def _sample_fold(mid: SimState, cfg: CoolingConfig, L: float, ldeb: float,
                 bins, mask_t, kvecs) -> dict:
    """One sample of every member of a fold, ``[E, ...]``, in one pass over
    the fold: all members' potentials from one launch of kernel G (on the
    CPU, its twin member by member), the rest from one
    :func:`_sample_outputs` over ``[E, n, ...]``.  A trace shows it as the
    span ``mdqt.sample``."""
    with span("mdqt.sample"):
        epots = yukawa_potential_pallas_batched(mid.R, L, ldeb, mask_t)
        return _sample_outputs(mid, cfg, L, ldeb, bins, mask_t, epot=epots,
                               kvecs=kvecs)


def _check_sweep_flags(sched: CoolingScheduler, sweep_e0, sweep_om) -> None:
    spec = sched.fused_spec
    if (spec.per_lane_e0 != (sweep_e0 is not None)
            or spec.per_lane_om != (sweep_om is not None)):
        raise ValueError("the scheduler's per-lane flags must match the "
                         "sweep tables given (build_scheduler(..., "
                         "per_lane_e0=, per_lane_om=))")


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
    sampled reduction excludes them.  Each sample takes all members'
    potentials from one launch of kernel G (on the CPU, its twin member
    by member).  ``sweep_e0 [E, S]`` gives each
    member its own diagonal energies (a detuning sweep) and ``sweep_om [E,
    2]`` its own (om, om_dp); ``sched`` must be built with the matching
    per-lane flags.  ``seg_len`` overrides the per-segment step count
    (splice realignment, see :func:`run_compiled_span`); ``tail`` appends
    that many unsampled MD steps after the last segment.  Returns
    ``(states, outs)`` with outs ``[E, n_segments, ...]`` on the device
    (None without segments)."""
    check_uniform_tick(states.tick)
    spec = sched.fused_spec
    _check_sweep_flags(sched, sweep_e0, sweep_om)
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    bins = folded_bins(cfg.torch_dtype, sched.device)
    kvecs = _lccf_kvecs(cfg, sched.device)
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
        samples.append(_sample_fold(mid, cfg, L, ldeb, bins, mask_t, kvecs))
        times.append(mid.t)
    if tail:
        states = advance(states, tail)
    outs = (_stack_samples(samples, times, cfg.torch_dtype, axis=1)
            if samples else None)
    return states, outs


def sharded_segments(cfg: CoolingConfig, sched: CoolingScheduler, local,
                     blocks, join, home, n_segments: int, mask=None,
                     sweep_e0=None, sweep_om=None,
                     seg_len: Optional[int] = None, tail: int = 0):
    """The segment loop of a mesh run: ``local`` (a
    ``fused_local_stepper``) advances the ``[K][I]`` grid ``blocks``; at
    each output gate ``join`` joins the ``mid`` blocks on ``home`` (None
    where this process takes no samples: a rank other than 0), where the
    fold's samples are taken as :func:`run_compiled_ensemble` takes them.
    Returns ``(join(blocks), outs)``."""
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    if home is not None:
        bins = folded_bins(cfg.torch_dtype, home)
        kvecs = _lccf_kvecs(cfg, home)
        mask_t = (None if mask is None else
                  torch.as_tensor(mask).to(home, cfg.torch_dtype))
    kw = dict(mask=mask, sweep_e0=sweep_e0, sweep_om=sweep_om)
    samples, times = [], []
    for _ in range(n_segments):
        mid, blocks = local(blocks, seg_len or cfg.sample_freq,
                            split_last=True, **kw)
        mid = join(mid)
        if mid is not None:
            samples.append(_sample_fold(mid, cfg, L, ldeb, bins, mask_t,
                                        kvecs))
            times.append(mid.t)
    if tail:
        blocks = local(blocks, tail, **kw)
    outs = (_stack_samples(samples, times, cfg.torch_dtype, axis=1)
            if samples else None)
    return join(blocks), outs


def run_compiled_sharded(cfg: CoolingConfig, sched: CoolingScheduler, mesh,
                         states: SimState, n_segments: int, mask=None,
                         sweep_e0=None, sweep_om=None,
                         seg_len: Optional[int] = None, tail: int = 0,
                         ion_forces: str = "gather"):
    """:func:`run_compiled_ensemble` over a device mesh: ``states [E, N,
    ...]`` (on the mesh's home device) split into the mesh's slot blocks,
    members over ``ens`` and ions over ``ions``, each slot stepping its
    block on the production kernels (parallel/ensemble.py
    fused_local_stepper; ``ion_forces`` picks the cross-shard force
    schedule, ``"gather"`` or ``"ring_n3l"``).  A mesh that runs as ranks
    (``mesh.as_ranks``: distinct cards, or ``make_mesh(ranks=True)``)
    steps each slot in a process of its own (parallel/ranks.py); else this
    process steps every slot in turn.  Each sample joins the sampled state
    on the home device (rank 0's) and takes the same observables the
    single fold takes.  Returns ``(states, outs)`` as
    :func:`run_compiled_ensemble` does."""
    from ..parallel.ensemble import fused_local_stepper
    from ..parallel.mesh import join_state, split_state
    check_uniform_tick(states.tick)
    _check_sweep_flags(sched, sweep_e0, sweep_om)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    kw = dict(mask=mask, sweep_e0=sweep_e0, sweep_om=sweep_om,
              seg_len=seg_len, tail=tail)
    if mesh.as_ranks:
        from ..parallel.ranks import run_cooling
        return run_cooling(cfg, sched, mesh, states, n_segments, ldeb,
                           ion_forces=ion_forces, **kw)
    home = mesh.home
    local = fused_local_stepper(sched, ldeb, mesh, ion_forces=ion_forces)
    return sharded_segments(cfg, sched, local, split_state(states, mesh),
                            lambda b: join_state(b, home), home, n_segments,
                            **kw)


def _save_dir(cfg: CoolingConfig) -> str:
    return cooling_dir(cfg.save_directory, ge=cfg.ge, density=cfg.density,
                       sig0=cfg.sig0, te=cfg.te, frac_of_sig=cfg.frac_of_sig,
                       detuning=cfg.detuning, detuning_dp=cfg.detuning_dp,
                       om=cfg.om, om_dp=cfg.om_dp, n0=cfg.n0, job=cfg.job)


def latest_checkpoint(directory: str) -> Optional[int]:
    """Highest c0 among native checkpoints in a run directory."""
    return ckpt.latest_native_checkpoint(directory)


def _rng_extra(generator: Optional[torch.Generator],
               seed: Optional[torch.Tensor] = None) -> dict:
    """The generator's state and the in-kernel stream's seed word for a
    native checkpoint (no generator state when the uniforms came from a
    caller's ``rolls_fn``)."""
    extra = {} if seed is None else {"torch_rng_seed": seed.cpu().numpy()}
    if generator is None:
        return extra
    return {"torch_rng_state": generator.get_state().numpy(),
            "torch_rng_device": np.str_(generator.device.type), **extra}


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


def _seed_word(z: Optional[dict], generator: torch.Generator) -> torch.Tensor:
    """The run's seed word: the one a native checkpoint ``z`` carries, or
    a fresh draw from ``generator`` (a fresh run, or a checkpoint without
    a word: ASCII, the JAX package's, or an explicit-rolls run's)."""
    if z is not None and "torch_rng_seed" in z:
        return torch.as_tensor(np.asarray(z["torch_rng_seed"], np.int32)
                               .reshape(1)).to(generator.device)
    return draw_seed_word(generator)


def _np_float(cfg: CoolingConfig, x: float) -> float:
    return float((np.float64 if cfg.dtype == "float64" else np.float32)(x))


def run(cfg: CoolingConfig, seed: Optional[int] = None,
        state: Optional[SimState] = None, resume: bool = False,
        device="cuda", rolls_fn: Optional[Callable] = None,
        vholder0=None):
    """Execute the run on ``device``; write the reference-schema .dat tree
    and checkpoints when ``cfg.save_directory`` is set.  Returns
    ``(final, dict(outs=..., epot0=..., final=...))`` with host numpy
    values, as the JAX package's ``run`` does.

    With ``checkpoint_every_segments`` the run goes in groups of segments,
    the .dat rows streamed and a native checkpoint published after each.
    ``resume=True`` (without ``state``) continues from the newest
    checkpoint of the run directory, native or ASCII, to ``cfg.tmax``; a
    window whose tmax ended off the sample grid is realigned to the global
    gate with one partial sampled segment.  ``vholder0`` gives the VAF
    intervals' origins of an earlier window (a resume restores them from
    the checkpoint).

    Random draws come from one ``torch.Generator`` on ``device`` seeded
    with ``seed`` (default ``cfg.job``): the initial state (unless
    ``state`` is given), then the in-kernel stream's seed word (on CUDA)
    or each MD step's uniforms (on the CPU).  ``rolls_fn`` replaces the
    latter (tests replay another implementation's draws) and implies
    explicit rolls (module docstring)."""
    device = torch.device(device)
    if cfg.torch_dtype == torch.float64 and device.type != "cpu":
        raise NotImplementedError("float64 runs on the CPU only; the CUDA "
                                  "kernels are float32 (ROADMAP.md)")
    rng = _use_internal_rng(device, rolls_fn)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.job if seed is None else seed)
    save_dir = _save_dir(cfg) if cfg.save_directory is not None else None
    done, step_done, epot0, z = 0, None, None, None
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
            if vholder0 is None and cfg.vaf_intervals:
                vholder0 = resume_vholder(save_dir, c0_ascii)
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
            # intervals that began before the splice stream on from the
            # restored origins (the reference re-reads VZERO, SpeedUp.cpp:
            # 901-909)
            if vholder0 is None and "vholder" in z:
                vholder0 = z["vholder"]
    if state is None:
        state = initial_state(cfg, generator)
    rolls = None if rng else rolls_fn or uniform_rolls(generator)
    sched = build_scheduler(cfg, device, rolls)
    if rng:
        sched.seed = _seed_word(z, generator)
    rng_gen = None if rolls_fn else generator
    L = PlasmaUnits.box_length(cfg.n0)
    if epot0 is None:
        epot0 = float(yukawa_potential_pallas(
            state.R, L, PlasmaUnits(cfg.density, cfg.ge).debye_length))

    n_md = int(round(cfg.tmax / cfg.timestep))
    f = cfg.sample_freq
    n_segments = n_md // f          # output samples (global gate)
    group = cfg.checkpoint_every_segments or n_segments
    if step_done is None:
        step_done = done * f
    aligned = n_md == n_segments * f
    outs_groups = []
    vh = vholder0
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
            vh = write_outputs(save_dir, cfg, outs_np, epot0, st, n_md,
                               sample_offset=prev_done, vholder0=vh,
                               terminal=(done == n_segments and aligned),
                               rng_extra=_rng_extra(rng_gen, sched.seed))
            if done < n_segments:
                ckpt.save_native(save_dir, done * f - 1, R=st.R, V=st.V,
                                 psi=st.psi, counter=done,
                                 vholder=vh if cfg.vaf_intervals else None,
                                 extra={"epot0": epot0, "t_part": st.t_part,
                                        **_rng_extra(rng_gen, sched.seed)})
    if step_done < n_md:
        # trailing sub-segment past the last output gate: the terminal
        # checkpoint at c0 = n_md-1 holds the true tmax state
        state, _ = run_compiled_span(cfg, sched, state, n_md - step_done,
                                     sample=False)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            write_terminal_checkpoint(save_dir, cfg, state_to_numpy(state),
                                      n_md, done, epot0, vholder=vh,
                                      rng_extra=_rng_extra(rng_gen,
                                                           sched.seed))
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


def _mesh_ion_round(n_arr: int, mesh) -> int:
    """Round the fold's lane count up to the mesh's ion-shard multiple
    (the slots split the ion axis evenly; ``_mesh_ion_round(1, mesh)`` is
    the multiple itself, :func:`_poisson_member_states`'s ``round_to`` on
    fresh runs)."""
    if mesh is None:
        return n_arr
    from ..parallel.mesh import ION_AXIS
    shards = mesh.shape[ION_AXIS]
    return -(-n_arr // shards) * shards


def _stack_fold(members, cfg: CoolingConfig, device, tick: int, t: float,
                mesh=None):
    """Stack per-member host states ``(R, V, psi, t_part | None)`` into the
    ``[E, n_arr, ...]`` fold on ``device``, padded to the largest member
    (rounded up to ``mesh``'s ion-shard multiple), and build the
    Poissonian ion mask.  Returns ``(states, mask, n_js)``, mask and n_js
    None when every member fills all lanes (shared by the ASCII and native
    resume rebuilds)."""
    n_js = [len(m[0]) for m in members]
    n_arr = _mesh_ion_round(max(n_js), mesh)
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


class _ResumedFold(NamedTuple):
    states: SimState
    mask: Optional[np.ndarray]
    n_js: Optional[list]
    done: int
    step_done: int
    epot0: Optional[np.ndarray]      # [E]
    vholders: list                   # per member, None where none rides
    z: Optional[dict]                # member 0's native checkpoint


def _resume_fold(cfg, job_cfgs, job_dirs, device, generator, mesh=None):
    """Rebuild a fold from the newest checkpoint common to all job
    directories (newest format wins, as in :func:`run`).  Returns None
    when there is none, else a :class:`_ResumedFold`; members at
    inconsistent checkpoints raise."""
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
                                         _np_float(cfg, t0), mesh)
        generator.manual_seed(job_cfgs[0].job * 7919 + c0)
        # reference newRun=0 semantics per job: Epot0 stays 0, and Vholder
        # is re-read from the VZERO files (SpeedUp.cpp:901-909)
        vholders = ([resume_vholder(d, c0) for d in job_dirs]
                    if cfg.vaf_intervals else [None] * n_jobs)
        return _ResumedFold(states, mask, n_js, counters.pop(), c0 + 1,
                            np.zeros(n_jobs), vholders, None)
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
            device, tick, _np_float(cfg, tick * cfg.qdt), mesh)
        _rng_restore(generator, zs[0], job_cfgs[0].job * 7919 + c0)
        epot0 = (np.asarray([float(z["epot0"]) for z in zs])
                 if all("epot0" in z for z in zs) else None)
        return _ResumedFold(states, mask, n_js, counters.pop(), c0 + 1,
                            epot0, [z.get("vholder") for z in zs], zs[0])
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
                 states=None, rolls_fn: Optional[Callable] = None,
                 ion_forces: str = "gather"):
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
    the members' drawn start when no checkpoint is resumed.  On CUDA the
    tick kernel draws the fold's uniforms itself, all members under one
    seed word from the fold generator (their lanes keep the streams
    apart); on the CPU the fold generator draws explicit rolls.
    ``rolls_fn`` replaces the latter (tests replay another
    implementation's draws) and implies explicit rolls, as in :func:`run`.

    ``mesh`` (parallel/mesh.make_mesh) runs the fold over a mesh of
    device slots (:func:`run_compiled_sharded`): members over its ``ens``
    axis (``n_jobs`` must divide) and each member's ions over its
    ``ions`` axis (an exact-N ``n0`` must divide; Poissonian folds pad to
    the ion-shard multiple), the fold living on the mesh's home device in
    place of ``device``.  ``ion_forces`` picks the cross-shard force
    schedule, ``"gather"`` (kernel E) or ``"ring_n3l"`` (kernels C and
    F).  Files, checkpoints and resume are the single fold's: a mesh
    checkpoint resumes on the same mesh bit for bit, and resumes across
    modes (mesh <-> single fold) both ways."""
    if mesh is not None:
        from ..parallel.mesh import ENS_AXIS, ION_AXIS
        if n_jobs % mesh.shape[ENS_AXIS] or (
                cfg.exact_n and cfg.n0 % mesh.shape[ION_AXIS]):
            raise ValueError(
                f"n_jobs {n_jobs} / n0 {cfg.n0} must divide the mesh axes "
                f"{mesh.shape}")
        device = mesh.home
    if ion_forces not in ("gather", "ring_n3l"):
        raise ValueError(f"ion_forces must be 'gather' or 'ring_n3l', got "
                         f"{ion_forces!r}")
    device = torch.device(device)
    if cfg.torch_dtype == torch.float64 and device.type != "cpu":
        raise NotImplementedError("float64 runs on the CPU only; the CUDA "
                                  "kernels are float32 (ROADMAP.md)")
    rng = _use_internal_rng(device, rolls_fn)
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
    fold, z0, vholders = None, None, [None] * n_jobs
    if resume and job_dirs is not None:
        found = _resume_fold(cfg, job_cfgs, job_dirs, device, generator,
                             mesh)
        if found is not None:
            (fold, mask, n_js, done, step_done, epot0, vholders,
             z0) = found
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
            fold, mask, n_js = _poisson_member_states(
                cfg, n_jobs, seed, device, round_to=_mesh_ion_round(1, mesh))
    if fold.R.shape[0] != n_jobs:
        raise ValueError(f"the fold has {fold.R.shape[0]} members for "
                         f"{n_jobs} jobs")
    rolls = None if rng else rolls_fn or uniform_rolls(generator)
    sched = build_scheduler(cfg, device, rolls,
                            per_lane_e0=sweep_e0 is not None,
                            per_lane_om=sweep_om is not None)
    if rng:
        sched.seed = _seed_word(z0, generator)
    rng_gen = None if rolls_fn else generator
    L = PlasmaUnits.box_length(cfg.n0)
    ldeb = PlasmaUnits(cfg.density, cfg.ge).debye_length
    if epot0 is None:
        mask_t = (None if mask is None else
                  torch.as_tensor(mask).to(device, cfg.torch_dtype))
        epot0 = yukawa_potential_pallas_batched(fold.R, L, ldeb,
                                                mask_t).cpu().numpy()

    def run_fold(fold, g, **kw):
        kw.update(mask=mask, sweep_e0=sweep_e0, sweep_om=sweep_om)
        if mesh is None:
            return run_compiled_ensemble(cfg, sched, fold, g, **kw)
        return run_compiled_sharded(cfg, sched, mesh, fold, g,
                                    ion_forces=ion_forces, **kw)

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
        fold, outs = run_fold(fold, g, seg_len=seg_len, tail=tail)
        outs_np = {k: v.cpu().numpy() for k, v in outs.items()}
        outs_groups.append(outs_np)
        prev_done = done
        done += g
        step_done = done * f + tail
        if job_dirs is not None:
            st = _ensemble_numpy(fold)
            extra = _rng_extra(rng_gen, sched.seed)
            for j in range(n_jobs):
                n_j = n_js[j] if n_js is not None else None
                final_j = _member_np(st, j)
                vholders[j] = write_outputs(
                    job_dirs[j], job_cfgs[j],
                    {k: v[j] for k, v in outs_np.items()}, float(epot0[j]),
                    final_j, n_md, sample_offset=prev_done,
                    vholder0=vholders[j], terminal=(done == n_segments),
                    n_actual=n_j, rng_extra=extra)
                if done < n_segments:
                    nw = final_j.R.shape[0] if n_j is None else n_j
                    ckpt.save_native(
                        job_dirs[j], done * f - 1, R=final_j.R[:nw],
                        V=final_j.V[:nw], psi=final_j.psi[:nw],
                        counter=done,
                        vholder=vholders[j] if cfg.vaf_intervals else None,
                        extra={"epot0": float(epot0[j]),
                               "t_part": final_j.t_part[:nw], **extra})

    if step_done < n_md:
        # trailing sub-segment with no sampled segment left to carry it:
        # advance to tmax and publish the terminal checkpoints
        fold, _ = run_fold(fold, 0, tail=n_md - step_done)
        if job_dirs is not None:
            st = _ensemble_numpy(fold)
            for j in range(n_jobs):
                os.makedirs(job_dirs[j], exist_ok=True)
                write_terminal_checkpoint(
                    job_dirs[j], job_cfgs[j], _member_np(st, j), n_md, done,
                    float(epot0[j]), vholder=vholders[j],
                    n_actual=None if n_js is None else n_js[j],
                    rng_extra=_rng_extra(rng_gen, sched.seed))
    final = _ensemble_numpy(fold)
    if not outs_groups:           # resume found nothing left to do
        return final, None
    return final, {k: np.concatenate([o[k] for o in outs_groups], axis=1)
                   for k in outs_groups[0]}


def run_sweep(cfg: CoolingConfig, points, jobs_per_point: int = 1,
              seed: int = 0, resume: bool = False, mesh=None, device="cuda",
              states=None, rolls_fn: Optional[Callable] = None,
              ion_forces: str = "gather"):
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
                               states=states, rolls_fn=rolls_fn,
                               ion_forces=ion_forces)
    return final, outs, member_cfgs


def _interval_vholder(cfg: CoolingConfig, outs: dict, n: int,
                      vholder0=None, sample_offset: int = 0):
    """``[>=13, N, 3]`` VAF-interval velocity snapshots (the reference's
    Vholder, SpeedUp.cpp:133) plus ``starts``: per interval, the local
    sample index this window's VAF rows begin at, or None when the
    interval emits nothing here (the JAX package's rule,
    laser_cooling.py:1334-1380 there).

    Activity is decided by time, never by snapshot content, so an
    all-zero restored origin still streams.  Each window owns the
    half-spacing neighbourhood of its own sample grid, so an interval
    whose start falls between two windows snaps to the nearest sample
    exactly as an unwindowed run would; one starting before the run's
    first sample snaps to sample 0; one past the last sample's
    half-spacing waits for a later window.  A pre-window origin with no
    restored snapshot (``vholder0`` None) is skipped: its rows are
    already on disk."""
    m = max(13, len(cfg.vaf_intervals))
    vholder = np.zeros((m, n, 3))
    has_restored = vholder0 is not None
    if has_restored:
        v0 = np.asarray(vholder0, np.float64)
        vholder[:v0.shape[0]] = v0
    starts = [None] * m
    if not (cfg.vaf_intervals and "V" in outs):
        return vholder, starts
    t_arr = np.asarray(outs["t"], np.float64)
    d = (float(t_arr[1] - t_arr[0]) if t_arr.size > 1
         else cfg.sample_freq * cfg.timestep)
    for k, tstart in enumerate(cfg.vaf_intervals):
        if tstart >= t_arr[-1] + d / 2:
            continue         # starts in a later window (or never fires)
        if tstart >= t_arr[0] - d / 2 or (sample_offset == 0
                                          and not has_restored):
            idx = int(np.argmin(np.abs(t_arr - tstart)))  # origin here
            vholder[k] = np.asarray(outs["V"][idx], np.float64)[:n]
            starts[k] = idx
        elif has_restored:
            starts[k] = 0                # restored pre-window origin
    return vholder, starts


def write_outputs(directory: str, cfg: CoolingConfig, outs: dict,
                  epot0: float, final: NumpyState, n_md: int,
                  sample_offset: int = 0, vholder0=None,
                  terminal: bool = True, n_actual: Optional[int] = None,
                  rng_extra: Optional[dict] = None,
                  fmt=format_rows) -> np.ndarray:
    """Emit energies.dat (appended), vel_dist{X,Y,Z}_time*.dat,
    statePopulationsVsVTime*.dat, the interval diagnostics
    (VAF_interval<k>.dat, J_interval0.dat; appended) and (when
    ``terminal``) the final checkpoint, in the JAX package's (and the
    reference's) schema.  ``sample_offset`` shifts the per-sample file
    counters of a later group or window; ``vholder0`` carries the VAF
    intervals' origins of an earlier group or window (the reference
    re-reads VZERO into Vholder on restart, SpeedUp.cpp:901-909);
    ``n_actual`` cuts a Poissonian member's padded lanes off every file;
    ``fmt`` formats the .dat rows (``io.datfiles.format_rows``, the codec,
    or ``format_rows_py``).  Returns the updated vholder for the caller
    to carry on."""
    w = DatWriter(directory, fmt)
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

    # Interval VAF and the LCCF current of the pre-SpeedUp code from the
    # per-sample snapshots.  Interval origins sit on the nearest output
    # sample, within sampleFreq/2 MD steps of the reference's gate
    # (LaserCoolingPlusExpansionMDQT.cpp:1252-1362), as in the JAX package.
    vholder, starts = _interval_vholder(cfg, outs, n, vholder0,
                                        sample_offset=sample_offset)
    if cfg.vaf_intervals and "V" in outs:
        t_arr = np.asarray(outs["t"], np.float64)
        for k in range(len(cfg.vaf_intervals)):
            if starts[k] is None:
                continue
            v0 = vholder[k]
            rows = []
            for j in range(starts[k], n_samples):
                vj = np.asarray(outs["V"][j], np.float64)[:n]
                rows.append((t_arr[j], float(np.mean(np.sum(v0 * vj, -1)))))
            w.append(f"VAF_interval{k}.dat", np.asarray(rows))
    if cfg.record_lccf and "J" in outs:
        ks = np.stack(np.meshgrid(np.arange(12), np.arange(12),
                                  np.arange(12), indexing="ij"),
                      -1).reshape(-1, 3)
        for j in range(n_samples):
            J = np.asarray(outs["J"][j])
            rows = np.concatenate([
                np.full((ks.shape[0], 1),
                        (j + sample_offset) * cfg.sample_freq), ks,
                np.stack([J[0].real, J[0].imag, J[1].real, J[1].imag,
                          J[2].real, J[2].imag], -1)], axis=1)
            w.append("J_interval0.dat", rows)
    if terminal:
        write_terminal_checkpoint(directory, cfg, final, n_md,
                                  sample_offset + n_samples, epot0,
                                  vholder=vholder, n_actual=n_actual,
                                  rng_extra=rng_extra, fmt=fmt)
    return vholder


def write_terminal_checkpoint(directory: str, cfg: CoolingConfig,
                              final: NumpyState, n_md: int, counter: int,
                              epot0: float, vholder=None,
                              n_actual: Optional[int] = None,
                              rng_extra: Optional[dict] = None,
                              fmt=format_rows) -> None:
    """The reference-schema terminal checkpoint at c0 = n_md - 1
    (writeConditions, SpeedUp.cpp:725-783: the 13 VZERO interval files
    hold ``vholder``, zeros without VAF intervals as the SpeedUp main
    writes them) plus the native .npz (with t_part, which the ASCII schema
    drops, the vholder when VAF intervals are on, and the generator state
    and seed word in ``rng_extra``).  ``n_actual`` cuts padded lanes
    off; ``fmt`` formats the VZERO files."""
    n = n_actual if n_actual is not None else final.R.shape[0]
    c0 = n_md - 1
    ckpt.write_ions(directory, c0, n, counter)
    ckpt.write_conditions(directory, c0, final.R[:n], final.V[:n])
    ckpt.write_wvfns(directory, c0, final.psi[:n])
    if vholder is None:
        vholder = np.zeros((13, n, 3))
    ckpt.write_vzero(directory, c0, vholder[:13], fmt)
    ckpt.save_native(directory, c0, R=final.R[:n], V=final.V[:n],
                     psi=final.psi[:n], counter=counter,
                     vholder=vholder if cfg.vaf_intervals else None,
                     extra={"epot0": epot0, "t_part": final.t_part[:n],
                            **(rng_extra or {})})


def resume_vholder(directory: str, c0: int,
                   n_intervals: int = 13) -> np.ndarray:
    """Reference-compatible Vholder restore: the VZERO_timestep{c0}_
    interval{k}.dat snapshots of the checkpoint at ``c0`` (readConditions,
    SpeedUp.cpp:901-909), so interval VAF streams on across walltime
    windows.  Pass it as ``run(..., vholder0=...)``; ``run`` and
    ``run_ensemble`` read it themselves on an ASCII resume."""
    return ckpt.read_vzero(directory, c0, n_intervals)


def resume_state(directory: str, c0: int, cfg: CoolingConfig,
                 device="cuda") -> SimState:
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
