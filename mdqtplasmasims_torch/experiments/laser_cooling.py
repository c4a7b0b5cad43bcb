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
device and stacked; the host fetches them once per run and writes the
reference-schema .dat files.

Not ported yet (raise): ``resume``, periodic checkpoints, ``exact_n=False``,
float64 on CUDA.
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

from ..bridge import NumpyState, state_to_numpy
from ..core.init import frozen_gas_init
from ..core.md import kinetic_energies
from ..core.qt import QTEngine, state_populations
from ..core.qt_fused import FusedTickSpec
from ..core.scheduler import CoolingScheduler, auto_qt_tile, uniform_rolls
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
    exact_n: bool = True          # pin N = n0 (False is not ported yet)
    dtype: str = "float32"        # "float64" runs on the CPU only
    save_directory: Optional[str] = None   # base dir; None = no file output
    checkpoint_every_segments: int = 0     # periodic checkpoints: not ported

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


def expansion_coeffs(cfg: CoolingConfig):
    """(c1, c2) of the expanding-frame detuning c1*t/sqrt(1+c2*t^2)
    (SpeedUp.cpp:447)."""
    c1 = 0.0126 * cfg.frac_of_sig * cfg.te / (math.sqrt(cfg.density) * cfg.sig0)
    c2 = 0.00014314 * cfg.te / (cfg.density * cfg.sig0 ** 2)
    return c1, c2


def build_scheduler(cfg: CoolingConfig, device,
                    rolls_fn: Callable) -> CoolingScheduler:
    """The run's stepper on ``device``; ``rolls_fn(n_ticks, npad)`` gives
    each MD step's uniforms (:func:`uniform_rolls` of a seeded generator
    in :func:`run`)."""
    engine = build_engine(cfg)
    L = PlasmaUnits.box_length(cfg.n0)
    c1, c2 = expansion_coeffs(cfg) if cfg.frac_of_sig else (0.0, 0.0)
    spec = FusedTickSpec(
        scheme=engine.scheme, h=engine.h, qdt=cfg.qdt,
        plas_to_quant_vel=engine.plas_to_quant_vel,
        gamma_to_einstein=engine.gamma_to_einstein, ratio=cfg.ratio, L=L,
        apply_force=True, exp_c1=c1, exp_c2=c2,
        renormalize=cfg.renormalize)
    return CoolingScheduler(
        fused_spec=spec, L=L,
        ldeb=PlasmaUnits(cfg.density, cfg.ge).debye_length, qdt=cfg.qdt,
        ratio=cfg.ratio, tile=auto_qt_tile(cfg.n0),
        device=torch.device(device), rolls_fn=rolls_fn,
        dtype=cfg.torch_dtype)


def initial_state(cfg: CoolingConfig,
                  generator: torch.Generator) -> SimState:
    """Frozen-gas start drawn from ``generator`` on its device."""
    R, V, psi, _ = frozen_gas_init(generator, cfg.n0, n_states=12,
                                   exact_n=cfg.exact_n,
                                   dtype=cfg.torch_dtype,
                                   seed_for_count=cfg.job)
    return make_state(R, V, psi, device=generator.device,
                      dtype=cfg.torch_dtype)


def _sample_outputs(state: SimState, L: float, ldeb: float,
                    bins: torch.Tensor) -> dict:
    """Observables of one output sample (reference output()), on the
    state's device."""
    ekx, eky, ekz, vx_mean = kinetic_energies(state.V, subtract_mean_vx=True)
    vx = state.V[:, 0] - vx_mean
    pvel = torch.stack([gaussian_kde(vx, bins, folded=True),
                        gaussian_kde(state.V[:, 1], bins, folded=True),
                        gaussian_kde(state.V[:, 2], bins, folded=True)])
    pops = state_populations(state.psi, [S_MANIFOLD, P_MANIFOLD, D_MANIFOLD])
    return dict(ekin=torch.stack([ekx, eky, ekz]),
                epot=yukawa_potential(state.R, L, ldeb), vx_mean=vx_mean,
                pvel=pvel, vx_ions=state.V[:, 0], pops=torch.stack(pops, -1))


def _make_advance(sched: CoolingScheduler):
    """``(advance, advance_sampled)``, shared by :func:`run_compiled` and
    :func:`run_compiled_span` so the off-grid span cannot diverge from the
    segment path.

    ``advance(state, n_steps)`` runs whole MD steps;
    ``advance_sampled(state, n_steps) -> (state_mid, state_end)`` splits
    the LAST MD step at the reference's output instant, one quantum tick
    in (SpeedUp.cpp:1365-1368), and completes it with the same forces."""
    def advance(state, n_steps):
        forces = sched.soa_forces_fn(state.n_ions)
        carry = sched.soa_init(state)
        for _ in range(n_steps):
            carry = sched.soa_md_step(carry, forces)
        return sched.soa_restore(carry, state)

    def advance_sampled(state, n_steps):
        forces = sched.soa_forces_fn(state.n_ions)
        carry = sched.soa_init(state)
        for _ in range(n_steps - 1):
            carry = sched.soa_md_step(carry, forces)
        carry = sched.soa_md_step(carry, forces, n_ticks=1)
        state_mid = sched.soa_restore(carry, state)
        if sched.ratio > 1:
            carry = sched.soa_md_step(carry, forces, n_ticks=sched.ratio - 1,
                                      reuse_forces=True)
        return state_mid, sched.soa_restore(carry, state)
    return advance, advance_sampled


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
    outs = {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
    outs["t"] = torch.tensor(times, dtype=cfg.torch_dtype)
    return state, outs


def run_compiled_span(sched: CoolingScheduler, state: SimState,
                      n_steps: int) -> SimState:
    """``n_steps`` MD steps off the sample grid, unsampled.  The reference
    runs to tmax regardless of sample-grid alignment (while t <=
    tmax+0.0009, SpeedUp.cpp:1247), so a run whose tmax is not a multiple
    of sampleFreq*dt ends with such a span.  (The JAX package's sampled
    variant realigns resumed runs; resume is not ported yet.)"""
    advance, _ = _make_advance(sched)
    return advance(state, n_steps)


def _save_dir(cfg: CoolingConfig) -> str:
    return cooling_dir(cfg.save_directory, ge=cfg.ge, density=cfg.density,
                       sig0=cfg.sig0, te=cfg.te, frac_of_sig=cfg.frac_of_sig,
                       detuning=cfg.detuning, detuning_dp=cfg.detuning_dp,
                       om=cfg.om, om_dp=cfg.om_dp, n0=cfg.n0, job=cfg.job)


def run(cfg: CoolingConfig, seed: Optional[int] = None,
        state: Optional[SimState] = None, resume: bool = False,
        device="cuda", rolls_fn: Optional[Callable] = None):
    """Execute a fresh run on ``device``; write the reference-schema .dat
    tree and the terminal checkpoint when ``cfg.save_directory`` is set.
    Returns ``(final, dict(outs=..., epot0=..., final=...))`` with host
    numpy values, as the JAX package's ``run`` does.

    Random draws come from one ``torch.Generator`` on ``device`` seeded
    with ``seed`` (default ``cfg.job``): the initial state (unless
    ``state`` is given), then each MD step's uniforms.  ``rolls_fn``
    replaces the latter (tests replay another implementation's draws)."""
    if resume:
        raise NotImplementedError("resume is not ported yet (ROADMAP.md)")
    if cfg.checkpoint_every_segments:
        raise NotImplementedError("periodic checkpoints are not ported yet "
                                  "(ROADMAP.md)")
    if not cfg.exact_n:
        raise NotImplementedError("exact_n=False is not ported yet "
                                  "(ROADMAP.md)")
    device = torch.device(device)
    if cfg.torch_dtype == torch.float64 and device.type != "cpu":
        raise NotImplementedError("float64 runs on the CPU only; the CUDA "
                                  "kernels are float32 (ROADMAP.md)")
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.job if seed is None else seed)
    if state is None:
        state = initial_state(cfg, generator)
    sched = build_scheduler(cfg, device, rolls_fn or uniform_rolls(generator))
    L = PlasmaUnits.box_length(cfg.n0)
    epot0 = float(yukawa_potential(state.R, L,
                                   PlasmaUnits(cfg.density,
                                               cfg.ge).debye_length))
    save_dir = _save_dir(cfg) if cfg.save_directory is not None else None

    n_md = int(round(cfg.tmax / cfg.timestep))
    f = cfg.sample_freq
    n_segments = n_md // f          # output samples (global gate)
    outs = None
    if n_segments:
        state, outs_dev = run_compiled(cfg, sched, state, n_segments)
        outs = {k: v.cpu().numpy() for k, v in outs_dev.items()}
        if save_dir is not None:
            write_outputs(save_dir, cfg, outs, epot0, state_to_numpy(state),
                          n_md, terminal=(n_md == n_segments * f))
    if n_segments * f < n_md:
        # trailing sub-segment past the last output gate: the terminal
        # checkpoint at c0 = n_md-1 holds the true tmax state
        state = run_compiled_span(sched, state, n_md - n_segments * f)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            write_terminal_checkpoint(save_dir, cfg, state_to_numpy(state),
                                      n_md, n_segments, epot0)
    final = state_to_numpy(state)
    return final, dict(outs=outs, epot0=epot0, final=final)


def write_outputs(directory: str, cfg: CoolingConfig, outs: dict,
                  epot0: float, final: NumpyState, n_md: int,
                  terminal: bool = True) -> None:
    """Emit energies.dat, vel_dist{X,Y,Z}_time*.dat,
    statePopulationsVsVTime*.dat and (when ``terminal``) the final
    checkpoint, in the JAX package's (and the reference's) schema."""
    w = DatWriter(directory)
    bins = folded_bins_np()
    n_samples = outs["t"].shape[0]
    n = final.R.shape[0]
    energies = np.zeros((n_samples, 7))
    for kk in range(n_samples):
        ekx, eky, ekz = (float(x) for x in outs["ekin"][kk])
        epot = float(outs["epot"][kk])
        vxm = float(outs["vx_mean"][kk])
        energies[kk] = (float(outs["t"][kk]), ekx, eky, ekz, epot,
                        ekx + eky + ekz + epot - epot0, vxm)
        pv = outs["pvel"][kk]
        w.write(f"vel_distX_time{kk:06d}.dat",
                np.stack([bins + vxm, pv[0]], axis=-1))
        w.write(f"vel_distY_time{kk:06d}.dat", np.stack([bins, pv[1]], axis=-1))
        w.write(f"vel_distZ_time{kk:06d}.dat", np.stack([bins, pv[2]], axis=-1))
        w.write(f"statePopulationsVsVTime{kk:06d}.dat",
                np.concatenate([outs["vx_ions"][kk][:n, None],
                                outs["pops"][kk][:n]], axis=-1))
    w.append("energies.dat", energies)
    if terminal:
        write_terminal_checkpoint(directory, cfg, final, n_md, n_samples,
                                  epot0)


def write_terminal_checkpoint(directory: str, cfg: CoolingConfig,
                              final: NumpyState, n_md: int, counter: int,
                              epot0: float) -> None:
    """The reference-schema terminal checkpoint at c0 = n_md - 1
    (writeConditions, SpeedUp.cpp:725-783; the 13 VZERO interval files
    are zeros, as the SpeedUp main writes them) plus the native .npz
    (with t_part, which the ASCII schema drops)."""
    n = final.R.shape[0]
    c0 = n_md - 1
    ckpt.write_ions(directory, c0, n, counter)
    ckpt.write_conditions(directory, c0, final.R, final.V)
    ckpt.write_wvfns(directory, c0, final.psi)
    ckpt.write_vzero(directory, c0, np.zeros((13, n, 3)))
    ckpt.save_native(directory, c0, R=final.R, V=final.V, psi=final.psi,
                     counter=counter,
                     extra={"epot0": epot0, "t_part": final.t_part})
