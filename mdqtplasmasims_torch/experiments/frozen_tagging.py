"""Frozen-gas-start quantum-trajectory velocity tagging.

Counterpart of ``mdqtplasmasims_tpu/experiments/frozen_tagging.py``
(randomFrozenStartTag{408Linear,408Quad,422Linear}.cpp, call stack
SURVEY.md 3.4): frozen (T=0) random positions undergo disorder-induced
heating under pure Yukawa MD; inside the pump window [tstart,
tstart+tpump] an optical-pumping QT engine spin-polarizes a velocity class
(no recoil); at the window's end every ion is projectively measured
(spin-up list); afterwards the tagged subset's moments, KDE velocity
distribution, and streaming VAF (or v^2 autocorrelation "LongKin" for the
408Quad variant) are recorded.

Phase structure (each a host loop over MD steps):
  A: MD + windowed pumping up to the pump end (no outputs);
  tag: projective measurement, interval snapshot, first output row;
  B: MD to tmax, output block every sample_freq MD steps (aligned to the
     reference's global (c0+1) %% sampleFreq gate).

Each MD step is one launch of a force kernel (ops/yukawa.best_forces_fn:
kernel A for one job; best_forces_fn_batched: kernel C for all members of
a fold, per-member masks included) plus elementwise leapfrog ops; the
pump window's ticks of an MD step are one launch of the tick kernel at
the leapfrog's vx (core/scheduler.free_ion_ticks; its plain twin on the
CPU), every member of a fold in it, a sweep's members through the
kernel's per-lane forms (core/scheduler.member_sweep).  The potential of
``epot0`` and of every output block comes from kernel D (kernel G: one
launch for all members of a fold).  Output blocks stay on the device until
the run ends; the host fetches once.

Measurement instant: the reference tags at the first quantum tick with
t >= tendV0 (randomFrozenStartTag422Linear.cpp:1000-1005).  Between that
tick and the enclosing MD boundary nothing but t advances (qstep is
gated off past the window; R/V change only in step()), so measuring at
the boundary is identical in content; rows carry the reference's exact
tick timestamps (:func:`tag_tick`, the gate offsets in run_phase_b),
landing on the grid the compiled binary writes.

Randomness: explicit ``torch.Generator`` objects.  A job draws its start,
then the pump ticks' uniforms (lane-major, core/scheduler.
lane_major_rolls), then the measurement's uniforms from one generator
seeded with ``seed`` (default ``cfg.job``); member j of a fold has a
generator of its own seeded with laser_cooling.member_seed ``(seed, j)``,
so a member comes out the same in a fold of any size and on any mesh.
``rolls_fn`` / ``measure_fn`` replace the two draws (tests replay the JAX
package's key chain through them).  Nothing is drawn after the tag, so a
resumed run needs no generator.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..bridge import (NumpyState, state_from_numpy, state_to_numpy,
                      states_from_numpy)
from ..core.init import frozen_gas_init, poisson_member_mask
from ..core.md import kinetic_energies
from ..core.qt import QTEngine, QTParams, sweep_member_cfgs
from ..core.scheduler import (FrozenTagScheduler, lane_major_rolls,
                              member_sweep, sweep_lanes)
from ..core.tagging import (spin_up_probability_408, spin_up_probability_422,
                            tagged_moments)
from ..io import checkpoint as ckpt
from ..io.datfiles import DatWriter
from ..io.dirs import frozen_tag_dir
from ..levels import tag408, tag422
from ..ops.correlations import streaming_long_kin, streaming_vaf
from ..ops.kde import centered_bins, centered_bins_np, gaussian_kde
from ..ops.yukawa import (best_forces_fn, best_forces_fn_batched,
                          yukawa_potential_pallas,
                          yukawa_potential_pallas_batched)
from ..state import SimState, make_state, tick_time
from ..units import (PlasmaUnits, pump_window_einstein, qt_units_408,
                     qt_units_422)
from .laser_cooling import latest_checkpoint, member_seed

VARIANTS = ("408linear", "408quad", "422linear")

# (detuning, om, tpump_seconds) as compiled into each reference file:
# randomFrozenStartTag408Linear.cpp:56-58, 408Quad.cpp:58-60,
# 422Linear.cpp:55-57
FROZEN_VARIANT_DEFAULTS = {
    "408linear": (-2.5, 0.7, 2e-7),
    "408quad": (0.0, 2.0, 1e-7),
    "422linear": (-1.0, 1.3, 1e-7),
}


@dataclasses.dataclass(frozen=True)
class FrozenTagConfig:
    """Inputs of the randomFrozenStartTag family (e.g. 422Linear:52-83).
    ``detuning``/``om``/``tpump_seconds`` default per variant to the
    values compiled into the corresponding reference file."""

    variant: str = "422linear"
    detuning: Optional[float] = None   # / gamma of the pump line
    om: Optional[float] = None
    tpump_seconds: Optional[float] = None
    tstart: float = 15.0          # tstartV0
    tmax: float = 25.0
    ge: float = 0.1
    density: float = 2.0
    n0: int = 3500
    timestep: float = 0.002
    sample_freq: int = 40
    job: int = 1
    exact_n: bool = True
    dtype: str = "float32"        # "float64" runs on the CPU only
    # the form of the force result, as ops/yukawa.best_forces_fn reads it
    # (None: forces only on CUDA, forces with the potential on the CPU)
    use_pallas: Optional[bool] = None
    save_directory: Optional[str] = None

    def __post_init__(self):
        assert self.variant in VARIANTS, self.variant
        d = FROZEN_VARIANT_DEFAULTS[self.variant]
        if self.detuning is None:
            object.__setattr__(self, "detuning", d[0])
        if self.om is None:
            object.__setattr__(self, "om", d[1])
        if self.tpump_seconds is None:
            object.__setattr__(self, "tpump_seconds", d[2])

    @property
    def units(self):
        return (qt_units_422(self.density) if self.variant == "422linear"
                else qt_units_408(self.density))

    @property
    def ratio(self) -> int:
        return self.units.ratio_frozen()

    @property
    def qdt(self) -> float:
        return self.timestep / self.ratio

    @property
    def tpump(self) -> float:
        return pump_window_einstein(self.tpump_seconds, self.density)

    @property
    def tend(self) -> float:
        return self.tstart + self.tpump

    @property
    def n_states(self) -> int:
        return 5 if self.variant == "422linear" else 7

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def np_dtype(self):
        return np.float64 if self.dtype == "float64" else np.float32

    @property
    def L(self) -> float:
        return PlasmaUnits.box_length(self.n0)

    @property
    def ldeb(self) -> float:
        return PlasmaUnits(self.density, self.ge).debye_length

    def scheme(self):
        if self.variant == "422linear":
            return tag422(self.detuning, self.om)
        return tag408(self.detuning, self.om,
                      linear=(self.variant == "408linear"))

    def scheme_unit(self):
        """The variant's scheme at detuning=om=1: the base pattern that
        sweep folds scale per member (core/qt.sweep_qt_params)."""
        if self.variant == "422linear":
            return tag422(1.0, 1.0)
        return tag408(1.0, 1.0, linear=(self.variant == "408linear"))

    def spin_up_probability(self, psi):
        if self.variant == "422linear":
            return spin_up_probability_422(psi)
        return spin_up_probability_408(psi)

    def job_dir(self) -> str:
        return frozen_tag_dir(self.save_directory,
                              tpump_seconds=self.tpump_seconds,
                              tstart=self.tstart, detuning=self.detuning,
                              om=self.om, density=self.density, ge=self.ge,
                              n0=self.n0, job=self.job)


def _check_device(cfg: FrozenTagConfig, device: torch.device) -> None:
    if cfg.torch_dtype == torch.float64 and device.type != "cpu":
        raise NotImplementedError("float64 runs on the CPU only; the CUDA "
                                  "force kernels are float32 (ROADMAP.md)")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on "
                           "the CPU")


def _forces_fn(cfg: FrozenTagConfig, n: int, mask=None, fold: bool = False):
    make = best_forces_fn_batched if fold else best_forces_fn
    return make(n, cfg.L, cfg.ldeb, mask=mask, use_pallas=cfg.use_pallas)


def build_scheduler(cfg: FrozenTagConfig,
                    rolls_fn: Optional[Callable] = None, sweep=(None, None),
                    mask=None, fold: bool = False) -> FrozenTagScheduler:
    """The stepper of one job, or with ``fold`` of ``[E, N, ...]`` states
    (one batched force launch per MD step).  ``rolls_fn(ratio, lanes)``
    gives the pump ticks' uniforms (needed by ``md_step`` only).
    ``sweep``: a sweep's per-member ``(e0 [E, S] | None, om [E] | None)``
    (core/scheduler.member_sweep); the default uses cfg's scheme.
    ``mask``: real-ion marker of padded members (``[N]``, or ``[E, N]`` in
    a fold; a tensor on the run's device): the pair kernels gate both
    sides of every pair, so padded R=V=0 lanes stay exactly inert."""
    u = cfg.units
    engine = QTEngine(cfg.scheme(), h=cfg.qdt * u.gamma_to_einstein,
                      dt_plasma=cfg.qdt,
                      plas_to_quant_vel=u.plas_to_quant_vel,
                      gamma_to_einstein=u.gamma_to_einstein,
                      apply_force=False)
    n = cfg.n0 if mask is None else mask.shape[-1]
    return FrozenTagScheduler(
        engine=engine, forces_fn=_forces_fn(cfg, n, mask, fold),
        L=cfg.L, qdt=cfg.qdt, ratio=cfg.ratio, t_pump_start=cfg.tstart,
        t_pump_end=cfg.tend, rolls_fn=rolls_fn, sweep_e0=sweep[0],
        sweep_om=sweep[1])


def _drawn_start(cfg: FrozenTagConfig, generator: torch.Generator,
                 n: Optional[int] = None) -> SimState:
    R, V, psi, _ = frozen_gas_init(generator, cfg.n0, n_states=cfg.n_states,
                                   exact_n=cfg.exact_n,
                                   dtype=cfg.torch_dtype,
                                   seed_for_count=cfg.job, n=n)
    return make_state(R, V, psi, device=generator.device,
                      dtype=cfg.torch_dtype)


def initial_state(cfg: FrozenTagConfig,
                  generator: torch.Generator) -> SimState:
    """Frozen-gas start drawn from ``generator`` on its device.  The
    reference's first step_R computes forces before its 2nd-order drift
    (randomFrozenStartTag422Linear.cpp:324-333), so F is seeded here."""
    st = _drawn_start(cfg, generator)
    F, _ = _forces_fn(cfg, st.n_ions)(st.R)
    return dataclasses.replace(st, F=F)


def resume_run(directory: str, c0: int, cfg: FrozenTagConfig,
               device="cuda"):
    """Reference-compatible restart (readConditions + spinUpIonsList,
    randomFrozenStartTag422Linear.cpp:676-764; sets recordedSpinUps=1).
    Returns ``(state, spin_up)`` on ``device``."""
    R, V = ckpt.read_conditions(directory, c0)
    spin_up = ckpt.read_spinup_list(directory, c0).astype(bool)
    if spin_up.shape[0] != R.shape[0]:
        raise ValueError(
            f"{directory}/spinUpIonsList_timestep{c0:06d}.dat has "
            f"{spin_up.shape[0]} rows for {R.shape[0]} ions — truncated "
            "or mismatched checkpoint")
    t0 = ckpt.restore_time(c0, cfg.timestep)
    st = make_state(R, V, np.zeros((R.shape[0], cfg.n_states), np.complex64),
                    device=device, dtype=cfg.torch_dtype,
                    tick=int(round(t0 / cfg.qdt)),
                    t=float(cfg.np_dtype(t0)))
    return st, torch.as_tensor(spin_up, device=device)


def run_phase_a(cfg: FrozenTagConfig, sched: FrozenTagScheduler,
                state: SimState, n_md: int) -> SimState:
    """MD up to the pump end.  The pump window [tstart, tend] is known
    ahead, so the loop splits into [pure MD | windowed MDQT | pure MD]:
    only the handful of MD steps that can overlap the window draw
    uniforms and look at their ticks (scheduler.md_step_pure)."""
    dt_md = cfg.qdt * cfg.ratio
    k_lo = max(0, min(n_md, int(cfg.tstart / dt_md) - 1))
    k_hi = max(k_lo, min(n_md, int(np.ceil(cfg.tend / dt_md)) + 1))
    for _ in range(k_lo):
        state = sched.md_step_pure(state)
    for _ in range(k_lo, k_hi):
        state = sched.md_step(state)
    for _ in range(k_hi, n_md):
        state = sched.md_step_pure(state)
    return state


def measure_rolls(generator: torch.Generator) -> Callable:
    """``measure_fn(lanes) -> [*lanes]`` uniforms of the projective
    measurement, drawn from ``generator`` on its device."""
    def measure_fn(lanes) -> torch.Tensor:
        return torch.rand(tuple(lanes), generator=generator,
                          dtype=torch.float32, device=generator.device)
    return measure_fn


def measure(cfg: FrozenTagConfig, state: SimState, measure_fn: Callable):
    """Projective spin measurement + interval snapshot (measureSpinUps).
    Returns ``(spin_up, vholder)``."""
    p = cfg.spin_up_probability(state.psi)
    spin_up = measure_fn(tuple(p.shape)).to(p.dtype) < p
    return spin_up, state.V[..., 0].clone()


def _output_block(cfg: FrozenTagConfig, state: SimState, spin_up, vholder,
                  epot0, bins, mask=None, toff: float = 0.0, epot=None):
    """One post-tag output of one job (reference output() + Zfunc/LongKin),
    on the state's device.  ``mask`` marks real ions of a padded member:
    every 1/N normalization uses the real count (padded lanes are V=0,
    psi=0 -> untagged, so they never enter the sums themselves).  The
    potential comes from kernel D unless the caller gives ``epot`` (a
    fold's members, from one launch of kernel G).

    ``toff`` maps the MD-boundary state time onto the reference's row
    timestamp.  The reference's post-tag gate fires one quantum tick
    into the block after MD step l ((c0+1)%sampleFreq==0 &&
    timeStepCounter==1, randomFrozenStartTag422Linear.cpp:1009), so its
    row carries t = l*dt + qdt while R/V/psi are the MD boundary values
    (post-window ticks only advance t; V changes only in step()): the
    label shifts, the physics content does not.  ``t`` is a host number,
    computed in the config's float type as the JAX package computes it."""
    ekx, eky, ekz, _ = kinetic_energies(state.V, mask=mask)
    if epot is None:
        epot = yukawa_potential_pallas(state.R, cfg.L, cfg.ldeb, mask)
    vx = state.V[:, 0]
    return dict(t=cfg.np_dtype(state.t) - cfg.np_dtype(toff),
                energies=torch.stack([ekx, eky, ekz, epot,
                                      ekx + eky + ekz + epot - epot0]),
                pvel_x=gaussian_kde(vx, bins, folded=False,
                                    weights=spin_up.to(vx.dtype)),
                moments=tagged_moments(vx, spin_up),
                vaf=streaming_vaf(vx, vholder, x_only=True, mask=mask),
                long_kin=streaming_long_kin(vx, vholder, mask=mask),
                n_up=torch.sum(spin_up))


def _member(states: SimState, j: int) -> SimState:
    return SimState(R=states.R[j], V=states.V[j], F=states.F[j],
                    psi=states.psi[j], t_part=states.t_part[j],
                    tick=states.tick, t=states.t)


def _output(cfg: FrozenTagConfig, state: SimState, spin_up, vholder, epot0,
            bins, mask=None, toff: float = 0.0):
    """:func:`_output_block` of one job, or of every member of a fold
    stacked ``[E, ...]``: all members' potentials from one launch of
    kernel G (on the CPU, its twin member by member)."""
    if state.R.dim() == 2:
        return _output_block(cfg, state, spin_up, vholder, epot0, bins,
                             mask=mask, toff=toff)
    epots = yukawa_potential_pallas_batched(state.R, cfg.L, cfg.ldeb, mask)
    per = [_output_block(cfg, _member(state, j), spin_up[j], vholder[j],
                         epot0[j], bins,
                         mask=None if mask is None else mask[j], toff=toff,
                         epot=epots[j])
           for j in range(state.R.shape[0])]
    out = {k: torch.stack([p[k] for p in per]) for k in per[0] if k != "t"}
    return dict(out, t=per[0]["t"])


def tag_tick(cfg: FrozenTagConfig) -> int:
    """The reference's measurement instant as a global quantum-tick
    index: the first tick with t >= tendV0
    (randomFrozenStartTag422Linear.cpp:1000: the gate is checked every
    tick, before that iteration's step()).  Between this tick and the
    enclosing MD boundary nothing but t advances (qstep is gated off at
    t >= tendV0 and step() fires only at timeStepCounter==ratio), so
    measuring at the boundary gives identical R/V/psi; only the row
    timestamp is this tick's."""
    return int(np.ceil(cfg.tend / cfg.qdt - 1e-9))


def tag_instant_output(cfg: FrozenTagConfig, state: SimState, spin_up,
                       vholder, epot0, mask=None):
    """Output block at the tag instant itself.  The reference emits it
    the moment ``t >= tendV0``: the 422 variant writes only the tau=0
    VAF row (measureSpinUps(); Zfunc(0); printVAF,
    randomFrozenStartTag422Linear.cpp:1000-1005), the 408 variants also
    call output() there (randomFrozenStartTag408Linear.cpp / 408Quad.cpp,
    same block), so energies/moments/vel_dist get a first row at the tag
    instant too.  Since ``vholder`` is the velocity snapshot just taken,
    the VAF value is the <v^2> normalization row.  The row timestamp is
    the reference's exact measurement tick (:func:`tag_tick`)."""
    bins = centered_bins(cfg.torch_dtype, state.R.device)
    n_md_a = int(np.ceil(cfg.tend / cfg.timestep))
    toff = n_md_a * cfg.timestep - tag_tick(cfg) * cfg.qdt
    return _output(cfg, state, spin_up, vholder, epot0, bins, mask=mask,
                   toff=toff)


def _stack_blocks(blocks):
    """Blocks of one run -> ``{k: [n_blocks, ...]}``, or of a fold
    (``[E, ...]`` each) -> ``{k: [E, n_blocks, ...]}``; ``t [n_blocks]``
    on the host."""
    fold = blocks[0]["energies"].dim() == 2
    outs = {k: torch.stack([b[k] for b in blocks], 1 if fold else 0)
            for k in blocks[0] if k != "t"}
    return dict(outs, t=np.asarray([b["t"] for b in blocks]))


def run_phase_b(cfg: FrozenTagConfig, sched: FrozenTagScheduler,
                state: SimState, spin_up, vholder, epot0, seg_lengths: tuple,
                mask=None, tail: int = 0):
    """Post-tag MD (entirely past the pump window: pure-MD steps) with an
    output block after each segment.  ``tail``: MD steps past the last
    sample gate up to tmax: the reference keeps stepping to tmax
    regardless of the sample grid, so the terminal checkpoint (labeled
    n_md_total-1) must include them.  Returns ``(state, outs)``, the
    blocks stacked on the device."""
    bins = centered_bins(cfg.torch_dtype, state.R.device)
    # the reference's gate fires one quantum tick into the next block
    # (t = l*dt + qdt at gate label l); state.t here is (l+1)*dt and the
    # contents are identical at both instants (see _output_block)
    toff = cfg.timestep - cfg.qdt
    blocks = []
    for seg in seg_lengths:
        for _ in range(seg):
            state = sched.md_step_pure(state)
        blocks.append(_output(cfg, state, spin_up, vholder, epot0, bins,
                              mask=mask, toff=toff))
    for _ in range(tail):
        state = sched.md_step_pure(state)
    return state, _stack_blocks(blocks)


def _gate_grid(cfg: FrozenTagConfig):
    """Post-tag sample-gate grid: (n_md_a, n_md_total, f, l0, n_lab).

    ``l0`` is the first gate label (the reference's
    (c0+1)%sampleFreq==0 gate first fires there) and ``n_lab`` the
    number of gates up to tmax.  Single source of the gate arithmetic
    for the fresh-run plan (:func:`_phase_b_plan`) and the resume
    continuation (:func:`_resume_continue`), which must stay in exact
    lockstep or resumed runs desynchronize from fresh ones."""
    n_md_a = int(np.ceil(cfg.tend / cfg.timestep))
    n_md_total = int(round(cfg.tmax / cfg.timestep))
    f = cfg.sample_freq
    l0 = n_md_a + (f - n_md_a % f) - 1
    n_lab = max(0, (n_md_total - 1 - l0) // f + 1)
    return n_md_a, n_md_total, f, l0, n_lab


def _phase_b_plan(cfg: FrozenTagConfig):
    """Shared post-tag schedule: (n_md_a, n_md_total, seg_lengths, tail).

    ``seg_lengths`` aligns output blocks to the global sample grid;
    ``tail`` is the MD steps past the last gate up to tmax, which the
    terminal checkpoint must include."""
    n_md_a, n_md_total, f, l0, n_lab = _gate_grid(cfg)
    if n_lab == 0:
        raise ValueError(
            f"tmax={cfg.tmax} ends before the first post-tag sample gate "
            f"(MD step {l0}); extend tmax past "
            f"{(l0 + 1) * cfg.timestep:g}")
    seg_lengths = (l0 - n_md_a + 1,) + (f,) * (n_lab - 1)
    tail = n_md_total - 1 - (l0 + (n_lab - 1) * f)
    return n_md_a, n_md_total, seg_lengths, tail


def _phases(cfg: FrozenTagConfig, state: SimState, rolls_fn: Callable,
            measure_fn: Callable, sweep=(None, None), mask=None):
    """All three phases of one job or one fold from its start state (F
    seeded).  Returns device values: ``(state, spin_up, epot0, out_tag,
    outs, vholder)``."""
    fold = state.R.dim() == 3
    n_md_a, _, seg_lengths, tail = _phase_b_plan(cfg)
    epot0 = (yukawa_potential_pallas_batched if fold
             else yukawa_potential_pallas)(state.R, cfg.L, cfg.ldeb, mask)
    sched = build_scheduler(cfg, rolls_fn, sweep, mask=mask, fold=fold)
    state = run_phase_a(cfg, sched, state, n_md_a)
    spin_up, vholder = measure(cfg, state, measure_fn)
    out_tag = tag_instant_output(cfg, state, spin_up, vholder, epot0,
                                 mask=mask)
    state, outs = run_phase_b(cfg, sched, state, spin_up, vholder, epot0,
                              seg_lengths, mask=mask, tail=tail)
    return state, spin_up, epot0, out_tag, outs, vholder


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


def run(cfg: FrozenTagConfig, seed: Optional[int] = None,
        resume: bool = False, device="cuda", state=None,
        rolls_fn: Optional[Callable] = None,
        measure_fn: Optional[Callable] = None):
    """One frozen-tag job on ``device``.  Returns ``(final, results)``
    with host numpy values (``results``: ``outs``, ``out_tag``,
    ``spin_up``, ``epot0``, ``final``, ``n_md_a``, ``vholder``), and
    writes the reference-schema tree under ``cfg.save_directory``.

    ``resume=True`` continues the newest checkpoint in the job's
    directory through tmax (the reference's newRun=0 walltime chaining,
    randomFrozenStartTag422Linear.cpp:987-995; post-tag only: the
    reference never persists wavefunctions for this family, so a mid-pump
    restart has no state to continue).

    ``state`` (a numpy or JAX start, F ignored) replaces the drawn start;
    ``rolls_fn`` / ``measure_fn`` replace the generator's draws (module
    docstring)."""
    device = torch.device(device)
    _check_device(cfg, device)
    if resume:
        return _resume_continue(cfg, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.job if seed is None else seed)
    if state is None:
        st = initial_state(cfg, generator)
    else:
        st = state_from_numpy(state, device=device, dtype=cfg.torch_dtype)
        st = dataclasses.replace(st, F=_forces_fn(cfg, st.n_ions)(st.R)[0])
    st, spin_up, epot0, out_tag, outs, vholder = _phases(
        cfg, st, rolls_fn or lane_major_rolls(generator),
        measure_fn or measure_rolls(generator))

    # the run's one fetch
    final = state_to_numpy(st)
    n_md_a, n_md_total, _, _ = _phase_b_plan(cfg)
    results = dict(outs=_to_numpy(outs), out_tag=_to_numpy(out_tag),
                   spin_up=spin_up.cpu().numpy(), epot0=float(epot0),
                   final=final, n_md_a=n_md_a,
                   vholder=vholder.cpu().numpy())
    if cfg.save_directory is not None:
        write_outputs(cfg.job_dir(), cfg, results, n_md_total)
    return final, results


def _resume_continue(cfg: FrozenTagConfig, device: torch.device):
    """Continue a frozen-tag job from its newest checkpoint through tmax.

    The reference restart (newRun=0) restores N/counter, SpinUpList and
    R|V, sets recordedSpinUps=1, and keeps emitting post-tag output
    blocks until the (possibly extended) tmax
    (randomFrozenStartTag422Linear.cpp:987-995,1000-1014).  From a
    native .npz checkpoint (this package's or the JAX package's) this
    also restores psi, the tag-instant velocity snapshot (so the
    streaming VAF/LongKin rows continue against the true vholder), and
    epot0 for the energy-audit column; from the ASCII schema those default
    to zero exactly as the reference's globals do after readConditions."""
    if cfg.save_directory is None:
        raise ValueError("resume needs cfg.save_directory")
    d = cfg.job_dir()
    c0_native = latest_checkpoint(d)
    c0_ascii = ckpt.latest_ascii_checkpoint(d)
    if c0_native is None and c0_ascii is None:
        raise FileNotFoundError(f"no checkpoint under {d}")
    # newest checkpoint wins across formats: after the reference binary
    # continues a run only ASCII conditions_/spinUpIonsList_ files
    # advance, and resuming from a stale native .npz would replay covered
    # steps and duplicate rows
    native = None
    if c0_native is not None and (c0_ascii is None or c0_native >= c0_ascii):
        c0 = c0_native
        native = ckpt.load_native(d, c0)
    else:
        c0 = c0_ascii

    n_md_a, n_md_total, f, l0, n_lab = _gate_grid(cfg)
    if c0 < n_md_a:
        raise ValueError(
            f"checkpoint c0={c0} precedes the pump end (MD step "
            f"{n_md_a}); the frozen-tag schema never persists mid-pump "
            "wavefunctions (reference parity) so only post-tag resume "
            "is possible")
    labels = [l0 + k * f for k in range(max(0, (c0 - l0) // f + 1), n_lab)]
    if not labels and n_md_total <= c0 + 1:
        raise ValueError(f"checkpoint c0={c0} already covers "
                         f"tmax={cfg.tmax}; extend tmax to continue")

    if native is not None:
        R, V = native["R"], native["V"]
        n = R.shape[0]
        psi = native.get("psi", np.zeros((n, cfg.n_states), np.complex64))
        spin_np = native["spin_up"].astype(bool)
        vholder = native.get("vholder", np.zeros(n))
        epot0 = float(native.get("epot0", 0.0))
        counter = int(native["counter"])
    else:
        R, V = ckpt.read_conditions(d, c0)
        n = R.shape[0]
        psi = np.zeros((n, cfg.n_states), np.complex64)
        spin_np = ckpt.read_spinup_list(d, c0).astype(bool)
        if spin_np.shape[0] != n:
            raise ValueError(
                f"{d}/spinUpIonsList_timestep{c0:06d}.dat has "
                f"{spin_np.shape[0]} rows for {n} ions — truncated or "
                "mismatched member checkpoint")
        vholder = np.zeros(n)
        epot0 = 0.0
        _, counter = ckpt.read_ions(d, c0)

    tick = (c0 + 1) * cfg.ratio
    # F stays zero: only a run's very first drift reads the carried forces
    st = make_state(R, V, psi, device=device, dtype=cfg.torch_dtype,
                    tick=tick, t=tick_time(tick, cfg.qdt, cfg.torch_dtype))
    spin_up = torch.as_tensor(spin_np, device=device)
    vholder = torch.as_tensor(np.asarray(vholder)).to(device,
                                                      cfg.torch_dtype)
    sched = build_scheduler(cfg)
    outs = None
    if labels:
        segs = (labels[0] - c0,) + (f,) * (len(labels) - 1)
        st, outs = run_phase_b(cfg, sched, st, spin_up, vholder, epot0,
                               segs, tail=n_md_total - (labels[-1] + 1))
    else:
        # tail-only extension: no sample gate fits in the new window, but
        # the reference binary would still step to tmax and republish its
        # terminal conditions: advance without output rows
        for _ in range(n_md_total - (c0 + 1)):
            st = sched.md_step_pure(st)

    outs = _to_numpy(outs)
    final = state_to_numpy(st)
    results = dict(outs=outs, spin_up=spin_np, epot0=epot0, final=final,
                   n_md_a=n_md_a, labels=labels,
                   vholder=vholder.cpu().numpy())

    w = DatWriter(d)
    if outs is not None:
        _append_streams(w, cfg, outs, outs["t"],
                        outs["long_kin" if cfg.variant == "408quad"
                             else "vaf"], labels)
    _write_checkpoint(d, n_md_total - 1, final, spin_np,
                      counter + len(labels), results["vholder"], epot0)
    return final, results


def _fold_start(cfg: FrozenTagConfig, generators, mask=None) -> SimState:
    """``[E, n_arr, ...]`` starts, member j drawn from ``generators[j]``.
    With ``mask [E, n_arr]`` the members are drawn at the padded lane
    count and their padded lanes zeroed (same L: the cell is set by N0,
    the member's count fluctuates inside it as in the reference)."""
    cfg_x = dataclasses.replace(cfg, exact_n=True)
    n_arr = None if mask is None else mask.shape[1]
    members = [_drawn_start(cfg_x, g, n=n_arr) for g in generators]
    st = SimState(**{k: torch.stack([getattr(m, k) for m in members])
                     for k in ("R", "V", "F", "psi", "t_part")})
    if mask is None:
        return st
    mc = mask[..., None]
    return dataclasses.replace(st, R=st.R * mc.to(st.R.dtype),
                               psi=st.psi * mc.to(st.psi.dtype))


def _run_batched(cfg: FrozenTagConfig, member_cfgs, seed: int,
                 sweep=(None, None), mesh=None, mask=None,
                 device="cuda", states=None,
                 rolls_fn: Optional[Callable] = None,
                 measure_fn: Optional[Callable] = None):
    """All three phases over the member axis: one batched force launch
    (kernel C) per MD step and one tick-kernel launch per pumping MD step
    serve every member, one launch of kernel G every output block; one
    fetch; each member's .dat tree under its own param-encoded directory.
    ``sweep``: ``(e0 [E, S] | None, om [E] | None)``, a sweep fold's
    per-member tables of the tick kernel's per-lane forms (core/scheduler.
    member_sweep).  ``mesh`` runs
    member block k on ens slot k (parallel/ensemble.member_sharded, no
    collectives).

    ``mask [E, n_arr]`` (host array) gives each member its own Poissonian
    ion count inside the fixed-shape fold (the reference's init draws a
    fresh N per array job, randomFrozenStartTag422Linear.cpp:245-303):
    members are padded to the largest draw, padded lanes start R=V=psi=0
    and stay exactly inert (both-side pair-kernel masking; dp=0 never
    jumps), and every 1/N normalization uses the member's real count.
    Results are cut to each member's real N."""
    device = torch.device(mesh.home if mesh is not None else device)
    _check_device(cfg, device)
    if mesh is not None and (rolls_fn or measure_fn):
        raise ValueError("rolls_fn / measure_fn replay one fold's draws and "
                         "cannot be split over a mesh")
    E = len(member_cfgs)
    n_md_a, n_md_total, _, _ = _phase_b_plan(cfg)
    n_arr = cfg.n0 if mask is None else mask.shape[1]
    rdtype = cfg.torch_dtype

    def fold(idx, start, e0, om, mk):
        """Members ``idx`` on idx's device; every tensor argument carries
        the member axis (the form member_sharded splits), None where the
        fold has none."""
        dev = idx.device
        generators = [torch.Generator(device=dev).manual_seed(
            member_seed(seed, j)) for j in idx.tolist()]
        st = (_fold_start(cfg, generators, mk) if start is None
              else SimState(**start))
        st = dataclasses.replace(
            st, F=_forces_fn(cfg, n_arr, mk, fold=True)(st.R)[0])
        rf = rolls_fn or _fold_rolls(generators)
        mf = measure_fn or _fold_measure(generators)
        st, spin_up, epot0, out_tag, outs, vholder = _phases(
            cfg, st, rf, mf, (e0, om), mk)
        fields = {k: getattr(st, k) for k in ("R", "V", "F", "psi", "t_part")}
        return fields, spin_up, epot0, out_tag, outs, vholder, (st.tick,
                                                                 st.t)

    start = None
    if states is not None:
        given = states_from_numpy(states, device=device, dtype=rdtype)
        if tuple(given.R.shape) != (E, n_arr, 3):
            raise ValueError(f"want states of {(E, n_arr, 3)}, got "
                             f"{tuple(given.R.shape)}")
        start = {k: getattr(given, k)
                 for k in ("R", "V", "F", "psi", "t_part")}
    mask_t = (None if mask is None
              else torch.as_tensor(np.asarray(mask)).to(device, rdtype))
    args = (torch.arange(E, device=device), start, *sweep, mask_t)
    fn = fold
    if mesh is not None:
        from ..parallel.ensemble import member_sharded
        fn = member_sharded(fold, mesh)
    fields, spin_up, epot0, out_tag, outs, vholder, (tick, t) = fn(*args)

    # the fold's one fetch
    final_np = NumpyState(**_to_numpy(fields), tick=tick, t=t)
    outs_np, out_tag_np = _to_numpy(outs), _to_numpy(out_tag)
    spin_np, epot0_np = spin_up.cpu().numpy(), epot0.cpu().numpy()
    vhold_np = vholder.cpu().numpy()
    n_js = (None if mask is None
            else np.asarray(mask).sum(axis=1).astype(int))

    def member(tree, j):
        return {k: (v if k == "t" else v[j]) for k, v in tree.items()}

    results = []
    for j, mcfg in enumerate(member_cfgs):
        nj = n_arr if n_js is None else int(n_js[j])
        # checkpoints and the spin list carry the member's real N
        final_j = NumpyState(*(x[j][:nj] for x in final_np[:5]), tick=tick,
                             t=t)
        res = dict(outs=member(outs_np, j), out_tag=member(out_tag_np, j),
                   spin_up=spin_np[j][:nj], epot0=float(epot0_np[j]),
                   final=final_j, n_md_a=n_md_a, vholder=vhold_np[j][:nj])
        if n_js is not None:
            res["n_ions"] = nj
        results.append(res)
        if mcfg.save_directory is not None:
            write_outputs(mcfg.job_dir(), mcfg, res, n_md_total)
    return results


def _fold_rolls(generators) -> Callable:
    """The fold's pump-tick uniforms ``[ratio, 5, E, n]``, member j's
    lane-major block from generator j."""
    fns = [lane_major_rolls(g) for g in generators]

    def rolls_fn(ratio: int, lanes) -> torch.Tensor:
        return torch.stack([fn(ratio, lanes[1:]) for fn in fns], dim=2)
    return rolls_fn


def _fold_measure(generators) -> Callable:
    fns = [measure_rolls(g) for g in generators]

    def measure_fn(lanes) -> torch.Tensor:
        return torch.stack([fn(lanes[1:]) for fn in fns])
    return measure_fn


def run_ensemble(cfg: FrozenTagConfig, n_jobs: int, seed: int = 0,
                 mesh=None, resume: bool = False, device="cuda",
                 states=None, rolls_fn: Optional[Callable] = None,
                 measure_fn: Optional[Callable] = None):
    """Batched job array: the replacement for the reference's SLURM array
    over randomFrozenStartTag* jobs (README.md:63: pooled statistics need
    10+ jobs).  Per-job .dat trees land in ``job<k>/`` exactly as the
    array jobs' would.  Returns the per-job results list.  ``mesh``
    spreads jobs over the mesh's ``ens`` slots.  With
    ``cfg.exact_n=False`` every member draws its own Poissonian ion count
    as the reference's array jobs do
    (randomFrozenStartTag422Linear.cpp:245-303), carried as per-member
    masks inside one fixed-shape fold (see :func:`_run_batched`).

    ``resume=True`` continues every job's newest checkpoint through an
    extended tmax (per-job newRun=0 chaining, see
    :func:`_resume_continue`), one job after the other.  ``states`` (a
    stacked numpy or JAX start ``[E, n, ...]``), ``rolls_fn`` and
    ``measure_fn`` as in :func:`run`."""
    if resume:
        if mesh is not None:
            # each job continues from its own checkpoint (formats and ion
            # counts can differ per job), which does not fold into one
            # fixed-shape program: be loud rather than silently
            # serializing what the caller asked to spread over devices
            warnings.warn(
                "frozen-tag run_ensemble(resume=True) continues jobs one "
                "after the other on the mesh's home device; the mesh is "
                "not used on resume", stacklevel=2)
            device = mesh.home
        return [run(dataclasses.replace(cfg, job=j + 1), resume=True,
                    device=device)[1] for j in range(n_jobs)]
    member_cfgs = [dataclasses.replace(cfg, job=j + 1)
                   for j in range(n_jobs)]
    mask = None if cfg.exact_n else _poisson_mask(cfg.n0, n_jobs, seed)
    return _run_batched(cfg, member_cfgs, seed, mesh=mesh, mask=mask,
                        device=device, states=states, rolls_fn=rolls_fn,
                        measure_fn=measure_fn)


def _poisson_mask(n0: int, n_members: int, seed: int) -> np.ndarray:
    """[E, max(N_j)] real-ion mask with per-member Poissonian counts
    (the reference's per-job init draw, SURVEY.md L2; the JAX package's
    counts for the same seed)."""
    return poisson_member_mask(n0, n_members, seed)[0]


def run_sweep(cfg: FrozenTagConfig, points, jobs_per_point: int = 1,
              seed: int = 0, mesh=None, device="cuda", states=None,
              rolls_fn: Optional[Callable] = None,
              measure_fn: Optional[Callable] = None,
              qt_params: Optional[QTParams] = None):
    """A pump-laser (detuning, om) grid as ONE fold.

    The reference compiles the pump detuning and Rabi frequency into each
    tagging binary (randomFrozenStartTag422Linear.cpp:55-57) and rebuilds
    per point; mapping the tagged velocity class vs detuning therefore
    costs a rebuild + SLURM array per point.  The pump Hamiltonian is
    linear in both knobs, so each member carries its own tables through
    the fold's pump window, in the tick kernel's per-lane forms (its own
    scheme's e0 where a detuning differs from cfg's, the scheme's coupling
    scaled by om/cfg.om where a Rabi frequency does; core/scheduler.
    member_sweep): every grid point costs one more member.

    ``points``: dicts with keys among ``detuning``/``om`` (unset fields
    keep cfg's value).  ``jobs_per_point`` replicates each point with
    independent seeds; member order is point-major.  With
    ``cfg.save_directory`` set, each member writes the full reference
    .dat tree under its own detuning/om-encoded directory.  With
    ``cfg.exact_n=False`` every member additionally draws its own
    Poissonian ion count (per-member masks, as run_ensemble).
    ``qt_params`` replaces the tables built from the points
    (``[E]``-batched, bridge.qt_params_from_numpy; core/scheduler.
    sweep_lanes checks that its couplings are cfg's scaled).  Returns
    ``(results, member_cfgs)``."""
    dev = torch.device(mesh.home if mesh is not None else device)
    member_cfgs = sweep_member_cfgs(cfg, points, jobs_per_point)
    oms = [m.om for m in member_cfgs]
    sweep = (member_sweep(cfg.scheme(), cfg.om,
                          [m.scheme() for m in member_cfgs], oms,
                          cfg.torch_dtype, dev) if qt_params is None
             else sweep_lanes(cfg.scheme(), cfg.om, qt_params, oms))
    mask = (None if cfg.exact_n
            else _poisson_mask(cfg.n0, len(member_cfgs), seed))
    results = _run_batched(
        cfg, member_cfgs, seed, sweep=sweep, mesh=mesh, mask=mask,
        device=device, states=states, rolls_fn=rolls_fn,
        measure_fn=measure_fn)
    return results, member_cfgs


def _append_streams(w: DatWriter, cfg: FrozenTagConfig, outs: dict, ac_t,
                    ac, labels) -> None:
    """Append the energies/taggedMoments rows of ``outs``, the
    autocorrelation rows ``(ac_t, ac)`` (``vSquareAutoCorr.dat`` for
    408quad, else ``VAF.dat``), and write one vel_distX file per block
    under its MD-step label."""
    bins = centered_bins_np()
    w.append("energies.dat",
             np.concatenate([outs["t"][:, None], outs["energies"]], axis=1))
    w.append("taggedMoments.dat",
             np.concatenate([outs["t"][:, None], outs["moments"]], axis=1))
    w.append("vSquareAutoCorr.dat" if cfg.variant == "408quad"
             else "VAF.dat", np.stack([ac_t, ac], -1))
    for k, lab in enumerate(labels):
        w.write(f"vel_distX_timestep{lab:06d}.dat",
                np.stack([bins, outs["pvel_x"][k]], -1))


def _write_checkpoint(directory: str, c0: int, final: NumpyState, spin_up,
                      counter: int, vholder, epot0: float) -> None:
    """The terminal checkpoint at ``c0``: the reference's ASCII schema
    (ions_, conditions_, spinUpIonsList_) and the native .npz, which both
    packages read (psi, spin_up, vholder, and epot0 ride it)."""
    n = final.R.shape[0]
    ckpt.write_ions(directory, c0, n, counter)
    ckpt.write_conditions(directory, c0, final.R, final.V)
    ckpt.write_spinup_list(directory, c0, spin_up.astype(int))
    ckpt.save_native(directory, c0, R=final.R, V=final.V, psi=final.psi,
                     counter=counter, spin_up=spin_up, vholder=vholder,
                     extra={"epot0": epot0})


def write_outputs(directory: str, cfg: FrozenTagConfig, res: dict,
                  n_md_total: int) -> None:
    w = DatWriter(directory)
    outs = res["outs"]
    out_tag = res["out_tag"]

    # tag-instant emission: the VAF/LongKin tau=0 normalization row for
    # every variant; the 408 variants additionally call output() there
    # (see tag_instant_output) so their other streams get the row too.
    full_tag_row = cfg.variant != "422linear"
    if full_tag_row:
        outs = {k: np.concatenate([np.asarray(out_tag[k])[None], v])
                for k, v in outs.items()}
        ac_t = outs["t"]
        ac = outs["long_kin" if cfg.variant == "408quad" else "vaf"]
    else:
        # only 422linear reaches here (full_tag_row covers the 408s),
        # and its autocorrelation stream is the x-only VAF
        ac_t = np.concatenate([[out_tag["t"]], outs["t"]])
        ac = np.concatenate([[out_tag["vaf"]], outs["vaf"]])
    n_samples = outs["t"].shape[0]

    # c0 at the measurement instant: the reference has completed
    # n_md_a = ceil(tend/dt) step() calls there and its counter runs one
    # behind (init sets c0=-1, randomFrozenStartTag422Linear.cpp:302), so
    # measureSpinUps names the file with c0 = n_md_a - 1 (:617)
    c0_tag = res["n_md_a"] - 1
    w.write_text(f"spinUpIons_timestep{c0_tag:06d}.dat",
                 str(int(out_tag["n_up"])))

    # File numbering matches the reference's global MD-step counter: the
    # output gate (c0+1)%sampleFreq==0 (randomFrozenStartTag422Linear.cpp
    # :1009) first fires at c0 = n_md_a + first - 1 and then every
    # sampleFreq steps; the 408 variants additionally emit at the tag
    # instant itself, labeled c0_tag = n_md_a - 1 (the reference's
    # counter runs one behind its completed step() calls, see the c0_tag
    # derivation above).
    f = cfg.sample_freq
    first_len = f - (res["n_md_a"] % f)
    labels = [res["n_md_a"] + first_len - 1 + j * f
              for j in range(n_samples)]
    if full_tag_row:
        labels = [c0_tag] + labels[:-1]
    _append_streams(w, cfg, outs, ac_t, ac, labels)
    _write_checkpoint(directory, n_md_total - 1, res["final"],
                      res["spin_up"], n_samples, res.get("vholder"),
                      res["epot0"])
