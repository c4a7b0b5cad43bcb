"""Multirate schedulers.  :class:`CoolingScheduler` is the SpeedUp scheme
of the cooling family: forces once per MD step, drift/kick and the quantum
update at the quantum substep
(laserCoolingPlusExpansionMDQTSpeedUp.cpp:1365-1378).
:class:`FrozenTagScheduler` is the frozen-start tagging family's: full-dt
leapfrog MD with the pump's quantum ticks inside a time window;
:class:`MCTagScheduler` (at the end of the module) the MC-tagging
family's pump stepper: ``ratio`` pump ticks, then one velocity-Verlet
step.  The pumps' ticks and the three-state toy's go through the same
tick kernel as the cooling family's (:func:`free_ion_ticks`: ions that
feel no force, at a fixed vx for the pumps), one launch per window.

Counterpart of ``mdqtplasmasims_tpu/core/scheduler.py``.  The port
has one stepping path on every device: the state stays in the kernels'
lane layout for a whole sampling segment (``soa_init -> soa_md_step x k ->
soa_restore``), and each MD step is one force launch plus one fused tick
launch.  The loop runs on the host; ``tick`` is a host int, so a step
makes no device-to-host sync.

An ensemble of E independent trajectories folds into the same layout
(``soa_ens_*``): member blocks of Np lanes sit side by side on the lane
axis of ``[rows, E*Np]`` planes, one batched force launch (kernel C) and
one tick launch serve the whole fold per MD step, and one ``rolls_fn(nt,
E*Np)`` draw supplies its uniforms.  The members share one tick.

Uniforms come in one of two forms, fixed by ``fused_spec.internal_rng``:
explicit rolls drawn by ``rolls_fn`` before every MD step, or the tick
kernel's own counter-based stream (core/rng.py), for which the carry holds
the run's seed word and nothing is drawn per MD step.  The JAX package
draws a fresh word per sampling segment because its hardware seed aliases
the tick modulo 2**20; the port's counter holds the absolute tick, so one
word per run suffices, and a resumed run that reuses the word replays the
uninterrupted run's stream whatever its segment boundaries.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..levels import LevelScheme
from ..profiling import span
from ..state import SimState, complex_dtype, tick_time
from ..ops.yukawa import yukawa_forces_n3l_soa, yukawa_forces_n3l_soa_batched
from .md import step_R, wrap_pbc
from .qt import QTEngine, QTParams
from .qt_fused import (FusedTickSpec, fused_md_substeps, fused_tables,
                       rabi_scaled)

#: Candidate ion-lane paddings (multiples of 128; 3584 covers the flagship
#: N0=3500).  Kept from the JAX package so both pad to the same widths.
_QT_TILE_CANDIDATES = (512, 896, 1024, 1792, 3584)


def auto_qt_tile(n: int) -> int:
    """Lane tile the SoA planes are padded to: among the candidate widths
    with the least padding, the largest one that still leaves >= 2 tiles
    (the JAX package's rule, so ``_npad`` agrees with it)."""
    min_npad = min(-(-max(n, t) // t) * t for t in _QT_TILE_CANDIDATES)
    fitting = [t for t in _QT_TILE_CANDIDATES
               if -(-max(n, t) // t) * t == min_npad]
    pipelined = [t for t in fitting if min_npad // t >= 2]
    return max(pipelined or fitting)


def check_uniform_tick(tick) -> None:
    """The fold precondition: every member of an ensemble fold shares one
    tick (the fold applies one first-step drift flag and one expansion
    clock).  ``tick`` is an int or a per-member array."""
    t = np.asarray(tick)
    if t.size and (t != t.flat[0]).any():
        raise ValueError(
            "fused ensemble fold requires a uniform tick across members "
            f"(got {np.unique(t)}); do not fold members resumed from "
            "different checkpoints")


def fold_sweep_lanes(fused_spec: FusedTickSpec, npad: int, sweep_e0=None,
                     sweep_om=None, device=None, dtype=torch.float32):
    """Per-member sweep tables in the kernels' lane layout, the one source
    of the fold's E-major lane order: ``sweep_e0 [E, S]`` member diagonal
    energies -> ``[SP, E*npad]``; ``sweep_om [E, 2]`` member (om, om_dp)
    -> ``[2, E*npad]``.  The inputs are arrays or tensors; the planes are
    ``dtype`` on ``device`` (the input's device when None), each None when
    its input is."""
    def table(x):
        x = x if torch.is_tensor(x) else np.asarray(x, np.float64)
        return torch.as_tensor(x, dtype=dtype, device=device)

    e0p = omp = None
    if sweep_e0 is not None:
        e0 = table(sweep_e0)
        E, S = e0.shape
        e0p = e0.new_zeros((fused_spec.SP, E, npad))
        e0p[:S] = e0.T[:, :, None]
        e0p = e0p.reshape(fused_spec.SP, E * npad)
    if sweep_om is not None:
        om = table(sweep_om)
        omp = om.T[:, :, None].expand(2, om.shape[0], npad)
        omp = omp.reshape(2, -1).contiguous()
    return e0p, omp


def draw_seed_word(generator: torch.Generator) -> torch.Tensor:
    """The run's seed word of the in-kernel stream: one 31-bit draw from
    ``generator``, kept as a ``[1]`` int32 tensor on its device (no host
    sync)."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


class UniformRolls:
    """``rolls_fn`` drawing ``[n_ticks*5, npad]`` uniforms in [0, 1) from
    ``generator`` on its device (no host sync).  It pickles with the
    generator's device and state: a mesh's ranks each draw from a copy
    (parallel/ranks.py)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, n_ticks: int, npad: int) -> torch.Tensor:
        return torch.rand((n_ticks * 5, npad), generator=self.generator,
                          dtype=torch.float32, device=self.generator.device)

    def __reduce__(self):
        return (_uniform_rolls_at, (str(self.generator.device),
                                    self.generator.get_state()))


def _uniform_rolls_at(device: str, state: torch.Tensor) -> UniformRolls:
    g = torch.Generator(device=device)
    g.set_state(state)
    return UniformRolls(g)


def uniform_rolls(generator: torch.Generator) -> UniformRolls:
    """``rolls_fn`` drawing ``[n_ticks*5, npad]`` uniforms in [0, 1) from
    ``generator`` (:class:`UniformRolls`)."""
    return UniformRolls(generator)


class SoACarry(NamedTuple):
    """A segment's state in the kernels' lane layout."""
    R: torch.Tensor        # [3, Np]
    V: torch.Tensor        # [3, Np]
    F: torch.Tensor        # [3, Np] forces of the last refresh
    tp: torch.Tensor       # [1, Np]
    psi_re: torch.Tensor   # [SP, Np]
    psi_im: torch.Tensor   # [SP, Np]
    tick: int
    seed: Optional[torch.Tensor] = None   # [1] int32, in-kernel RNG only


@dataclasses.dataclass
class CoolingScheduler:
    """SpeedUp-scheme stepper: quantum-substepped leapfrog.

    Without ``fused_spec.internal_rng``, ``rolls_fn(n_ticks, npad)``
    supplies each MD step's uniforms; it is then the scheduler's only
    source of randomness, so a test can replay another implementation's
    draws through it.  With it, ``seed`` (:func:`draw_seed_word`) is the
    run's word of the kernel's stream and rides every carry."""

    fused_spec: FusedTickSpec
    L: float
    ldeb: float
    qdt: float           # quantum timestep, plasma units
    ratio: int           # quantum substeps per MD step
    tile: int
    device: torch.device
    rolls_fn: Optional[Callable[[int, int], torch.Tensor]]
    dtype: torch.dtype = torch.float32
    seed: Optional[torch.Tensor] = None

    def __post_init__(self):
        self.tables = fused_tables(self.fused_spec, self.device, self.dtype)
        self._tables_on = {self.tables.vecs.device: self.tables}

    def tables_on(self, device: torch.device):
        """The packed tables on ``device`` (a mesh slot's), made once."""
        if device not in self._tables_on:
            self._tables_on[device] = fused_tables(self.fused_spec, device,
                                                   self.dtype)
        return self._tables_on[device]

    def _npad(self, n: int) -> int:
        return -(-max(n, self.tile) // self.tile) * self.tile

    def soa_forces_fn(self, n: int) -> Callable:
        """``Rp [3, Np] -> F [3, Np]`` for a state of ``n`` real ions."""
        npad = self._npad(n)
        mask_row = torch.zeros((1, npad), dtype=self.dtype, device=self.device)
        mask_row[0, :n] = 1.0
        return lambda Rp: yukawa_forces_n3l_soa(Rp, mask_row, self.L,
                                                self.ldeb)

    def soa_init(self, state: SimState) -> SoACarry:
        """SimState -> zero-padded lane planes (forces from state.F)."""
        n = state.R.shape[0]
        npad = self._npad(n)
        SP = self.fused_spec.SP

        def pad_rows(x, rows):
            out = torch.zeros((rows, npad), dtype=self.dtype,
                              device=self.device)
            out[:x.shape[0], :n] = x
            return out

        psi_sm = state.psi.T
        return SoACarry(pad_rows(state.R.T, 3), pad_rows(state.V.T, 3),
                        pad_rows(state.F.T, 3),
                        pad_rows(state.t_part[None, :], 1),
                        pad_rows(psi_sm.real, SP), pad_rows(psi_sm.imag, SP),
                        state.tick, self.seed)

    def soa_restore(self, carry: SoACarry, state: SimState) -> SimState:
        """Lane planes -> SimState (shapes and dtypes from the template)."""
        n, S = state.psi.shape
        psi = torch.complex(carry.psi_re[:S, :n], carry.psi_im[:S, :n]).T
        return SimState(
            R=carry.R[:, :n].T.contiguous(), V=carry.V[:, :n].T.contiguous(),
            F=carry.F[:, :n].T.contiguous(),
            psi=psi.to(complex_dtype(state.dtype)).contiguous(),
            t_part=carry.tp[0, :n].contiguous(), tick=carry.tick,
            t=tick_time(carry.tick, self.qdt, state.dtype))

    def _tick_spec(self, n_ticks: Optional[int]) -> FusedTickSpec:
        """Spec of a (possibly partial) tick block: the sampling MD step
        is split [1 tick | sample | ratio-1 ticks]."""
        if n_ticks is None or n_ticks == self.fused_spec.ratio:
            return self.fused_spec
        return dataclasses.replace(self.fused_spec, ratio=n_ticks)

    def soa_md_step(self, carry: SoACarry, soa_forces_fn: Callable,
                    e0_lanes=None, om_lanes=None,
                    n_ticks: Optional[int] = None,
                    reuse_forces: bool = False, forces=None, rolls=None,
                    lane0: int = 0) -> SoACarry:
        """One MD step in lane layout: refresh forces (unless
        ``reuse_forces`` continues a split step with the carried ones, or
        the caller gives this step's ``forces``), then ``n_ticks``
        (default ``ratio``) fused ticks.  ``e0_lanes`` / ``om_lanes``
        (:func:`fold_sweep_lanes`) feed the per-lane variants of a sweep
        fold.  A mesh slot (parallel/ensemble.py) gives its slice of the
        fold's explicit ``rolls``, or with the in-kernel RNG the global
        lane ``lane0`` of its first lane.  A trace shows it as the span
        ``mdqt.md_step``."""
        with span("mdqt.md_step"):
            spec = self._tick_spec(n_ticks)
            npad = carry.R.shape[1]
            Fp = (carry.F if reuse_forces else
                  forces if forces is not None else soa_forces_fn(carry.R))
            if spec.internal_rng:
                if carry.seed is None:
                    raise ValueError("the in-kernel RNG needs the run's "
                                     "seed word (CoolingScheduler.seed)")
                rolls = None
            elif rolls is None:
                rolls = self.rolls_fn(spec.ratio, npad).to(self.dtype)
            R, V, tp, pre, pim = fused_md_substeps(
                spec, carry.tick == 0, carry.R, carry.V, Fp, carry.tp,
                carry.psi_re, carry.psi_im, rolls, tick0=carry.tick,
                tables=self.tables_on(carry.R.device), e0_lanes=e0_lanes,
                om_lanes=om_lanes,
                seed=carry.seed if spec.internal_rng else None,
                lane0=lane0 if spec.internal_rng else 0)
        return SoACarry(R, V, Fp, tp, pre, pim, carry.tick + spec.ratio,
                        carry.seed)

    # ---- ensemble fold: member blocks side by side on the lane axis ----

    def soa_ens_forces_fn(self, n_members: int, n: int,
                          mask=None) -> Callable:
        """``Rp [3, E*Np] -> F [3, E*Np]`` for E members of ``n`` ion
        lanes; ``mask [E, n]`` marks each member's real ions (Poissonian
        counts), else all ``n`` are real.  One member takes the unbatched
        kernel A, as the JAX package does; more take kernel C."""
        npad = self._npad(n)
        rows = n_members if mask is not None else 1
        mask_rows = torch.zeros((rows, npad), dtype=self.dtype,
                                device=self.device)
        if mask is None:
            mask_rows[:, :n] = 1.0
        else:
            mask_rows[:, :n] = torch.as_tensor(mask).to(mask_rows)
        if n_members == 1:
            return lambda Rp: yukawa_forces_n3l_soa(Rp, mask_rows[:1],
                                                    self.L, self.ldeb)
        return lambda Rp: yukawa_forces_n3l_soa_batched(
            Rp, mask_rows, n_members, self.L, self.ldeb)

    def soa_ens_init(self, states: SimState) -> SoACarry:
        """``[E, n, ...]`` states -> folded ``[rows, E*Np]`` planes
        (forces from states.F)."""
        E, n, _ = states.R.shape
        npad = self._npad(n)
        SP = self.fused_spec.SP

        dev = states.R.device        # a mesh slot's, or self.device

        def fold(x, rows=None):
            # [E, r, n] -> [rows, E*npad]; extra rows (psi S -> SP) stay 0
            rows = x.shape[1] if rows is None else rows
            out = torch.zeros((rows, E, npad), dtype=self.dtype, device=dev)
            out[:x.shape[1], :, :n] = x.transpose(0, 1)
            return out.reshape(rows, E * npad)

        psi_sm = states.psi.transpose(1, 2)              # [E, S, n]
        return SoACarry(fold(states.R.transpose(1, 2)),
                        fold(states.V.transpose(1, 2)),
                        fold(states.F.transpose(1, 2)),
                        fold(states.t_part[:, None, :]),
                        fold(psi_sm.real, SP), fold(psi_sm.imag, SP),
                        states.tick,
                        None if self.seed is None else self.seed.to(dev))

    #: one ensemble MD step: the fold is one lane axis, so this is
    #: :meth:`soa_md_step` on ``[rows, E*Np]`` planes with one
    #: ``rolls_fn(nt, E*Np)`` draw (the JAX package's default
    #: ``per_member_rolls=False``), or the in-kernel stream, whose global
    #: lane index keeps the members' streams apart under one seed word
    soa_ens_md_step = soa_md_step

    def soa_ens_restore(self, carry: SoACarry, states: SimState) -> SimState:
        """Folded planes -> ``[E, n, ...]`` states (template shapes)."""
        E, n, _ = states.R.shape
        S = states.psi.shape[-1]
        npad = carry.R.shape[1] // E

        def unfold(y, rows):          # [rows', E*npad] -> [E, n, rows]
            return y.reshape(-1, E, npad)[:rows, :, :n].permute(1, 2, 0)

        psi = torch.complex(unfold(carry.psi_re, S), unfold(carry.psi_im, S))
        return SimState(
            R=unfold(carry.R, 3).contiguous(),
            V=unfold(carry.V, 3).contiguous(),
            F=unfold(carry.F, 3).contiguous(),
            psi=psi.to(complex_dtype(states.dtype)).contiguous(),
            t_part=unfold(carry.tp, 1)[..., 0].contiguous(),
            tick=carry.tick, t=tick_time(carry.tick, self.qdt, states.dtype))

    def fused_substeps_ensemble(self, states: SimState, F,
                                e0_lanes=None, om_lanes=None) -> SimState:
        """One MD step's ticks for the whole fold with the given forces
        ``F [E, n, 3]`` (one tick launch; the per-ion update is
        independent, so members fold into the lane axis)."""
        carry = self.soa_ens_init(dataclasses.replace(states, F=F))
        carry = self.soa_ens_md_step(carry, None, e0_lanes, om_lanes,
                                     reuse_forces=True)
        return self.soa_ens_restore(carry, states)

    def md_step(self, state: SimState) -> SimState:
        """One full MD step of a SimState (forces refreshed first)."""
        carry = self.soa_md_step(self.soa_init(state),
                                 self.soa_forces_fn(state.n_ions))
        return self.soa_restore(carry, state)


# ---- free ions through the tick kernel: the three-state toy's ticks and
# the tagging pumps' windows

def to_lanes(x: torch.Tensor, rows: int, npad: int) -> torch.Tensor:
    """``[..., r, n]`` (members leading) -> ``[rows, E*npad]`` zero-padded
    lane planes, member j's block at lanes ``j*npad``, E the product of the
    leading axes."""
    r, n = x.shape[-2:]
    E = int(np.prod(x.shape[:-2], dtype=np.int64))
    out = x.new_zeros((rows, E, npad))
    out[:r, :, :n] = x.reshape(E, r, n).transpose(0, 1)
    return out.reshape(rows, E * npad)


def from_lanes(y: torch.Tensor, lead: tuple, r: int, n: int) -> torch.Tensor:
    """Rows ``:r`` and real lanes of ``[rows, E*npad]`` planes -> ``[*lead,
    r, n]`` (:func:`to_lanes` undone)."""
    E = int(np.prod(lead, dtype=np.int64))
    npad = y.shape[1] // E
    out = y.reshape(-1, E, npad)[:r, :, :n].transpose(0, 1)
    return out.reshape(tuple(lead) + (r, n))


def free_ion_spec(engine: QTEngine, ratio: int, per_lane_e0: bool = False,
                  per_lane_om: bool = False) -> FusedTickSpec:
    """The tick kernel's spec for ``engine``'s ticks of ions that feel no
    force (the three-state toy; the tagging pumps, whose engines apply no
    force: vx then stays fixed).  Every launch gives F = 0 and a dummy R:
    the leapfrog leaves v bit for bit (v + qdt * 0), R is dropped, and L = 1
    keeps it bounded.  ``per_lane_e0`` / ``per_lane_om`` select the sweep
    forms (:func:`member_sweep`; the om form scales the engine's own
    coupling, qt_fused.rabi_scaled)."""
    spec = FusedTickSpec(
        scheme=engine.scheme, h=engine.h, qdt=engine.dt_plasma,
        plas_to_quant_vel=engine.plas_to_quant_vel,
        gamma_to_einstein=engine.gamma_to_einstein, ratio=ratio, L=1.0,
        apply_force=engine.apply_force, renormalize=engine.renormalize,
        per_lane_e0=per_lane_e0)
    return rabi_scaled(spec) if per_lane_om else spec


@functools.lru_cache(maxsize=64)
def _tables(spec: FusedTickSpec, device: torch.device, dtype: torch.dtype):
    return fused_tables(spec, device, dtype)


def free_ion_ticks(spec: FusedTickSpec, vx, psi_sm, tp, rolls, e0=None,
                   om=None):
    """``T`` ticks of free ions as one launch of the tick kernel
    (qt_fused.fused_md_substeps; its plain twin on the CPU).

    ``vx [..., n]``, ``psi_sm [..., S, n]`` (state-major, complex) and ``tp
    [..., n]`` carry any leading member axes, ``rolls [T, 5, ..., n]`` the
    ticks' uniforms in their draw order; ``e0 [E, S]`` / ``om [E]`` are the
    members' sweep tables of ``spec``'s per-lane forms (:func:`member_sweep`).
    The members fold into lane blocks of ``npad`` (n rounded up to 128),
    padded lanes and rows zero.  Each tick is ``QTEngine.step_sm``'s, with
    ``spec.apply_force`` its kicks on vx.  Returns ``(vx, psi_sm, tp)``."""
    lead, n = tuple(vx.shape[:-1]), vx.shape[-1]
    S, SP = spec.S, spec.SP
    T = rolls.shape[0]
    E = int(np.prod(lead, dtype=np.int64))
    npad = -(-max(n, 1) // 128) * 128
    sp = spec if spec.ratio == T else dataclasses.replace(spec, ratio=T)
    dt, dev = vx.dtype, vx.device
    one = lambda x: to_lanes(x.unsqueeze(-2), 1, npad)
    V = torch.cat([one(vx), vx.new_zeros((2, E * npad))])
    zeros = vx.new_zeros((3, E * npad))
    rl = vx.new_zeros((T * 5, E, npad))
    rl[:, :, :n] = rolls.reshape(T * 5, E, n)
    # the om form's lanes: (om_j / om_base, 0), the DP pattern empty
    e0p, om_p = fold_sweep_lanes(
        spec, npad, e0, None if om is None else torch.stack(
            [om, torch.zeros_like(om)], -1), dev, dt)
    _, Vo, tpo, pre, pim = fused_md_substeps(
        sp, False, zeros, V, zeros, one(tp),
        to_lanes(psi_sm.real, SP, npad), to_lanes(psi_sm.imag, SP, npad),
        rl.reshape(T * 5, E * npad), tables=_tables(
            dataclasses.replace(sp, ratio=1), dev, dt),
        e0_lanes=e0p, om_lanes=om_p)
    psi = torch.complex(from_lanes(pre, lead, S, n),
                        from_lanes(pim, lead, S, n))
    return (from_lanes(Vo, lead, 1, n)[..., 0, :], psi,
            from_lanes(tpo, lead, 1, n)[..., 0, :])


def _rabi_scales(om_base: float, oms) -> np.ndarray:
    """The members' Rabi scales ``om_j / om_base`` (float64): the per_lane_om
    form of qt_fused.rabi_scaled scales the base scheme's coupling and
    Ehrenfest weights (all linear in om), so an om sweep needs ``om_base
    != 0``."""
    oms = np.asarray(oms, np.float64)
    if om_base == 0.0 and (oms != 0.0).any():
        raise ValueError("an om sweep needs a nonzero base om (the tick "
                         "kernel scales the base scheme's coupling)")
    return oms / om_base if om_base else np.ones_like(oms)


def member_sweep(base: LevelScheme, om_base: float, schemes, oms, dtype,
                 device):
    """A tagging or three-state sweep's per-member tables as the tick
    kernel's per-lane forms take them, read off the members' own schemes:
    ``(e0 [E, S] | None, om [E] | None)``, the members' diagonal energies
    (the per_lane_e0 form) unless every member has ``base``'s, and their
    Rabi scales ``om_j / om_base`` (the per_lane_om form) unless all are 1.

    The sweep varies (detuning, om) of the one laser of ``base`` (the
    engine's scheme at ``om_base``); ``schemes`` are the members' schemes
    at their own points, ``oms`` their Rabi frequencies.  Tensors of
    ``dtype`` on ``device``."""
    scale = _rabi_scales(om_base, oms)
    e0 = np.stack([s.e0 for s in schemes])
    return (None if (e0 == base.e0).all()
            else torch.as_tensor(e0, dtype=dtype, device=device),
            None if (scale == 1.0).all()
            else torch.as_tensor(scale, dtype=dtype, device=device))


def sweep_lanes(base: LevelScheme, om_base: float, params: QTParams, oms):
    """:func:`member_sweep` for a caller's ``[E]``-batched tables
    (core/qt.sweep_qt_params layout, a family's ``qt_params`` override):
    each member's e0 is taken as it is, and its coupling must be
    ``base``'s scaled by ``om_j / om_base`` (to float rounding: the kernel
    scales the base pattern), else this raises."""
    e0, C = params.e0, params.coupling
    dt, dev = e0.dtype, e0.device
    scale = torch.as_tensor(_rabi_scales(om_base, oms), dtype=dt, device=dev)
    want = scale[:, None, None] * torch.as_tensor(base.coupling.real,
                                                  dtype=dt, device=dev)
    if (float(C.imag.abs().max()) != 0.0 or not torch.allclose(
            C.real, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))):
        raise ValueError("the sweep's couplings are not the base scheme's "
                         "scaled by om / om_base, which the tick kernel's "
                         "per-lane form needs")
    same_e0 = bool((e0 == torch.as_tensor(base.e0, dtype=dt,
                                          device=dev)).all())
    return (None if same_e0 else e0,
            None if bool((scale == 1.0).all()) else scale)


def lane_major_rolls(generator: torch.Generator) -> Callable:
    """``rolls_fn`` of :class:`FrozenTagScheduler` drawing from
    ``generator`` on its device (no host sync): ``rolls_fn(ratio, lanes)
    -> [ratio, 5, *lanes]`` uniforms in [0, 1) for the ``ratio`` ticks of
    one MD step, ``lanes`` being ``(n,)`` or ``(E, n)``.  The draw is
    lane-major, ``[*lanes, ratio*5]`` transposed, as the JAX package's
    (scheduler.py:466-468 there): each ion's rolls of a step are
    neighbours in the stream."""
    def rolls_fn(ratio: int, lanes) -> torch.Tensor:
        u = torch.rand(tuple(lanes) + (ratio * 5,), generator=generator,
                       dtype=torch.float32, device=generator.device)
        return u.movedim(-1, 0).reshape((ratio, 5) + tuple(lanes))
    return rolls_fn


@dataclasses.dataclass
class FrozenTagScheduler:
    """Frozen-start tagging stepper: full-dt leapfrog MD + windowed pumping.

    The reference order per ``ratio``-tick block is [step(); ratio x
    (qstep-or-advance)] with forces recomputed inside step_V
    (randomFrozenStartTag422Linear.cpp:352-382,1015-1026).

    A state is one trajectory (``R [N, 3]``, ``psi [N, S]``) or a fold of E
    (``[E, N, 3]``, ``[E, N, S]``): every op but ``forces_fn`` is
    elementwise over the leading axes, and ``forces_fn`` (``R -> (F, pot |
    None)``, ops/yukawa.best_forces_fn or best_forces_fn_batched) is given
    for the state's shape.  ``rolls_fn(ratio, lanes)`` supplies the pump
    ticks' uniforms (:func:`lane_major_rolls` of a seeded generator) and
    is the stepper's only source of randomness, so a test can replay
    another implementation's draws through it.  ``sweep_e0 [E, S]`` /
    ``sweep_om [E]`` give a sweep's members their own detuning and Rabi
    frequency (:func:`member_sweep`).  The pump ticks go through the tick
    kernel (:func:`free_ion_ticks`, the engine's spec)."""

    engine: QTEngine
    forces_fn: Callable
    L: float
    qdt: float
    ratio: int
    t_pump_start: float
    t_pump_end: float
    rolls_fn: Optional[Callable] = None
    sweep_e0: Optional[torch.Tensor] = None
    sweep_om: Optional[torch.Tensor] = None

    def __post_init__(self):
        self.spec = free_ion_spec(self.engine, self.ratio,
                                  self.sweep_e0 is not None,
                                  self.sweep_om is not None)

    def _leapfrog(self, state: SimState):
        """step(): step_R(dt/2); forces(); step_V(dt); step_R(dt/2).  The
        first step of a run (tick 0) takes the 2nd-order first drift."""
        dt = self.qdt * self.ratio
        first = state.tick <= 0
        R = step_R(state.R, state.V, state.F, 0.5 * dt, self.L, first)
        F, _ = self.forces_fn(R)
        V = state.V + dt * F
        R = step_R(R, V, F, 0.5 * dt, self.L, first)
        return R, V, F

    def md_step_pure(self, state: SimState) -> SimState:
        """MD step whose ticks all lie OUTSIDE the pump window: the same
        leapfrog and forces, and the clock advances by ``ratio`` ticks with
        no quantum work (the reference's else-branch,
        randomFrozenStartTag422Linear.cpp:1020-1025).  The window is known
        ahead, so a run is [pure | windowed | pure]."""
        R, V, F = self._leapfrog(state)
        tick = state.tick + self.ratio
        return dataclasses.replace(state, R=R, V=V, F=F, tick=tick,
                                   t=tick_time(tick, self.qdt, state.dtype))

    def in_window(self, tick: int, dtype: torch.dtype) -> bool:
        """Whether the tick at ``tick * qdt`` pumps: strictly inside
        (t_pump_start, t_pump_end), the comparison made in ``dtype`` as
        the JAX package makes it.  Decided on the host: ``tick`` is a
        Python int."""
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        t = np_dtype(tick_time(tick, self.qdt, dtype))
        return bool(np_dtype(self.t_pump_start) < t < np_dtype(self.t_pump_end))

    def window(self, tick: int, dtype: torch.dtype):
        """``(k0, k1)``: the ticks ``tick + k`` of an MD step that pump are
        the one range ``k0 <= k < k1`` (the window is an interval and the
        tick times rise), empty when ``k0 == k1``."""
        ks = [k for k in range(self.ratio) if self.in_window(tick + k, dtype)]
        return (ks[0], ks[-1] + 1) if ks else (0, 0)

    def md_step(self, state: SimState) -> SimState:
        """MD step with the pump: the leapfrog, then ``ratio`` ticks of
        which those inside the window run the quantum update on the new
        vx (the pump applies no force, so V is the leapfrog's).  The step's
        uniforms are drawn whole; the window's ticks ``[k0, k1)`` are one
        launch of the tick kernel on their rows."""
        R, V, F = self._leapfrog(state)
        lanes = tuple(state.R.shape[:-1])
        rolls = self.rolls_fn(self.ratio, lanes).to(state.dtype)
        psi, tp = state.psi, state.t_part
        k0, k1 = self.window(state.tick, state.dtype)
        if k1 > k0:
            _, psi_sm, tp = free_ion_ticks(
                self.spec, V[..., 0], psi.transpose(-1, -2), tp,
                rolls[k0:k1], self.sweep_e0, self.sweep_om)
            psi = psi_sm.transpose(-1, -2).contiguous()
        tick = state.tick + self.ratio
        return dataclasses.replace(
            state, R=R, V=V, F=F, psi=psi, t_part=tp, tick=tick,
            t=tick_time(tick, self.qdt, state.dtype))


def tick_major_rolls(generator: torch.Generator) -> Callable:
    """``rolls_fn`` of :class:`MCTagScheduler` drawing from ``generator``
    on its device (no host sync): ``rolls_fn(ratio, lanes) -> [ratio, 5,
    *lanes]`` uniforms in [0, 1), drawn in that (tick-major) order as the
    JAX package draws them (scheduler.py:512-513 there).  A fold draws
    each member's ``(n,)`` lanes from the member's own generator
    (core/draws.MemberDraws.pump)."""
    def rolls_fn(ratio: int, lanes) -> torch.Tensor:
        return torch.rand((ratio, 5) + tuple(lanes), generator=generator,
                          dtype=torch.float32, device=generator.device)
    return rolls_fn


@dataclasses.dataclass
class MCTagScheduler:
    """MC-family pump stepper: ``ratio`` quantum ticks at the state's vx
    (the pump applies no force) as one launch of the tick kernel
    (:func:`free_ion_ticks`), then one velocity-Verlet MDStep with fresh
    accelerations (MonteCarloFollowedByQTTagging408Quad.cpp:1230-1235).
    ``t`` advances by ``dt`` (summed in the state's float type, as the JAX
    package sums it) and ``tick`` by ``ratio``.

    A state is one trajectory or a fold ``[E, N, ...]``; ``forces_fn`` (``R
    -> (F, pot | None)``, ops/yukawa.best_forces_fn or
    best_forces_fn_batched) is given for its shape.  ``rolls_fn(ratio,
    lanes)`` supplies each MD step's ``[ratio, 5, *lanes]`` uniforms
    (:func:`tick_major_rolls`) and is the stepper's only source of
    randomness; ``sweep_e0 [E, S]`` / ``sweep_om [E]`` carry a sweep's
    per-member tables (:func:`member_sweep`)."""

    engine: QTEngine
    forces_fn: Callable
    L: float
    dt: float            # MD timestep (0.005)
    ratio: int
    rolls_fn: Optional[Callable] = None
    sweep_e0: Optional[torch.Tensor] = None
    sweep_om: Optional[torch.Tensor] = None

    def __post_init__(self):
        self.spec = free_ion_spec(self.engine, self.ratio,
                                  self.sweep_e0 is not None,
                                  self.sweep_om is not None)

    def md_step(self, state: SimState) -> SimState:
        lanes = tuple(state.R.shape[:-1])
        rolls = self.rolls_fn(self.ratio, lanes).to(state.dtype)
        _, psi_sm, tp = free_ion_ticks(
            self.spec, state.V[..., 0], state.psi.transpose(-1, -2),
            state.t_part, rolls, self.sweep_e0, self.sweep_om)
        R = wrap_pbc(state.R + self.dt * state.V
                     + 0.5 * self.dt ** 2 * state.F, self.L)
        F, _ = self.forces_fn(R)
        V = state.V + 0.5 * self.dt * (state.F + F)
        np_dtype = np.float32 if state.dtype == torch.float32 else np.float64
        return dataclasses.replace(
            state, R=R, V=V, F=F, psi=psi_sm.transpose(-1, -2).contiguous(),
            t_part=tp, tick=state.tick + self.ratio,
            t=float(np_dtype(state.t) + np_dtype(self.dt)))
