"""SpeedUp multirate scheduler of the cooling family: forces once per MD
step, drift/kick and the quantum update at the quantum substep
(laserCoolingPlusExpansionMDQTSpeedUp.cpp:1365-1378).

Counterpart of ``mdqtplasmasims_tpu/core/scheduler.py:40-365``.  The port
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
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..state import SimState, complex_dtype, tick_time
from ..ops.yukawa import yukawa_forces_n3l_soa, yukawa_forces_n3l_soa_batched
from .qt_fused import FusedTickSpec, fused_md_substeps, fused_tables

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
                     sweep_om=None, device=None):
    """Per-member sweep tables in the kernels' lane layout, the one source
    of the fold's E-major lane order: ``sweep_e0 [E, S]`` member diagonal
    energies -> ``[SP, E*npad]``; ``sweep_om [E, 2]`` member (om, om_dp)
    -> ``[2, E*npad]``.  Float32 on ``device``; each is None when its
    input is."""
    e0p = omp = None
    if sweep_e0 is not None:
        e0 = torch.as_tensor(np.asarray(sweep_e0, np.float32))
        E, S = e0.shape
        e0p = torch.zeros((fused_spec.SP, E, npad), dtype=torch.float32)
        e0p[:S] = e0.T[:, :, None]
        e0p = e0p.reshape(fused_spec.SP, E * npad).to(device)
    if sweep_om is not None:
        om = torch.as_tensor(np.asarray(sweep_om, np.float32))
        omp = om.T[:, :, None].expand(2, om.shape[0], npad)
        omp = omp.reshape(2, -1).contiguous().to(device)
    return e0p, omp


def draw_seed_word(generator: torch.Generator) -> torch.Tensor:
    """The run's seed word of the in-kernel stream: one 31-bit draw from
    ``generator``, kept as a ``[1]`` int32 tensor on its device (no host
    sync)."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def uniform_rolls(generator: torch.Generator) -> Callable:
    """``rolls_fn`` drawing ``[n_ticks*5, npad]`` uniforms in [0, 1) from
    ``generator`` on its device (no host sync)."""
    def rolls_fn(n_ticks: int, npad: int) -> torch.Tensor:
        return torch.rand((n_ticks * 5, npad), generator=generator,
                          dtype=torch.float32, device=generator.device)
    return rolls_fn


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
        lane ``lane0`` of its first lane."""
        spec = self._tick_spec(n_ticks)
        npad = carry.R.shape[1]
        Fp = (carry.F if reuse_forces else
              forces if forces is not None else soa_forces_fn(carry.R))
        if spec.internal_rng:
            if carry.seed is None:
                raise ValueError("the in-kernel RNG needs the run's seed "
                                 "word (CoolingScheduler.seed)")
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
