"""Quantum-trajectory engine: vectorized non-Hermitian RK4 + stochastic jumps.

Counterpart of ``mdqtplasmasims_tpu/core/qt.py`` in plain torch (complex64
or complex128).  Per ion and tick (SURVEY.md L4):

1. jump probability ``dp = h * sum_s w_s |psi_s|^2`` (diagonal decay);
2. no jump: an RK step of the renormalized non-Hermitian propagator
   ``G(phi) = (1-dp(phi))^(-1/2) (I - i h H) phi`` with H frozen over the
   tick, plus the Ehrenfest optical kick;
3. jump: emitting sublevel by population, S-vs-D branch, destination from
   the C-G-weighted table, clock reset, +-recoil along x.

Wavefunctions ride state-major (``[S, N]``) as in the JAX package.  Every
family runs the same tick inside the fused kernel
(:mod:`mdqtplasmasims_torch.core.qt_fused`; the tagging pumps and the
three-state toy through core/scheduler.free_ion_ticks), where the JAX
package steps the latter two through its engine; this engine is the
reference the tests hold those ticks to, a whole fold at a time
(``[E, S, N]``, with per-member tables from :func:`sweep_qt_params`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..levels import LevelScheme


class QTParams(NamedTuple):
    """Tensors derived from a LevelScheme."""
    decay_w: torch.Tensor      # [S]
    e0: torch.Tensor           # [S]
    e1: torch.Tensor           # [S]
    coupling: torch.Tensor     # [S,S] complex
    jump_src_mask: torch.Tensor   # [S]
    jump_dest_cum: torch.Tensor   # [2,S,S]: cumulative dest probs per (branch,src)


def _params(scheme: LevelScheme, rdtype, cdtype, device) -> QTParams:
    src_mask = np.zeros(scheme.n_states)
    src_mask[list(scheme.jump_src)] = 1.0
    dest_cum = np.cumsum(scheme.jump_dest, axis=-1)   # [S,2,S]

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    return QTParams(
        decay_w=t(scheme.decay_w, rdtype), e0=t(scheme.e0, rdtype),
        e1=t(scheme.e1, rdtype), coupling=t(scheme.coupling, cdtype),
        jump_src_mask=t(src_mask, rdtype),
        jump_dest_cum=t(dest_cum.transpose(1, 0, 2), rdtype))


@functools.lru_cache(maxsize=64)
def scheme_params(scheme: LevelScheme, rdtype, cdtype, device) -> QTParams:
    """:class:`QTParams` of ``scheme`` on ``device``, made once per (scheme,
    dtypes, device) and never written to: a tick that is given no
    ``params`` reads these, without a host-to-device copy of its own."""
    return _params(scheme, rdtype, cdtype, device)


def _categorical_sm(u: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """Index of the first cumulative bin exceeding u.  u: [..., N], cum:
    [..., S, N]."""
    return torch.sum((u[..., None, :] >= cum).to(torch.int64), dim=-2)


def sweep_qt_params(scheme_unit: LevelScheme, detuning, om, rdtype, cdtype,
                    device) -> QTParams:
    """QTParams for ``(detuning, om)`` given as numbers or as ``[E]``
    arrays: the tagging and toy sweep fold.

    The tagging and toy Hamiltonians are linear in both knobs with zero
    intercept: ``e0 = detuning * e0_unit`` (excited rows are -detuning,
    levels.py tag408/tag422/three_state) and ``coupling = om * C_unit``
    (every drive coefficient carries -om/2).  So one QTParams built from
    the unit scheme (``detuning=1, om=1``) serves any sweep point by two
    multiplies, and with ``[E]`` arrays ``e0`` comes out ``[E, S]`` and
    ``coupling`` ``[E, S, S]``: the member axis :meth:`QTEngine.step_sm`
    broadcasts over.  Jump tables and decay rates do not depend on either
    knob and stay unbatched.  Not valid for sr12_cooling (two detunings
    live on shared rows; laser_cooling.run_sweep covers it)."""
    base = _params(scheme_unit, rdtype, cdtype, device)
    det = torch.as_tensor(np.asarray(detuning), dtype=rdtype, device=device)
    om = torch.as_tensor(np.asarray(om), dtype=rdtype, device=device)
    om = om[..., None, None]
    return base._replace(
        e0=det[..., None] * base.e0,
        coupling=torch.complex(om * base.coupling.real,
                               om * base.coupling.imag))


def sweep_member_cfgs(cfg, points, jobs_per_point: int) -> list:
    """Validate a sweep grid and build its point-major member configs.

    ``points`` are dicts with keys among ``detuning``/``om`` (unset
    fields keep ``cfg``'s value); only these knobs can vary inside one
    fold.  ``jobs_per_point`` replicates each point with independent
    seeds (member order is point-major, job numbers restart at 1 per
    point)."""
    allowed = {"detuning", "om"}
    member_cfgs = []
    for pt in points:
        ov = dict(pt)
        bad = set(ov) - allowed
        if bad:
            raise ValueError(f"sweep points can only override "
                             f"{sorted(allowed)}, got {sorted(bad)}")
        for r in range(jobs_per_point):
            member_cfgs.append(dataclasses.replace(cfg, job=r + 1, **ov))
    return member_cfgs


def sweep_member_params(cfg, points, jobs_per_point: int,
                        scheme_unit: LevelScheme, rdtype, cdtype, device):
    """:func:`sweep_member_cfgs` and the members' :func:`sweep_qt_params`
    (the JAX package's front half of every family's ``run_sweep``).
    Returns ``(member_cfgs, params)`` with ``params`` an ``[E]``-batched
    :class:`QTParams`."""
    member_cfgs = sweep_member_cfgs(cfg, points, jobs_per_point)
    params = sweep_qt_params(scheme_unit,
                             [m.detuning for m in member_cfgs],
                             [m.om for m in member_cfgs], rdtype, cdtype,
                             device)
    return member_cfgs, params


@dataclasses.dataclass(frozen=True)
class QTEngine:
    """Quantum-trajectory stepper for one level scheme.

    Every method takes the ion axis last and the state axis before it,
    with any number of leading batch axes: a fold of E members steps as
    ``psi [E, S, N]``, ``vx``/``t_part [E, N]`` and ``rolls [5, E, N]`` in
    one set of ops.  The arithmetic is written out on real and imaginary
    parts, each op elementwise or a short fixed-order sum over the state
    axis, so a member of a fold comes out bit for bit as it does alone: a
    matrix product's blocking depends on the shape (and on a card on the
    TF32 setting), and a vectorized complex multiply rounds an element by
    its place in the buffer.

    Args:
      scheme: level-scheme tables.
      h: quantum timestep in gamma-time units.
      dt_plasma: quantum timestep in plasma units (increment of ``t_part``).
      plas_to_quant_vel: velocity conversion a*omega_E -> gamma/k.
      gamma_to_einstein: clock conversion for the time-dependent phase.
      apply_force: whether kicks (Ehrenfest + recoil) modify vx.
      renormalize: explicit norm division after each tick
         (laserCoolingPlusExpansionMDQTSpeedUp.cpp:706-712).
    """

    scheme: LevelScheme
    h: float
    dt_plasma: float
    plas_to_quant_vel: float = 1.0
    gamma_to_einstein: float = 1.0
    apply_force: bool = True
    renormalize: bool = False

    @staticmethod
    def _hamiltonian(p: QTParams, u):
        """The tick's frozen Hamiltonian as real tensors: the diagonal's
        real part ``e0 + e1 u`` [..., S, N] and imaginary part ``-w/2``
        [S, 1], and the coupling's two parts [..., S, S, 1].  ``p.e0 [S]``
        and ``p.coupling [S, S]`` may carry the leading member axis."""
        return (p.e0[..., :, None] + p.e1[:, None] * u[..., None, :],
                -0.5 * p.decay_w[:, None],
                p.coupling.real[..., :, :, None],
                p.coupling.imag[..., :, :, None])

    def _hpsi_sm(self, ham, pr, pi, phase):
        """H @ phi as ``(re, im)`` for ``ham`` of :meth:`_hamiltonian` and
        phi = pr + i pi: [..., S, N]; ``phase`` [..., N] is the beat-note
        factor of the tick (None without tdep rows)."""
        dr, di, cr, ci = ham
        br, bi = pr[..., None, :, :], pi[..., None, :, :]
        hr = dr * pr - di * pi + torch.sum(cr * br - ci * bi, dim=-2)
        hi = dr * pi + di * pr + torch.sum(cr * bi + ci * br, dim=-2)
        if self.scheme.tdep_rows:
            hr, hi = hr.clone(), hi.clone()
            for r, c, m in zip(self.scheme.tdep_rows, self.scheme.tdep_cols,
                               self.scheme.tdep_coefs):
                m = complex(m)
                # f = m * phase; row r += f phi[c], row c += conj(f) phi[r]
                fr = m.real * phase.real - m.imag * phase.imag
                fi = m.real * phase.imag + m.imag * phase.real
                hr[..., r, :] += fr * pr[..., c, :] - fi * pi[..., c, :]
                hi[..., r, :] += fr * pi[..., c, :] + fi * pr[..., c, :]
                hr[..., c, :] += fr * pr[..., r, :] + fi * pi[..., r, :]
                hi[..., c, :] += fr * pi[..., r, :] - fi * pr[..., r, :]
        return hr, hi

    def _tdep_phase(self, u, tq):
        if not self.scheme.tdep_rows:
            return None
        ang = self.scheme.tdep_freq * u * tq
        return torch.polar(torch.ones_like(ang), ang)

    def _dp_sm(self, p: QTParams, pr, pi):
        return self.h * torch.sum(
            p.decay_w[:, None] * (pr ** 2 + pi ** 2), dim=-2)

    def step_sm(self, psi: torch.Tensor, vx: torch.Tensor,
                t_part: torch.Tensor, rolls: Optional[torch.Tensor] = None,
                exp_det: float = 0.0,
                generator: Optional[torch.Generator] = None,
                params: Optional[QTParams] = None, force_scale=None):
        """Advance every ion one quantum tick.  psi: [..., S, N]
        (state-major), vx and t_part: [..., N].

        Returns ``(psi, vx, t_part)``.  ``exp_det`` is the expansion-frame
        detuning (units of gamma) added to the Doppler shift.  Exactly one
        of ``rolls`` (the [5, ..., N] uniforms in [0, 1)) and ``generator``
        must be given.

        ``params`` overrides the scheme-derived :class:`QTParams` (a sweep
        member's own detuning and Rabi frequency: ``e0`` and ``coupling``
        scaled from a unit scheme, :func:`sweep_qt_params`; with a leading
        ``[E]`` axis on those two, one set per member of the fold);
        ``force_scale`` scales the Ehrenfest kick by a scalar or a tensor
        that broadcasts against ``vx`` (a toy scheme's ``force_w`` is
        linear in om, so an om sweep passes om/om_base).  Jump recoils are
        a fixed photon momentum and are never scaled."""
        if (rolls is None) == (generator is None):
            raise ValueError("step_sm needs exactly one of rolls= or "
                             "generator=")
        rdtype = vx.dtype
        p = (scheme_params(self.scheme, rdtype, psi.dtype, psi.device)
             if params is None else params)
        h = self.h
        S = psi.shape[-2]
        pr, pi = psi.real, psi.imag

        t_part = t_part + self.dt_plasma
        u = vx * self.plas_to_quant_vel + exp_det
        tq = t_part * self.gamma_to_einstein
        if rolls is None:
            rolls = torch.rand((5,) + tuple(vx.shape), generator=generator,
                               dtype=rdtype, device=psi.device)
        pop = pr ** 2 + pi ** 2
        dp0 = h * torch.sum(p.decay_w[:, None] * pop, dim=-2)
        # strict <: dp=0 never jumps, even on a zero draw
        jumped = rolls[0] < dp0

        # ---- no-jump branch: RK (3/8 weights) on the normalized
        # propagator; the stage dp is clamped below 1 (see the JAX engine)
        phase = self._tdep_phase(u, tq)
        ham = self._hamiltonian(p, u)

        def g_slope(ar, ai):
            dphi = torch.clamp(self._dp_sm(p, ar, ai), 0.0, 0.9)
            pref = torch.rsqrt(1.0 - dphi)[..., None, :]
            hr, hi = self._hpsi_sm(ham, ar, ai, phase)
            # stepped = pref * (phi - i h H phi)
            return ((pref * (ar + h * hi) - ar) / h,
                    (pref * (ai - h * hr) - ai) / h)

        k1r, k1i = g_slope(pr, pi)
        k2r, k2i = g_slope(pr + 0.5 * h * k1r, pi + 0.5 * h * k1i)
        k3r, k3i = g_slope(pr + 0.5 * h * k2r, pi + 0.5 * h * k2i)
        k4r, k4i = g_slope(pr + h * k3r, pi + h * k3i)
        ev_r = pr + (k1r + 3 * k2r + 3 * k3r + k4r) * (h / 8.0)
        ev_i = pi + (k1i + 3 * k2i + 3 * k3i + k4i) * (h / 8.0)

        # Ehrenfest optical force from the *initial* wavefunction
        # (laserCoolingPlusExpansionMDQTSpeedUp.cpp:490-503)
        kick_nojump = torch.zeros_like(vx)
        for a, b, w in zip(self.scheme.force_a, self.scheme.force_b,
                           self.scheme.force_w):
            # Im(psi_a conj(psi_b))
            kick_nojump = kick_nojump + w * (
                pi[..., a, :] * pr[..., b, :] - pr[..., a, :] * pi[..., b, :])
        kick_nojump = kick_nojump * h
        if force_scale is not None:
            kick_nojump = kick_nojump * force_scale

        # ---- jump branch: collapse ----
        src_cum = torch.cumsum(pop * p.jump_src_mask[:, None], dim=-2)
        tot = torch.clamp(src_cum[..., -1, :], min=1e-30)
        src = torch.clamp(_categorical_sm(rolls[1] * tot, src_cum), max=S - 1)
        d_branch = rolls[2] < self.scheme.branch_d_prob
        dest_cum = torch.where(d_branch[..., None, :],
                               p.jump_dest_cum[1][src].transpose(-1, -2),
                               p.jump_dest_cum[0][src].transpose(-1, -2))
        dest = torch.clamp(_categorical_sm(rolls[4], dest_cum), max=S - 1)
        states = torch.arange(S, device=psi.device)[:, None]
        jumped_to = (states == dest[..., None, :]).to(rdtype)

        sign = torch.where(rolls[3] < 0.5, 1.0, -1.0).to(rdtype)
        kick_jump = sign * torch.where(
            d_branch, torch.full_like(vx, self.scheme.kick_d),
            torch.full_like(vx, self.scheme.kick_s))
        if not self.scheme.apply_recoil:
            kick_jump = torch.zeros_like(kick_jump)

        # ---- merge ----
        new_r = torch.where(jumped[..., None, :], jumped_to, ev_r)
        new_i = torch.where(jumped[..., None, :], torch.zeros_like(ev_i),
                            ev_i)
        t_part = torch.where(jumped, torch.zeros_like(t_part), t_part)
        if self.apply_force and self.scheme.has_force:
            vx = vx + torch.where(jumped, kick_jump, kick_nojump)
        if self.renormalize:
            norm = torch.sqrt(torch.sum(new_r ** 2 + new_i ** 2, dim=-2,
                                        keepdim=True))
            # padded lanes carry psi == 0 and must stay exactly zero
            norm = torch.where(norm > 0, norm, torch.ones_like(norm))
            new_r, new_i = new_r / norm, new_i / norm
        return torch.complex(new_r, new_i), vx, t_part

    def step(self, psi, vx, t_part, rolls=None, exp_det: float = 0.0,
             generator: Optional[torch.Generator] = None, params=None,
             force_scale=None):
        """[..., N, S]-layout wrapper around :meth:`step_sm`."""
        psi_sm, vx, t_part = self.step_sm(psi.transpose(-1, -2), vx, t_part,
                                          rolls, exp_det, generator, params,
                                          force_scale)
        return psi_sm.transpose(-1, -2), vx, t_part


def random_s_superposition(generator: torch.Generator, n: int, n_states: int,
                           dtype=torch.complex64) -> torch.Tensor:
    """Random superposition of the two S sublevels
    (laserCoolingPlusExpansionMDQTSpeedUp.cpp:317-332):
    ``psi = sqrt(r1)|1> + (s2*sqrt((1-r1) r2) + i s1*sqrt((1-r1)(1-r2)))|2>``.
    Drawn on the generator's device."""
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64
    r1, r2, s1, s2 = torch.rand((4, n), generator=generator, dtype=rdtype,
                                device=generator.device)
    sign1 = torch.where(s1 < 0.5, -1.0, 1.0).to(rdtype)
    sign2 = torch.where(s2 < 0.5, -1.0, 1.0).to(rdtype)
    psi = torch.zeros((n, n_states), dtype=dtype, device=generator.device)
    psi[:, 0] = torch.sqrt(r1)
    psi[:, 1] = torch.complex(sign2 * torch.sqrt((1 - r1) * r2),
                              sign1 * torch.sqrt((1 - r1) * (1 - r2)))
    return psi


def state_populations(psi: torch.Tensor, manifolds) -> list:
    """Total population per manifold, e.g. S/P/D
    (laserCoolingPlusExpansionMDQTSpeedUp.cpp:1019-1021).
    ``manifolds`` is a list of index tuples; psi is ``[..., S]`` (one
    state's ``[N, S]``, a fold's ``[E, N, S]``).

    Each manifold's sum is elementwise adds of its levels' slices, in the
    order torch's CPU sum takes over a row shorter than a vector register:
    four partial sums (levels 0, 4, 8, ... of the manifold into the first,
    1, 5, ... into the second, and so on), the levels past the last whole
    four onto the first, then the four in turn.  So a float32 CPU result
    has the bits of ``torch.sum(pop[..., idx], -1)``; on a card no index
    is copied to the device (no host wait), and a member's bits do not
    depend on the fold's width, as a CUDA reduction's would."""
    pop = psi.real ** 2 + psi.imag ** 2
    return [_level_sum(pop, tuple(idx)) for idx in manifolds]


def _level_sum(pop: torch.Tensor, idx: tuple) -> torch.Tensor:
    """``pop[..., idx]`` summed over the levels in
    :func:`state_populations`' order."""
    whole = len(idx) // 4 * 4
    if not whole:
        acc = pop[..., idx[0]]
        for i in idx[1:]:
            acc = acc + pop[..., i]
        return acc
    part = [pop[..., i] for i in idx[:4]]
    for r in range(4, whole, 4):
        part = [p + pop[..., i] for p, i in zip(part, idx[r:r + 4])]
    acc = part[0]
    for i in idx[whole:]:
        acc = acc + pop[..., i]
    for p in part[1:]:
        acc = acc + p
    return acc
