"""Quantum-trajectory engine: vectorized non-Hermitian RK4 + stochastic jumps.

Counterpart of ``mdqtplasmasims_tpu/core/qt.py`` in plain torch (complex64
or complex128).  Per ion and tick (SURVEY.md L4):

1. jump probability ``dp = h * sum_s w_s |psi_s|^2`` (diagonal decay);
2. no jump: an RK step of the renormalized non-Hermitian propagator
   ``G(phi) = (1-dp(phi))^(-1/2) (I - i h H) phi`` with H frozen over the
   tick, plus the Ehrenfest optical kick;
3. jump: emitting sublevel by population, S-vs-D branch, destination from
   the C-G-weighted table, clock reset, +-recoil along x.

Wavefunctions ride state-major (``[S, N]``) as in the JAX package; the
main path runs the same tick inside the fused kernel
(:mod:`mdqtplasmasims_torch.core.qt_fused`), and this engine is the
unfused reference the tests hold against the JAX engine.
"""

from __future__ import annotations

import dataclasses
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


def _categorical_sm(u: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """Index of the first cumulative bin exceeding u.  u: [N], cum: [S,N]."""
    return torch.sum((u[None, :] >= cum).to(torch.int64), dim=0)


@dataclasses.dataclass(frozen=True)
class QTEngine:
    """Quantum-trajectory stepper for one level scheme.

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

    def _hpsi_sm(self, p: QTParams, phi, u, phase):
        """H(u, t_gamma) @ phi.  phi: [S,N], u: [N]; ``phase`` [N] is the
        beat-note factor of the tick (None without tdep rows)."""
        diag = (p.e0[:, None] + p.e1[:, None] * u[None, :]
                - 0.5j * p.decay_w[:, None])
        out = diag * phi + p.coupling @ phi
        if self.scheme.tdep_rows:
            out = out.clone()
            for r, c, m in zip(self.scheme.tdep_rows, self.scheme.tdep_cols,
                               self.scheme.tdep_coefs):
                out[r] = out[r] + m * phase * phi[c]
                out[c] = out[c] + (complex(m).conjugate() * torch.conj(phase)
                                     * phi[r])
        return out

    def _tdep_phase(self, u, tq):
        if not self.scheme.tdep_rows:
            return None
        ang = self.scheme.tdep_freq * u * tq
        return torch.polar(torch.ones_like(ang), ang)

    def _dp_sm(self, p: QTParams, phi):
        return self.h * torch.sum(
            p.decay_w[:, None] * (phi.real ** 2 + phi.imag ** 2), dim=0)

    def step_sm(self, psi: torch.Tensor, vx: torch.Tensor,
                t_part: torch.Tensor, rolls: Optional[torch.Tensor] = None,
                exp_det: float = 0.0,
                generator: Optional[torch.Generator] = None,
                params: Optional[QTParams] = None, force_scale=None):
        """Advance every ion one quantum tick.  psi: [S,N] (state-major).

        Returns ``(psi, vx, t_part)``.  ``exp_det`` is the expansion-frame
        detuning (units of gamma) added to the Doppler shift.  Exactly one
        of ``rolls`` (the [5, N] uniforms in [0, 1)) and ``generator`` must
        be given.

        ``params`` overrides the scheme-derived :class:`QTParams` (a sweep
        member's own detuning and Rabi frequency: ``e0`` and ``coupling``
        scaled from a unit scheme); ``force_scale`` scales the Ehrenfest
        kick by a scalar (a toy scheme's ``force_w`` is linear in om, so an
        om sweep passes om/om_base).  Jump recoils are a fixed photon
        momentum and are never scaled."""
        if (rolls is None) == (generator is None):
            raise ValueError("step_sm needs exactly one of rolls= or "
                             "generator=")
        rdtype = vx.dtype
        p = (_params(self.scheme, rdtype, psi.dtype, psi.device)
             if params is None else params)
        h = self.h
        S, n = psi.shape

        t_part = t_part + self.dt_plasma
        u = vx * self.plas_to_quant_vel + exp_det
        tq = t_part * self.gamma_to_einstein
        if rolls is None:
            rolls = torch.rand((5, n), generator=generator, dtype=rdtype,
                               device=psi.device)
        dp0 = self._dp_sm(p, psi)
        # strict <: dp=0 never jumps, even on a zero draw
        jumped = rolls[0] < dp0

        # ---- no-jump branch: RK (3/8 weights) on the normalized
        # propagator; the stage dp is clamped below 1 (see the JAX engine)
        phase = self._tdep_phase(u, tq)

        def g_slope(phi):
            dphi = torch.clamp(self._dp_sm(p, phi), 0.0, 0.9)
            pref = torch.rsqrt(1.0 - dphi)[None, :]
            stepped = pref * (phi - 1j * h * self._hpsi_sm(p, phi, u, phase))
            return (stepped - phi) / h

        k1 = g_slope(psi)
        k2 = g_slope(psi + 0.5 * h * k1)
        k3 = g_slope(psi + 0.5 * h * k2)
        k4 = g_slope(psi + h * k3)
        psi_evolved = psi + (k1 + 3 * k2 + 3 * k3 + k4) * (h / 8.0)

        # Ehrenfest optical force from the *initial* wavefunction
        # (laserCoolingPlusExpansionMDQTSpeedUp.cpp:490-503)
        kick_nojump = torch.zeros(n, dtype=rdtype, device=psi.device)
        for a, b, w in zip(self.scheme.force_a, self.scheme.force_b,
                           self.scheme.force_w):
            kick_nojump = kick_nojump + w * torch.imag(
                psi[a] * torch.conj(psi[b]))
        kick_nojump = kick_nojump * h
        if force_scale is not None:
            kick_nojump = kick_nojump * force_scale

        # ---- jump branch: collapse ----
        pop = psi.real ** 2 + psi.imag ** 2
        src_cum = torch.cumsum(pop * p.jump_src_mask[:, None], dim=0)
        tot = torch.clamp(src_cum[-1], min=1e-30)
        src = torch.clamp(_categorical_sm(rolls[1] * tot, src_cum), max=S - 1)
        d_branch = rolls[2] < self.scheme.branch_d_prob
        dest_cum = torch.where(d_branch[None, :],
                               p.jump_dest_cum[1][src].T,
                               p.jump_dest_cum[0][src].T)
        dest = torch.clamp(_categorical_sm(rolls[4], dest_cum), max=S - 1)
        states = torch.arange(S, device=psi.device)[:, None]
        psi_jumped = (states == dest[None, :]).to(psi.dtype)

        sign = torch.where(rolls[3] < 0.5, 1.0, -1.0).to(rdtype)
        kick_jump = sign * torch.where(
            d_branch, torch.full_like(vx, self.scheme.kick_d),
            torch.full_like(vx, self.scheme.kick_s))
        if not self.scheme.apply_recoil:
            kick_jump = torch.zeros_like(kick_jump)

        # ---- merge ----
        psi_new = torch.where(jumped[None, :], psi_jumped, psi_evolved)
        t_part = torch.where(jumped, torch.zeros_like(t_part), t_part)
        if self.apply_force and self.scheme.has_force:
            vx = vx + torch.where(jumped, kick_jump, kick_nojump)
        if self.renormalize:
            norm = torch.sqrt(torch.sum(psi_new.real ** 2 + psi_new.imag ** 2,
                                        dim=0, keepdim=True))
            # padded lanes carry psi == 0 and must stay exactly zero
            norm = torch.where(norm > 0, norm, torch.ones_like(norm))
            psi_new = psi_new / norm
        return psi_new, vx, t_part

    def step(self, psi, vx, t_part, rolls=None, exp_det: float = 0.0,
             generator: Optional[torch.Generator] = None, params=None,
             force_scale=None):
        """[N,S]-layout wrapper around :meth:`step_sm`."""
        psi_sm, vx, t_part = self.step_sm(psi.T, vx, t_part, rolls, exp_det,
                                          generator, params, force_scale)
        return psi_sm.T, vx, t_part


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
    ``manifolds`` is a list of index tuples; psi is [N,S]."""
    pop = psi.real ** 2 + psi.imag ** 2
    return [torch.sum(pop[:, list(idx)], dim=-1) for idx in manifolds]
