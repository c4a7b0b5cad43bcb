"""Classical MD integrators: leapfrog (cooling family) and velocity-Verlet
(Monte-Carlo families) with periodic re-insertion, and the per-axis
kinetic energies.

Counterpart of ``mdqtplasmasims_tpu/core/md.py`` (leapfrog split steps:
laserCoolingPlusExpansionMDQTSpeedUp.cpp:356-430; velocity-Verlet
stepPositions/stepVelocities/MDStep:
MonteCarloFollowedByMDAndTempAnisotropy.cpp:452-511).  Layout-agnostic:
the integrators are elementwise, so they take ``[N, 3]``, ``[E, N, 3]``
or ``[3, N]`` alike.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.member_sum import ion_mean, ion_sum


def wrap_pbc(R: torch.Tensor, L: float) -> torch.Tensor:
    """Pac-man re-insertion after a drift (laserCooling...SpeedUp.cpp:381-389).

    A single +-L shift, not a modulo, as in the reference: a particle
    leaves the cell by less than L per drift."""
    R = torch.where(R < 0, R + L, R)
    return torch.where(R > L, R - L, R)


def step_R(R, V, F, dt_half: float, L: float, first_step: bool):
    """Half drift.  On the very first step (t == 0) the reference uses the
    2nd-order form R += dt*V + dt^2*F (laserCooling...SpeedUp.cpp:370-378)."""
    drift = dt_half * V
    if first_step:
        drift = drift + (dt_half * dt_half) * F
    return wrap_pbc(R + drift, L)


def leapfrog_substep(R, V, F, dt: float, L: float, first_step: bool = False):
    """One kick-drift-kick leapfrog step with *fixed* forces F (forces are
    refreshed once per full MD step, laserCooling...SpeedUp.cpp:418-430)."""
    R = step_R(R, V, F, 0.5 * dt, L, first_step)
    V = V + dt * F
    R = step_R(R, V, F, 0.5 * dt, L, first_step)
    return R, V


def velocity_verlet_step(R, V, A, dt: float, L: float, forces_fn: Callable):
    """MDStep of the MC family (MonteCarlo...TempAnisotropy.cpp:504-511):
    R += dt*V + dt^2/2*A; wrap; A' = forces(R); V += dt/2*(A + A')."""
    R = wrap_pbc(R + dt * V + 0.5 * dt * dt * A, L)
    A_new = forces_fn(R)
    V = V + 0.5 * dt * (A + A_new)
    return R, V, A_new


def kinetic_energies(V: torch.Tensor, subtract_mean_vx: bool = False,
                     mask: Optional[torch.Tensor] = None):
    """Per-axis mean kinetic energies of ``V [N, 3]`` (output():930-947),
    or of a fold's members at once from ``V [N, E, 3]``, the ions first
    (``states.V.transpose(0, 1)``), with ``mask [N]`` / ``[N, E]`` marking
    real ions.  In the expansion frame the x-axis subtracts the
    ensemble-mean vx.  Returns ``(ekx, eky, ekz, vx_mean)``, 0-d tensors
    for one state and ``[E]`` for a fold.  Each member's sums run over its
    own row of ions (:func:`ion_sum`): a member's bits are those of its
    lone call."""
    V = V.movedim(0, -2)                   # [..., N, 3]: a member a row
    if mask is None:
        vx_mean = ion_mean(V[..., 0], dim=-1)
        Vx = V[..., 0] - vx_mean[..., None] if subtract_mean_vx \
            else V[..., 0]
        ek = [ion_mean(0.5 * Vx ** 2, dim=-1),
              ion_mean(0.5 * V[..., 1] ** 2, dim=-1),
              ion_mean(0.5 * V[..., 2] ** 2, dim=-1)]
    else:
        mask = mask.movedim(0, -1)
        n_eff = torch.sum(mask, dim=-1)
        vx_mean = ion_sum(V[..., 0], dim=-1, mask=mask) / n_eff
        Vx = V[..., 0] - vx_mean[..., None] if subtract_mean_vx \
            else V[..., 0]
        ek = [ion_sum(0.5 * Vx ** 2, dim=-1, mask=mask) / n_eff,
              ion_sum(0.5 * V[..., 1] ** 2, dim=-1, mask=mask) / n_eff,
              ion_sum(0.5 * V[..., 2] ** 2, dim=-1, mask=mask) / n_eff]
    return ek[0], ek[1], ek[2], vx_mean
